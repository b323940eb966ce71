"""The multi-process ``make_sharded_train_step`` with two real processes
over ``gloo`` on localhost (the port's tests/test_distributed_multiproc.py
and tests/dcn_child.py).

Each child is this file run as a script: it joins the process group from
the JAX package's environment variables, builds the same seeded state,
feeds its own four rows of the same global batch of eight on its mesh of
``["cpu"] * 2`` and takes two steps with boundary weights (the first step's
learning rate is 0, the second moves the parameters), then takes its
studies by ``shard_studies``.  The two ranks must report the same losses,
those of the one-process step over ``["cpu"] * 4`` on the whole batch, and
the same parameters after the steps.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 240
STEPS = 2
BOOST = 3.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _setup():
    """(cfg, optimizer, state, global batch): the same in every process."""
    from unetseg_tpu_torch import train
    from unetseg_tpu_torch.config import ModelConfig

    cfg = ModelConfig(base_channels=4, depth=2, image_size=32,
                      compute_dtype="float32")
    tx = train.make_optimizer(lr=1e-2, total_steps=10)
    state = train.init_state(0, cfg, tx, "cpu")
    rng = np.random.default_rng(0)
    imgs = rng.random((8, 32, 32, 1)).astype(np.float32)
    labels = (rng.random((8, 32, 32)) > 0.5).astype(np.int32) * 2
    return cfg, tx, state, (imgs, labels)


def _run(state, step, batch):
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return state, losses


def child(port, rank, world, out_dir):
    import torch.distributed as dist

    from unetseg_tpu_torch import train
    from unetseg_tpu_torch.parallel import distributed

    os.environ.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      JAX_NUM_PROCESSES=str(world),
                      JAX_PROCESS_ID=str(rank))
    assert distributed.initialize_distributed(device="cpu")
    cfg, tx, state, (imgs, labels) = _setup()
    mesh = distributed.global_mesh(devices=["cpu"] * 2)
    rows = slice(rank * 4, (rank + 1) * 4)  # this process's rows
    step = train.make_sharded_train_step(cfg, mesh, tx,
                                         boundary_boost=BOOST)
    state, losses = _run(state, step, (imgs[rows], labels[rows]))
    np.savez(os.path.join(out_dir, f"params{rank}.npz"),
             **{k: v.numpy() for k, v in state.params.items()})
    studies = distributed.shard_studies([f"study_{i}" for i in range(5)])
    with open(os.path.join(out_dir, f"proc{rank}.json"), "w") as f:
        json.dump({"rank": distributed.process_index(),
                   "world": distributed.process_count(),
                   "mesh": mesh.shape, "losses": losses,
                   "studies": studies}, f)
    dist.destroy_process_group()


def test_two_process_train_step(tmp_path):
    import torch

    from unetseg_tpu_torch import train
    from unetseg_tpu_torch.parallel import mesh as pmesh

    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX_")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(rank),
         "2", str(tmp_path)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"child failed:\n{out}"

    res = [json.load(open(tmp_path / f"proc{r}.json")) for r in (0, 1)]
    assert [(r["rank"], r["world"]) for r in res] == [(0, 2), (1, 2)]
    assert res[0]["mesh"] == {"dp": 2, "sp": 1}
    # the global loss on both ranks
    np.testing.assert_allclose(res[1]["losses"], res[0]["losses"], rtol=1e-6)

    cfg, tx, start, batch = _setup()
    step = train.make_sharded_train_step(
        cfg, pmesh.make_mesh(devices=["cpu"] * 4), tx, boundary_boost=BOOST)
    state, losses = _run(start, step, batch)
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=0, atol=1e-5)
    assert not all(torch.equal(state.params[k], v)  # the steps moved them
                   for k, v in start.params.items())
    for r in (0, 1):
        got = np.load(tmp_path / f"params{r}.npz")
        assert sorted(got.files) == sorted(state.params)
        for k, v in state.params.items():
            torch.testing.assert_close(torch.from_numpy(got[k]), v,
                                       rtol=1e-5, atol=1e-5)

    s0, s1 = set(res[0]["studies"]), set(res[1]["studies"])
    assert s0.isdisjoint(s1) and len(s0) - len(s1) == 1
    assert s0 | s1 == {f"study_{i}" for i in range(5)}


def test_one_process_step_does_not_reduce(monkeypatch):
    """Without a process group the step never calls a collective."""
    import torch.distributed as dist

    from unetseg_tpu_torch import train
    from unetseg_tpu_torch.parallel import mesh as pmesh

    def refuse(*a, **k):
        raise AssertionError("all_reduce in a single process")
    monkeypatch.setattr(dist, "all_reduce", refuse)
    cfg, tx, state, batch = _setup()
    step = train.make_sharded_train_step(
        cfg, pmesh.make_mesh(devices=["cpu"] * 2), tx, boundary_boost=BOOST)
    state, losses = _run(state, step, batch)
    assert all(np.isfinite(losses)) and state.step == STEPS


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
