"""``unetseg_tpu_torch.parallel.distributed`` with two real processes over
``gloo`` on localhost (the port's tests/test_distributed_multiproc.py).

Each child is this file run as a script: it joins the process group from
the JAX package's environment variables, takes its studies by
``shard_studies`` and serves them with the shipped slim4 checkpoint on the
CPU.  The union of the two children's artifacts must be byte-equal to one
process serving every study, and the shares disjoint and covering.  The
single-process call is a no-op that returns False.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "flagship_slim4.ckpt")
SIZE = 128          # RAW side; the engine resamples to 512²
STUDIES = 5         # two slices each
CHILD_TIMEOUT_S = 240


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _studies(root):
    """{study dir: [RAW paths]}: five studies of two synthetic slices."""
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import raw as raw_io

    rng = np.random.default_rng(21)
    out = {}
    for s in range(STUDIES):
        d = os.path.join(root, f"study_{s}")
        os.makedirs(d)
        out[d] = []
        for i in range(2):
            p = os.path.join(d, f"s{i}.raw")
            raw_io.write_raw(p, synth_slice(rng, SIZE)[0])
            out[d].append(p)
    return out


def serve(studies, out_root):
    """Every slice of ``studies`` (study dirs) through ``process_batch`` on
    a CPU engine, into ``out_root/<study>``."""
    from unetseg_tpu_torch import engine
    from unetseg_tpu_torch.io import raw as raw_io

    assert engine.initialize_engine(CKPT, log_dir=os.path.join(out_root,
                                                               "log"),
                                    device="cpu")
    try:
        for d in studies:
            files = raw_io.find_16bit_images(d, False)
            out = os.path.join(out_root, os.path.basename(d))
            assert engine.process_batch(files, SIZE, SIZE, [out] * len(files),
                                        batch_size=2) == (len(files), 0)
    finally:
        engine.cleanup_resources()


def child(port, rank, world, root):
    from unetseg_tpu_torch.parallel import distributed

    os.environ.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      JAX_NUM_PROCESSES=str(world),
                      JAX_PROCESS_ID=str(rank))
    assert distributed.initialize_distributed(device="cpu")
    mesh = distributed.global_mesh(devices=["cpu"])
    studies = sorted(os.path.join(root, "in", d)
                     for d in os.listdir(os.path.join(root, "in")))
    mine = distributed.shard_studies(studies)
    serve(mine, os.path.join(root, f"out{rank}"))
    import torch.distributed as dist

    dist.barrier()
    with open(os.path.join(root, f"proc{rank}.json"), "w") as f:
        json.dump({"rank": distributed.process_index(),
                   "world": distributed.process_count(),
                   "mesh": mesh.shape,
                   "studies": [os.path.basename(s) for s in mine]}, f)
    dist.destroy_process_group()


def _tree(root):
    """{path relative to root: bytes} of every artifact under the study
    dirs of ``root``."""
    out = {}
    for d in sorted(os.listdir(root)):
        if d.startswith("study_"):
            for f in sorted(os.listdir(os.path.join(root, d))):
                with open(os.path.join(root, d, f), "rb") as fh:
                    out[f"{d}/{f}"] = fh.read()
    return out


def test_two_process_gloo_study_sharding(tmp_path):
    _studies(str(tmp_path / "in"))
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
    assert res[0]["mesh"] == {"dp": 1, "sp": 1}
    s0, s1 = set(res[0]["studies"]), set(res[1]["studies"])
    assert s0.isdisjoint(s1) and len(s0) - len(s1) == 1
    assert s0 | s1 == {f"study_{i}" for i in range(STUDIES)}

    serve(sorted(str(p) for p in (tmp_path / "in").iterdir()),
          str(tmp_path / "one"))
    union = {**_tree(str(tmp_path / "out0")), **_tree(str(tmp_path / "out1"))}
    single = _tree(str(tmp_path / "one"))
    assert sorted(union) == sorted(single)
    # every slice has its five artifacts: the comparison is not vacuous
    assert len(single) == 5 * 2 * STUDIES
    for name, data in single.items():
        assert union[name] == data, name


def test_single_process_is_a_no_op(monkeypatch):
    from unetseg_tpu_torch.parallel import distributed

    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_distributed() is False
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert distributed.initialize_distributed(device="cpu") is False
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    paths = [f"study_{i}" for i in range(5)]
    assert distributed.shard_studies(paths) == paths
    assert distributed.global_mesh(devices=["cpu"] * 2).shape == \
        {"dp": 2, "sp": 1}
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize_distributed(num_processes=2, device="cpu")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
