"""K8, the float32 3x3 conv, alone on the card: build, resources, parity, times.

    python3 -m unetseg_tpu_torch.benchmarks.k8_bench [--parity-only]
        [--root DIR]
    python3 -m unetseg_tpu_torch.benchmarks.k8_bench --t2s STEPS [--root DIR]

Builds ``csrc/conv3x3_f32.cu`` (nvcc, ``-Xptxas -v``) and checks its
instantiations as ``chip_smoke.py``'s phase 2 does (``check_f32_resources``:
every variant built, none with a spill); holds K8 against its plain version
and a float64 reference as phase 22 does, on the same shapes with the same
seeds and bars (``check_k8``); then, unless ``--parity-only``, times K8, its
plain version and ``F.conv2d`` (float32, TF32 off) per shape of slim4 at
batch 128 and of the flagship at 32 and prints the sums per forward
(``k8_per_forward``) beside the bounds of ``chip_smoke.f32_bound``.

``--t2s STEPS`` instead times train-to-serve (``chip_smoke.T2S_KW``: 64²,
base 8, depth 2, float32, batch 8; K8 at C = D = 16, where launches and each
call's host work weigh most): STEPS steps after three warm-up steps, batches
made beforehand; then the host time of one call of the conv entry, of the
data gradient and of K8's C entry on each conv shape of the model, without
a sync between calls; then the device time by kernel and the device's idle
share over ten profiled steps (``chip_smoke.profile_pipeline``).

The yardsticks (shapes, bars, bounds, checks) are this checkout's
``chip_smoke.py``; ``--root DIR`` imports ``unetseg_tpu_torch`` from another
checkout (for example the parent commit unpacked with ``git archive``), so
two versions of K8 can be timed in one call on one card.  The resource
check needs a checkout of K8's split-TF32 design (``F32_INSTANTIATIONS``);
``--t2s`` takes any.  Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROFILED_STEPS = 10
HOST_CALLS = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parity-only", action="store_true")
    ap.add_argument("--t2s", type=int, default=0)
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m == "unetseg_tpu_torch"
                 or m.startswith("unetseg_tpu_torch.")]:
        del sys.modules[name]  # the package of --root, not this one

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k8_bench: CUDA is not available", file=sys.stderr)
        return 1
    from unetseg_tpu_torch.ops import conv

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "root": root}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    conv.LIBRARY_F32.load()
    cs.log({"phase": "k8_build", "seconds": time.perf_counter() - t0,
            **card})
    if args.t2s:
        t2s(torch, cs, conv, dev, args.t2s, card)
        return 0
    cs.check_f32_resources(conv)
    err = cs.check_k8(torch, conv, dev, cs.F32_SERVED_CONVS,
                      cs.F32_PARITY_BATCH, 800)
    err = max(err, cs.check_k8(torch, conv, dev, cs.F32_EDGE_CONVS,
                               cs.EDGE_BATCH, 900))
    err = max(err, cs.check_k8(torch, conv, dev, cs.F32_EDGE_CONVS[:3],
                               cs.EDGE_BATCH, 950, relu=False))
    cs.log({"phase": "k8_parity_done", "max_abs_err": err, **card})
    if args.parity_only:
        return 0

    for name, convs, batch in (("slim4", cs.SLIM4_CONVS, 128),
                               ("flagship", cs.FLAGSHIP_CONVS,
                                cs.FLAGSHIP_BATCH)):
        acc = cs.k8_times(torch, F, conv, dev, convs, batch, card, name)
        print(json.dumps({"phase": "k8_bench", "model": name, "batch": batch,
                          "ms": acc["ms"], "plain_ms": acc["plain_ms"],
                          "library_ms": acc["library_ms"],
                          "tf32x3_flop_ms": acc["flop_ms"],
                          "simt_flop_ms": acc["simt_ms"], **card}),
              flush=True)
    return 0


def t2s(torch, cs, conv, dev, steps, card) -> None:
    import numpy as np

    from unetseg_tpu_torch import graphs, train
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.data import training_batch

    cfg = ModelConfig(**cs.T2S_KW)
    total = steps + 4 + PROFILED_STEPS + 1
    tx = train.make_optimizer(lr=1e-2, total_steps=total)
    rng = np.random.default_rng(0)
    batches = iter([training_batch(rng, 8, 64) for _ in range(total)])
    state = train.init_state(0, cfg, tx, device=dev)

    def step():
        nonlocal state
        state, loss = train.train_step(state, next(batches), cfg, tx)
        return loss

    for _ in range(3):
        step()
    # The forward's convs of one step, as the conv entry sees them.
    shapes, entry = [], conv.conv3x3_bias_act

    def seen(x, w, b, relu=True):
        if relu:
            shapes.append((tuple(x.shape), tuple(w.shape)))
        return entry(x, w, b, relu)

    conv.conv3x3_bias_act = seen
    try:
        step()
    finally:
        conv.conv3x3_bias_act = entry
    torch.cuda.synchronize()
    graphs.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step()
    float(loss)
    wall = time.perf_counter() - t0
    k8 = conv.LAUNCHES["conv3x3_bias_act_f32"]
    print(json.dumps({"phase": "k8_t2s", "steps": steps,
                      "ms_per_step": wall / steps * 1e3,
                      "k8_launches_per_step": k8 / steps,
                      "loss": float(loss), **card}), flush=True)

    # Host time per call: the entry, the data gradient, K8's C entry.
    lib = conv.LIBRARY_F32.load()
    c_entry = {"s": 0.0, "n": 0}

    class TimedLib:
        def __getattr__(self, name):
            return getattr(lib, name)

        def utconv3x3_f32(self, *a):
            t = time.perf_counter()
            err = lib.utconv3x3_f32(*a)
            c_entry["s"] += time.perf_counter() - t
            c_entry["n"] += 1
            return err

    rows = []
    timed = TimedLib()
    conv.LIBRARY_F32.load = lambda: timed
    try:
        for xs, ws in shapes:
            x = torch.randn(xs, device=dev)
            w = torch.randn(ws, device=dev)
            b = torch.randn(ws[3:], device=dev)
            g = torch.randn((*xs[:3], ws[3]), device=dev)
            row = {"x": list(xs), "w": list(ws)}
            for key, fn in (("entry_us", lambda: conv.conv3x3_bias_act(
                    x, w, b)), ("dgrad_us", lambda: conv.conv3x3_dgrad(g, w))):
                fn()
                torch.cuda.synchronize()
                c_entry.update(s=0.0, n=0)
                t = time.perf_counter()
                for _ in range(HOST_CALLS):
                    fn()
                row[key] = (time.perf_counter() - t) / HOST_CALLS * 1e6
                row[key.replace("_us", "_c_entry_us")] = \
                    c_entry["s"] / max(c_entry["n"], 1) * 1e6
                torch.cuda.synchronize()
            rows.append(row)
    finally:
        del conv.LIBRARY_F32.load
    print(json.dumps({"phase": "k8_t2s_host", "calls": HOST_CALLS,
                      "shapes": rows, **card}), flush=True)
    prof = cs.profile_pipeline(torch, step, iters=PROFILED_STEPS, top=12)
    prof.pop("ops")
    print(json.dumps({"phase": "k8_t2s_profile", **prof, **card}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
