"""K7, the int8 3x3 conv, alone on the card; and the other TMA kernels'
resources and times, for a second tree beside this one.

    python3 -m unetseg_tpu_torch.benchmarks.k7_bench [--parity-only]
    python3 -m unetseg_tpu_torch.benchmarks.k7_bench --others [--root DIR]

Builds ``csrc/conv3x3_s8.cu`` (nvcc, ``-Xptxas -v``) and checks its
instantiations as ``chip_smoke.py``'s phase 2 does (``check_s8_resources``:
every plan in both epilogues, none with a spill); holds K7 against its
plain versions bit for bit as phase 21 does, on the same shapes with the
same seeds (``check_k7``); then, unless ``--parity-only``, times K7 per
slim4 forward at batch 128 in the served mode and in its f32 mode beside
the bounds, its plain version, the library route and K1/K2
(``chip_smoke.k7_times``).

``--others`` instead builds K1/K2 (``csrc/conv3x3.cu``), K8
(``csrc/conv3x3_f32.cu``) and K6 (``csrc/dec1_fused.cu``), which share
``csrc/hopper.cuh`` with K7, prints their ``ptxas`` resources and times
K1/K2 and K8 per slim4 forward at batch 128 and K6 at the flagship's last
level (batch 32, 512², C = 64).  ``--root DIR`` imports
``unetseg_tpu_torch`` from another checkout (for example the parent commit
unpacked with ``git archive``), so a change to the shared header can be
held against the parent's resources and times in one call on one card.
The yardsticks (shapes, inputs, timers) are this checkout's
``chip_smoke.py``.  Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parity-only", action="store_true")
    ap.add_argument("--others", action="store_true")
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
        print("k7_bench: CUDA is not available", file=sys.stderr)
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
    if args.others:
        others(torch, cs, conv, dev, card)
        return 0

    from unetseg_tpu_torch import quantize
    from unetseg_tpu_torch.ops import conv_s8

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        for fut in [pool.submit(f) for f in (conv_s8.LIBRARY.load,
                                             conv.load)]:
            fut.result()
    cs.log({"phase": "k7_build", "seconds": time.perf_counter() - t0,
            **card})
    cs.check_s8_resources(conv_s8)
    err = cs.check_k7(torch, conv_s8, dev)
    cs.log({"phase": "k7_parity_done", "max_abs_err": err, **card})
    if args.parity_only:
        return 0
    cs.k7_times(torch, F, quantize, conv, conv_s8, dev, card)
    stem_fill(torch, F, cs, conv_s8, dev, card)
    return 0


def stem_fill(torch, F, cs, conv_s8, dev, card) -> None:
    """slim4's C = 16 stem conv in the served mode two ways: its 32-channel
    boxes half zero-filled by TMA (C = 16 as it is), and the input and
    weights zero-padded to C = 32 first (the pad's own time beside)."""
    x, wk, scale, bias = cs.s8_inputs(torch, cs.SLIM4_CONVS[0], 128, dev, 600)
    scales = cs.s8_scales(torch, conv_s8.conv3x3_s8(x, wk, scale, bias))[:1]
    xp, wp = F.pad(x, (0, 16)), F.pad(wk, (0, 16))
    same = torch.equal(conv_s8.conv3x3_s8_q(x, wk, scale, bias, scales)[0],
                       conv_s8.conv3x3_s8_q(xp, wp, scale, bias, scales)[0])
    ms = {}
    for tag in ("c16", "c32", "c32_2", "c16_2"):
        a, w = (x, wk) if tag.startswith("c16") else (xp, wp)
        ms[tag] = cs.time_ms(torch, lambda: conv_s8.conv3x3_s8_q(
            a, w, scale, bias, scales), 20)
    pad_ms = cs.time_ms(torch, lambda: F.pad(x, (0, 16)), 20)
    cs.log({"phase": "k7_stem_fill", "shape": [128, *cs.SLIM4_CONVS[0]],
            "zero_filled_ms": [ms["c16"], ms["c16_2"]],
            "padded_ms": [ms["c32"], ms["c32_2"]], "pad_ms": pad_ms,
            "equal": same, **card})


def others(torch, cs, conv, dev, card) -> None:
    """K1/K2, K8 and K6: resources as phase 2 logs them, then their times."""
    from unetseg_tpu_torch.ops import dec1

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        for fut in [pool.submit(f) for f in (conv.load,
                                             conv.LIBRARY_F32.load,
                                             dec1.load)]:
            fut.result()
    cs.log({"phase": "others_build", "seconds": time.perf_counter() - t0,
            **card})
    for phase, rows in (("conv_resources", conv.resources()),
                        ("f32_resources", conv.resources_f32()),
                        ("dec1_resources", dec1.resources())):
        for r in rows:
            cs.log({"phase": phase, **r, "root": card["root"]})
    ms = {"k1": 0.0, "k2": 0.0, "k8": 0.0}
    for i, shape in enumerate(cs.SLIM4_CONVS):
        key = "k1" if shape[2] >= 128 else "k2"
        x, w, b = cs.conv_inputs(torch, shape, 128, dev, 600 + i)
        ms[key] += cs.time_ms(torch, lambda: conv.conv3x3_bias_act(x, w, b),
                              10)
        x, w, b = cs.f32_inputs(torch, shape, 128, dev, 700 + i)
        ms["k8"] += cs.time_ms(torch, lambda: conv.conv3x3_bias_act(x, w, b),
                               3, 1)
        del x, w, b
    ops = cs.k6_inputs(torch, cs.FLAGSHIP_BATCH, 512, 512, 64, 3, dev, 564)
    with torch.inference_mode():
        ms["k6"] = cs.time_ms(torch, lambda: dec1.dec1_fused_masks(*ops), 10)
    print(json.dumps({"phase": "others_times", "k1_k2_batch": 128,
                      "k8_batch": 128, "k6_shape": list(ops[1].shape),
                      **{f"{k}_ms": v for k, v in ms.items()}, **card}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
