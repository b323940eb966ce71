#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``unetseg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:

1. Device: the card's name and power limit (nvidia-smi); no CUDA -> exit 1.
2. Build: the conv kernel (nvcc, sm_90a) and the host C++ library, together.
3. Kernel parity: the conv kernel against its plain PyTorch version on
   slim4's ten conv shapes at batch 8, plus a ragged shape.
4. Main path, with the launch counters set to 0 just before it:
   ``initialize_engine`` on models/flagship_slim4.ckpt; ``process_batch`` on
   256 synthetic 768² RAWs at batch 128, tier full; ``process_single_image``
   on one RAW; bench.py's accuracy pool (seed 991, 32 slices) must reach
   fg_iou_min >= 0.999; masks on two slices agree with the plain path run
   on the CPU.  Every forward pass must launch the kernel exactly 10 times.
5. Numbers: slices/s of the device pipeline (u8 -> mask, batch 128, CUDA
   events), its device time by kernel and idle share (torch.profiler), and
   per conv shape at batch 128 the kernel, library (F.conv2d, channels-last
   bf16, without the ReLU) and plain times beside the bound.  The kernels
   record sums each variant's times over the shapes of one forward.

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "models", "flagship_slim4.ckpt")

# (H, W, C, D) of slim4's ten 3x3 convs at a 512² input, in forward order.
SLIM4_CONVS = [(128, 128, 16, 64), (128, 128, 64, 64), (64, 64, 64, 128),
               (64, 64, 128, 128), (32, 32, 128, 256), (32, 32, 256, 256),
               (64, 64, 256, 128), (64, 64, 128, 128), (128, 128, 128, 64),
               (128, 128, 64, 64)]
# Extra parity shapes: ragged H/W and a D that is not a multiple of 64.
EXTRA_CONVS = [(37, 53, 16, 48), (19, 23, 128, 80)]
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
RTOL, ATOL = 1.6e-2, 1e-2
REPLACES = {"conv3x3_bias_act": "unetseg_tpu/ops/pallas_conv.py:189",
            "conv3x3_bias_act_small_c": "unetseg_tpu/ops/pallas_conv.py:123"}
SOURCE = "unetseg_tpu_torch/csrc/conv3x3.cu"


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def variant(c: int) -> str:
    return "conv3x3_bias_act_small_c" if c < 128 else "conv3x3_bias_act"


def conv_inputs(torch, shape, batch, device, seed):
    h, w, c, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, h, w, c), generator=g, device=device)
    wt = torch.randn((3, 3, c, d), generator=g, device=device) / (9 * c) ** 0.5
    b = torch.randn((d,), generator=g, device=device) * 0.1
    return (x.to(torch.bfloat16), wt.to(torch.bfloat16), b.to(torch.bfloat16))


def conv_bound(shape, batch):
    """(bound ms, flop ms, byte ms) of one conv: each input read once and
    the output written once, against the bf16 tensor-core peak."""
    h, w, c, d = shape
    m = batch * h * w
    flops = 2.0 * m * d * 9 * c
    nbytes = 2.0 * (m * c + 9 * c * d + d + m * d)
    f_ms = flops / PEAK_BF16_FLOPS * 1e3
    b_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return max(f_ms, b_ms), f_ms, b_ms


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_pipeline(torch, fn, iters: int = 5) -> dict:
    """Device time by kernel over ``iters`` calls (torch.profiler), and the
    device's idle share of the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device events only: the host ops above them report the same time.
    rows = sorted(((e.self_device_time_total, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(t for t, _ in rows)
    return {"iters": iters, "wall_ms_per_iter": wall_us / iters / 1e3,
            "device_ms_per_iter": busy_us / iters / 1e3,
            "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
            "top": [{"kernel": k[:90], "ms_per_iter": t / iters / 1e3}
                    for t, k in rows[:10]]}


def check_parity(torch, conv, device, shapes, batch):
    """Kernel vs plain version per shape; returns {variant: max abs err}."""
    worst = {}
    for i, shape in enumerate(shapes):
        x, w, b = conv_inputs(torch, shape, batch, device, seed=100 + i)
        for relu in (True, False) if i == 0 else (True,):
            got = conv.conv3x3_bias_act(x, w, b, relu=relu)
            want = conv.conv3x3_bias_act_plain(x, w, b, relu=relu)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"conv {shape}: non-finite output")
            torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                                       atol=ATOL)
            err = (got.float() - want.float()).abs().max().item()
            v = variant(shape[2])
            worst[v] = max(worst.get(v, 0.0), err)
            log({"phase": "parity", "shape": [batch, *shape], "relu": relu,
                 "variant": v, "max_abs_err": err})
    return worst


def write_raws(raw_io, synth_slice, np, d, n, size):
    rng = np.random.default_rng(2024)
    paths = []
    for i in range(n):
        p = os.path.join(d, f"slice_{i:03d}.raw")
        raw_io.write_raw(p, synth_slice(rng, size)[0])
        paths.append(p)
    return paths


ARTIFACTS = ("_normalized.png", "_original_sizes.json", "_mask.png",
             "_contour_overlay.png", ".json")


def check_artifacts(d, base):
    paths = {s: os.path.join(d, base + s) for s in ARTIFACTS}
    missing = [s for s, p in paths.items()
               if not (os.path.isfile(p) and os.path.getsize(p) > 0)]
    if missing:
        raise AssertionError(f"{base}: missing artifacts {missing}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    import torch.nn.functional as F

    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.data import synth_batch, synth_slice
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.metrics import foreground_iou
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import conv
    from unetseg_tpu_torch.ops.preprocess import preprocess_oracle_u8

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    card = {"card": kind, "nvidia_smi": smi}
    log({"phase": "device", **card, "count": torch.cuda.device_count(),
         "torch": torch.__version__, "cuda": torch.version.cuda})
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False  # plain version: full f32
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 2. build (kernel and host library together) -----------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        for fut in [pool.submit(conv.load), pool.submit(native.load)]:
            fut.result()
    log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3)})

    # -- 3. kernel parity on the card --------------------------------------
    max_err = check_parity(torch, conv, dev, SLIM4_CONVS + EXTRA_CONVS, 8)

    # -- 4. main path --------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        conv.reset_launches()
        if not engine.initialize_engine(CKPT, log_dir=os.path.join(tmp, "log")):
            raise AssertionError("initialize_engine returned False")
        eng = engine.get_engine()
        size = 768
        in_dir, out_dir = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(in_dir)
        paths = write_raws(raw_io, synth_slice, np, in_dir, 256, size)
        t0 = time.perf_counter()
        ok, failed = engine.process_batch(paths, size, size, [out_dir] * 256,
                                          batch_size=128, tier="full")
        batch_s = time.perf_counter() - t0
        if (ok, failed) != (256, 0):
            raise AssertionError(f"process_batch: {ok} ok, {failed} failed")
        check_artifacts(out_dir, "slice_017")
        single_dir = os.path.join(tmp, "single")
        t0 = time.perf_counter()
        if not engine.process_single_image(paths[3], size, size, single_dir):
            raise AssertionError("process_single_image returned False")
        single_s = time.perf_counter() - t0
        check_artifacts(single_dir, "slice_003")

        raws, labels = synth_batch(np.random.default_rng(991), 32)
        u8v = np.stack([preprocess_oracle_u8(r, 512) for r in raws])
        pred = eng.to_host(eng.infer(u8v))()
        ious = [foreground_iou(pred[i], labels[i]) for i in range(32)]
        launches = dict(conv.LAUNCHES)
        forwards = eng.forwards
    log({"phase": "main_path", "process_batch_256_s": batch_s,
         "process_single_image_s": single_s, "forwards": forwards,
         "launches": launches, "fg_iou_mean": float(np.mean(ious)),
         "fg_iou_min": float(np.min(ious)), **card})
    if launches["conv3x3_bias_act"] != 6 * forwards or \
            launches["conv3x3_bias_act_small_c"] != 4 * forwards:
        raise AssertionError(f"{launches} launches over {forwards} forwards: "
                             f"want 10 per forward (6 + 4)")
    if min(ious) < 0.999:
        raise AssertionError(f"fg_iou_min {min(ious)} < 0.999")

    # The same model on the CPU (plain conv) on two slices at 256².
    params, cfg = checkpoint.load(CKPT)
    cpu_model = registry.build(params, cfg, device="cpu")
    x = torch.from_numpy(np.stack([preprocess_oracle_u8(r, 256)
                                   for r in raws[:2]])).float()[..., None] / 255
    with torch.inference_mode():
        want = torch.argmax(cpu_model(x), -1)
        got_logits = eng.model(x.to(dev))
        got = torch.argmax(got_logits, -1).cpu()
    if not (got_logits.shape == (2, 256, 256, 3)
            and torch.isfinite(got_logits).all()):
        raise AssertionError("device logits: wrong shape or non-finite")
    agree = (got == want).float().mean().item()
    log({"phase": "cpu_reference", "mask_agreement": agree})
    if agree < 0.999:
        raise AssertionError(f"device vs CPU masks agree on {agree} < 0.999")

    # -- 5. numbers ----------------------------------------------------------
    batch = 128
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, 512, 512), dtype=np.uint8)).to(dev)
    iters = 20
    pipe_ms = time_ms(torch, lambda: eng._pipeline(u8), iters)
    log({"phase": "throughput", "batch": batch,
         "slices_per_s": batch / pipe_ms * 1e3, "ms_per_batch": pipe_ms,
         **card})
    log({"phase": "profile", **profile_pipeline(torch, lambda: eng._pipeline(u8)),
         **card})

    per_variant = {}
    for i, shape in enumerate(SLIM4_CONVS):
        x, w, b = conv_inputs(torch, shape, batch, dev, seed=200 + i)
        xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        k_ms = time_ms(torch, lambda: conv.conv3x3_bias_act(x, w, b), 10)
        lib_ms = time_ms(torch, lambda: F.conv2d(xc, wc, b, padding=1), 10)
        plain_ms = time_ms(torch, lambda: conv.conv3x3_bias_act_plain(x, w, b),
                           5, warmup=1)
        bound, f_ms, b_ms = conv_bound(shape, batch)
        v = variant(shape[2])
        log({"phase": "conv_time", "shape": [batch, *shape], "variant": v,
             "ms": k_ms, "library_ms": lib_ms, "plain_ms": plain_ms,
             "bound_ms": bound, "flop_ms": f_ms, "byte_ms": b_ms,
             "launches_per_forward": 1, **card})
        acc = per_variant.setdefault(v, {"ms": 0.0, "library_ms": 0.0,
                                         "plain_ms": 0.0, "bound_ms": 0.0,
                                         "flop_ms": 0.0, "byte_ms": 0.0})
        for key, val in (("ms", k_ms), ("library_ms", lib_ms),
                         ("plain_ms", plain_ms), ("bound_ms", bound),
                         ("flop_ms", f_ms), ("byte_ms", b_ms)):
            acc[key] += val
        del x, w, b, xc, wc

    kernels = []
    for name, acc in per_variant.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": ("operations" if acc["flop_ms"] >= acc["byte_ms"]
                         else "bytes"),
            "library_ms": acc["library_ms"]})
    engine.cleanup_resources()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
