#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``unetseg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:

1. Device: the card's name and power limit (nvidia-smi); no CUDA -> exit 1.
2. Build: all four kernel sources (conv, CCL, fused last decoder level,
   halo copy; nvcc, sm_90a), K6's phase-stamped build and the host C++
   library, all at once; then
   the conv kernel's, K6's and the CCL passes' registers, spills and
   shared memory per instantiation, as ``nvcc -Xptxas -v`` reported them,
   one line each (``conv_resources``, ``dec1_resources``,
   ``cc_resources``); a spill in K6 or K3 fails the run.
3. Kernel parity: the conv kernel against its plain PyTorch version on
   slim4's ten conv shapes at batch 8, plus two ragged shapes, and on the
   tiling's edge cases at batch 3 (several column tiles with a remainder,
   fewer rows than a tile, D = 112, C = 48, 80, 96); the CCL kernel
   (``cc_label``, ``cc_label_stats`` and ``propagate_min``) bit for bit
   against its plain version on the CCL test shapes at full size, a batch
   of 128 512² 50% speckles (also over 8 x 16 tiles) and the edges of its
   tile plan (``cc_edge_cases``); the stats table where it is defined.
4. Main path, host cleanup, with the launch counters set to 0 just before
   it: ``initialize_engine`` on models/flagship_slim4.ckpt;
   ``process_batch`` twice on 256 synthetic 768² RAWs at batch 128, tier
   full; ``process_single_image`` on one RAW; bench.py's accuracy pool
   (seed 991, 32 slices) must reach fg_iou_min >= 0.999; masks on two
   slices agree with the plain path run on the CPU.  Every forward pass
   must launch the conv kernel exactly 10 times and the CCL kernel never.
   Then the CCL kernel against its plain version on a batch of 128 real
   512² argmax masks: their inverses and their opened foregrounds.
5. Main path, device cleanup, with the counters set to 0 just before it:
   ``initialize_engine(..., device_postprocess=True)``, ``process_batch``
   twice on the same RAWs, ``process_single_image``.  Every forward must
   launch the conv kernel 10 times and the CCL kernel exactly 2 times; the
   artifacts must be byte-equal to phase 4's; on the batch of 128 the
   cleaned masks must be bit-equal to the host C++ ``postprocess_batch`` of
   the same argmax masks (and on those masks with salt-and-pepper noise,
   and on the speckle), with no host synchronisation in the cleanup.
6. The TCP service with device cleanup on localhost, counters set to 0
   just before it: ``init``, a directory ``process`` (32 RAWs, tier full),
   a single-file ``process``, ``status``, ``metrics``, ``shutdown``; its
   artifacts must be byte-equal to phase 4's for the same RAWs.
7. Numbers: slices/s of the device pipeline (u8 -> mask, batch 128, CUDA
   events) without and with device cleanup, the device time by kernel and
   idle share of each (torch.profiler); per conv shape at batch 128 the
   kernel, library (F.conv2d, channels-last bf16, without the ReLU) and
   plain times beside the bound; the CCL kernel's and its plain version's
   time per call, labels alone and with stats, on the real masks and on
   the speckle, beside its bound; the whole device cleanup's time per batch
   beside the host C++ cleanup's wall time, and its device time by kernel
   (no scatter or index_fill may remain).  The kernels record sums each
   conv variant's times over the shapes of one forward, and the CCL
   kernel's the two stats calls of one cleanup batch.

8. Flagship parity: the conv kernel against its plain version on the 16
   unfused conv shapes of the flagship ``ModelConfig()`` (depth 4, base 64,
   stem 1) at batch 2, C = 1 and a stem-2 C = 4 included (both reach the
   kernel zero-padded to 16 channels); the fused last decoder level (K6)
   against ``dec1_fused_plain`` at B = 2 and 32, 512², C = 64, on random
   inputs (masks equal except near ties, ``dec1.near_tie``), on small-
   integer inputs whose every f32 sum is exact and whose logits tie (bit
   for bit), on odd sizes and other C, and at the edges of its tile plan
   (ragged last tiles both ways, images smaller than one tile, B = 1 and
   3, K = 1 and 8); the halo copies (K4, K5) bit for bit against the
   slice.
9. Flagship main path, counters set to 0 just before it:
   ``checkpoint.create(ModelConfig(), seed=0)`` with its head bias centred
   on the RAWs' logits (so every class and contour occurs), then
   ``initialize_engine``, ``process_batch`` on 64 synthetic 768² RAWs at
   batch 32, tier full, and ``process_single_image``: all five artifacts;
   per forward 13 K1, 3 K2, 1 K6 and no K3 launches; masks on two slices
   agree with the CPU path on >= 99.5% of pixels, every differing pixel
   within 4 ulps of ``dec1.near_tie``; the TCP service's
   ``init`` on that checkpoint and one single-file ``process``.
10. Flagship numbers: the device pipeline at batch 32 (CUDA events) and its
   device time by kernel and idle share (torch.profiler); per conv shape at
   batch 32 the kernel and ``F.conv2d`` times beside the bound; K6 on the
   real last-level inputs of a batch of 32 beside its bound, its plain
   version, the port's unfused sequence (``UpConv``, ``cat``, K1, K2, head,
   argmax) and the cuDNN/cuBLAS sequence (no single PyTorch call computes
   it), and where a tile's cycles go
   (``unetseg_tpu_torch.benchmarks.dec1_phases``); K4 and K5 beside their
   bound and ``.contiguous()``; then
   ``unetseg_tpu_torch.benchmarks.exp_bw.main()`` once, with the copy
   counters set to 0 just before it (the probe is K4's and K5's path).

11. Configs the card used to refuse (``configs``): a stem-1 base-128 model
   and the 12-class stem-1 model with 4 input channels through
   ``UNet.masks`` (the unfused route: no K6 launch, the conv kernel once
   per 3x3 conv), card vs CPU masks within ``CPU_TIE_ULPS`` of
   ``dec1.near_tie``; a base-8 model (D = 8 padded to 16) the same way and
   served by the engine; a float32 model refused by ``initialize_engine``
   with the reason in its log.

12. Device preprocess (``preprocess_device``): ``normalize_u8`` and
   ``resize_normalize_u8`` on the card bit-equal to the same functions on
   the CPU, on seeded 768² and 2048 x 1536 u16 images and a constant one.
   The conv kernel against its plain version at the flagship's last-level
   conv1 (``LOGITS_CONVS``), which only the logits paths run in it, at the
   batches they give it (``LOGITS_BATCHES``).
13. TTA (``tta``), for slim4 and the flagship (seeded, head bias centred),
   at 512²: ``process_single_image(tta=True)`` with host and with device
   cleanup, counters set to 0 just before each call: all five artifacts,
   byte-equal between the two cleanups; 8 x (6 K1 + 4 K2) launches per call
   for slim4, 8 x (14 K1 + 4 K2) for the flagship (its last level runs in
   the conv kernel: the ensemble needs logits), no K6, 2 K3 with device
   cleanup.  The weight-space masks against the activation-space masks on
   the card, every differing pixel within ``CPU_TIE_ULPS`` of the near-tie
   rule on the averaged logits and absolute head sums
   (``dec1.near_tie_sums``); the card's masks against the same path with
   the UNet's convs swapped for the plain conv (``plain_convs``; on the CPU
   for slim4, on the card for the flagship), >= ``CPU_AGREEMENT`` equal and
   within the same rule; ms per slice of weight-space TTA (its first call,
   which builds the 8 variants, apart), activation-space TTA and the plain
   slice.
14. Sliding windows (``tiled``), for both models:
   ``process_single_image(window=512)`` on a 2048 x 1536 RAW (5 x 7
   windows on a regular grid: the overlap-add blend), with ``overlap=128``
   (an irregular grid: the padded-stack blend) and on a 40 x 10 RAW (10
   rows, below the 16-pixel alignment: edge-padded, then cropped), each
   with host and with device cleanup, counters set to 0 just before each
   call: device-cleanup artifacts byte-equal to host-cleanup ones; per
   image ceil(windows / 32) model passes times the convs per forward, no
   K6, 2 K3 with device cleanup.  K3 bit for bit against its plain
   version on the 2048 x 1536 masks and the cropped 40 x 10 masks; the
   masks against the plain convs, as for TTA (slim4 on the CPU on a 1024 x
   768 RAW, the flagship on the card on the 2048 x 1536 RAW, whose windows
   pass at batches 32 and 3); ms per 2048 x 1536 image: the model, the
   blend, the cleanup and the whole pipeline.
15. The study runner (``study``, BASELINE config 4), for slim4 on 300
   synthetic 768² RAWs at batch 128 (a ragged tail of 44) and the seeded
   flagship on 64 at batch 32: ``engine.process_batch`` (tier full) as the
   reference, then ``parallel.pipeline.run_study(host_preprocess=True,
   artifacts="full")``, ``run_study(host_preprocess=False)``,
   ``run_study_device_resident(artifacts="json")`` with host and with
   device cleanup, the counters set to 0 just before each: per run one
   forward a batch, each forward's K1/K2 (and K6 for the flagship)
   launches, 2 K3 a batch with device cleanup; the masks of every run
   equal, the full artifacts byte-equal to process_batch's and the
   resident runs' JSONs too.  The device preprocess (float32) may part from
   the host C++ one (float64) by one gray level at a few pixels: where that
   run's masks differ, its u8 must, and its masks must be the host cleanup
   of the argmax of its own u8.  Slices/s, wall, inference and staging
   seconds, the host stages (``pipeline.STAGES``: load, h2d, d2h, cleanup,
   emit) and the device's idle share (torch.profiler) of each run and of
   process_batch.  Their launches are added to the kernels line.
16. The bench (``bench``): ``python -m unetseg_tpu_torch.bench`` in a
   subprocess, its JSON line logged as it is; fg_iou_min and
   parity_polygon_iou (against the numpy/scipy reference twin) must reach
   0.999, and the bench must exit 0.

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import contextlib
import json
import os
import shutil
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
# Edges of the kernel's tiling (ops/conv.tile_plan), at batch 3: W = 300
# (three 128-column tiles, the last ragged) with D = 112; H = 7 over 4-row
# tiles at W = 32; H = 3, fewer rows than a tile; C = 48, 80 (16-channel
# boxes) and 96 (32-channel boxes).
EDGE_CONVS = [(19, 300, 128, 112), (7, 32, 48, 112), (3, 20, 80, 64),
              (9, 70, 96, 48)]
EDGE_BATCH = 3
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
RTOL, ATOL = 1.6e-2, 1e-2
REPLACES = {"conv3x3_bias_act": "unetseg_tpu/ops/pallas_conv.py:189",
            "conv3x3_bias_act_small_c": "unetseg_tpu/ops/pallas_conv.py:123",
            "cc_label": "unetseg_tpu/ops/cc_pallas.py:137",
            "copy_elem": "benchmarks/exp_bw.py:49",
            "copy_blocked": "benchmarks/exp_bw.py:74",
            "dec1_fused": "benchmarks/exp_dec1_ablate.py:150"}
SOURCE = "unetseg_tpu_torch/csrc/conv3x3.cu"
CC_SOURCE = "unetseg_tpu_torch/csrc/cc_label.cu"
DEC1_SOURCE = "unetseg_tpu_torch/csrc/dec1_fused.cu"
COPY_SOURCE = "unetseg_tpu_torch/csrc/halo_copy.cu"
N_RAWS = 256     # RAWs of each main path
N_SERVICE = 32   # RAWs of the service's directory request
# (H, W, C, D) of the flagship's 16 unfused 3x3 convs at a 512² input, in
# forward order (the last decoder level's two run inside K6), and a stem-2
# model's first conv (C = 4).
FLAGSHIP_CONVS = [(512, 512, 1, 64), (512, 512, 64, 64), (256, 256, 64, 128),
                  (256, 256, 128, 128), (128, 128, 128, 256),
                  (128, 128, 256, 256), (64, 64, 256, 512), (64, 64, 512, 512),
                  (32, 32, 512, 1024), (32, 32, 1024, 1024),
                  (64, 64, 1024, 512), (64, 64, 512, 512),
                  (128, 128, 512, 256), (128, 128, 256, 256),
                  (256, 256, 256, 128), (256, 256, 128, 128)]
STEM2_CONV = (256, 256, 4, 64)
N_FLAGSHIP = 64  # RAWs of the flagship path
FLAGSHIP_BATCH = 32
# Flagship masks on the card against the CPU path: agreement, and the
# near-tie margin (dec1.near_tie's ulps) within which every differing pixel
# must lie.
CPU_AGREEMENT = 0.995
CPU_TIE_ULPS = 4
# Slices of the phase-11 config checks (each model on the card and the CPU),
# and their least card-vs-CPU mask agreement: seeded models with a centred
# head (12 classes for one) hold more near ties than the flagship's check.
CONFIG_BATCH = 2
CONFIG_AGREEMENT = 0.99
# K6 parity cases: (name, (N, H, W, C, classes, seed), exact).
K6_CASES = [("random", (2, 512, 512, 64, 3, 1), False),
            ("exact_ties", (1, 256, 256, 64, 3, 2), True),
            ("random_b32", (32, 512, 512, 64, 3, 3), False),
            ("odd_50x38", (1, 50, 38, 64, 3, 4), False),
            ("c16_k3", (2, 64, 64, 16, 3, 5), False),
            ("c32_k5", (2, 64, 96, 32, 5, 6), False),
            ("c48_k8", (1, 48, 48, 48, 8, 7), False),
            ("c96_k2", (1, 34, 66, 96, 2, 8), False),
            # Edges of K6's tile plan (ops/dec1.tile_plan: 12 x 28 at C = 64,
            # 14 x 28 at C = 16, 6 x 28 at C = 80): ragged last tiles both
            # ways at B = 3 and K = 1; images smaller than one tile; K = 8.
            ("ragged_b3_k1", (3, 62, 86, 64, 1, 9), False),
            ("small_8x6", (1, 8, 6, 64, 3, 10), False),
            ("small_c80_b3_k8", (3, 10, 20, 80, 8, 11), False),
            ("c16_b1_k1", (1, 30, 58, 16, 1, 12), False)]
# Phases 12-14: the side of the RAW served with tta=True (resampled to
# 512²); the (H, W) RAWs of window mode: 5 x 7 windows of 512 at the default
# overlap, the same at IRREGULAR_OVERLAP (4 x 5, an irregular grid), slim4's
# run against the CPU path (2 x 3 windows), and 10 rows below the 16-pixel
# alignment of both models (edge-padded, then cropped).
TTA_RAW = 768
TILED_WINDOW = 512
IRREGULAR_OVERLAP = 128
TILED_RAW = (1536, 2048)
TILED_CPU_RAW = (768, 1024)
SMALL_RAW = (10, 40)
# The flagship's ModelConfig() keywords (none: full width and depth).
FLAGSHIP_KW: dict = {}
# The flagship's last-level conv1 (H, W, C, D), which the logits paths run
# in the conv kernel (the masks path runs it inside K6), at the batches
# those paths give it: 1 (a TTA pass), 32 and 3 (TILED_RAW's 35 windows).
LOGITS_CONVS = [(512, 512, 128, 64)]
LOGITS_BATCHES = (1, 3, 32)


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


def profile_pipeline(torch, fn, iters: int = 5, top: int = 10) -> dict:
    """Device time by kernel over ``iters`` calls (torch.profiler), and the
    device's idle share of the window's wall time; ``ops`` names every
    event the window recorded, host operators and device kernels."""
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
                    for t, k in rows[:top]],
            "ops": sorted({e.key for e in prof.key_averages()})}


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


def cc_cases(np):
    """(name, bool mask) of the CCL test shapes at full size."""
    spiral = np.zeros((64, 64), bool)
    x0, y0, x1, y1 = 0, 0, 63, 63
    while x0 < x1:
        spiral[y0, x0:x1 + 1] = spiral[y1, x0:x1 + 1] = True
        spiral[y0:y1 + 1, x1] = True
        spiral[y0 + 2:y1 + 1, x0] = True
        x0, y0, x1, y1 = x0 + 4, y0 + 4, x1 - 4, y1 - 4
    serpentine = np.zeros((128, 128), bool)
    for r in range(0, 128, 2):
        serpentine[r, :] = True
        if r + 1 < 128:
            serpentine[r + 1, 127 if (r // 2) % 2 == 0 else 0] = True
    diagonal = np.zeros((16, 16), bool)
    diagonal[2, 2] = diagonal[3, 3] = diagonal[4, 4] = True
    diagonal[10, 2] = diagonal[12, 4] = True
    rng = np.random.default_rng(21)
    cases = [("spiral", spiral), ("serpentine", serpentine),
             ("diagonal", diagonal), ("empty", np.zeros((32, 32), bool)),
             ("full", np.ones((32, 32), bool)),
             ("blobs", np.random.default_rng(0).random((64, 64)) > 0.55)]
    cases += [(f"odd{s}", rng.random(s) > 0.4)
              for s in ((70, 63), (33, 90), (17, 15), (64, 1))]
    return cases


def cc_edge_cases(np):
    """(name, (B, H, W) bool mask, tile) at the edges of K3's tile plan
    (``ops/cc_kernel.tile_plan``; None is the default tile, 32 x 128 at
    W >= 128): diagonal links exactly on tile corners, with ragged last
    tiles both ways; diagonal lines across the kernel's 32-pixel row
    segments; the spiral and the serpentine over small tiles, so
    they cross tile edges many times; random masks over ragged small
    tiles and over 1 x 1 tiles (every link crosses a tile edge); images of
    one row and one column."""
    def corners(b, h, w, th, tw, seed):
        fg = np.random.default_rng(seed).random((b, h, w)) > 0.97
        for i in range(b):
            for k, y0 in enumerate(range(th, h, th)):
                for j, x0 in enumerate(range(tw, w, tw)):
                    fg[i, y0 - 2:y0 + 2, x0 - 2:x0 + 2] = False
                    kind = (i + j + k) % 4
                    if kind in (0, 2):  # NW-SE across the corner
                        fg[i, y0 - 1, x0 - 1] = fg[i, y0, x0] = True
                    if kind in (1, 2):  # NE-SW across the corner
                        fg[i, y0 - 1, x0] = fg[i, y0, x0 - 1] = True
                    if kind == 3 and y0 + 1 < h and x0 + 1 < w:
                        # a diamond around the corner pixel: three tiles
                        fg[i, y0 - 1, x0] = fg[i, y0, x0 - 1] = True
                        fg[i, y0, x0 + 1] = fg[i, y0 + 1, x0] = True
        return fg

    # 1-pixel diagonal lines, both ways, 9 apart: every step that crosses a
    # 32-pixel segment boundary is a diagonal link alone.
    diagonals = np.zeros((2, 96, 300), bool)
    for y in range(96):
        for c in range(-96, 400, 9):
            if 0 <= y + c < 300:
                diagonals[0, y, y + c] = True
            if 0 <= c - y < 300:
                diagonals[1, y, c - y] = True
    base = dict(cc_cases(np))
    rng = np.random.default_rng(23)
    return [("corners_default", corners(2, 70, 300, 32, 128, 1), None),
            ("diagonals_default", diagonals, None),
            ("diagonals_16x64", diagonals, (16, 64)),
            ("corners_8x16", corners(2, 37, 75, 8, 16, 2), (8, 16)),
            ("spiral_4x8", base["spiral"][None], (4, 8)),
            ("serpentine_4x8", base["serpentine"][None], (4, 8)),
            ("serpentine_1x128", base["serpentine"][None], (1, 128)),
            ("random_8x16", rng.random((3, 70, 63)) > 0.45, (8, 16)),
            ("random_1x1", rng.random((2, 9, 7)) > 0.5, (1, 1)),
            ("row", rng.random((2, 1, 300)) > 0.3, None),
            ("column_7x1", rng.random((2, 300, 1)) > 0.3, (7, 1))]


def check_cc(torch, cc, cc_kernel, name, fg, seed, tile=None):
    """K3 against its plain version on one (B, H, W) or (H, W) CUDA mask:
    cc_label and cc_label_stats on the mask, propagate_min on random seeds
    over it; ``tile`` overrides the kernel's tile.  The stats table is
    compared where it is defined: at every pixel's root slot (each root, and
    each image's background slot).  Returns the max abs difference (0, or
    the run fails)."""
    got = cc_kernel.cc_label(fg, tile=tile)
    got_s, got_t = cc_kernel.cc_label_stats(fg, tile=tile)
    want = cc.cc_label(fg)
    want_t = cc_kernel.cc_label_stats_plain(fg)[1]
    size = fg.shape[-2] * fg.shape[-1]
    b = want.numel() // size
    slots = (want.reshape(b, size).long() + torch.arange(
        b, device=fg.device)[:, None] * (size + 1)).reshape(-1)
    g = torch.Generator(device=fg.device).manual_seed(seed)
    seeds = torch.randint(0, size, fg.shape, generator=g, device=fg.device,
                          dtype=torch.int32)
    init = torch.where(fg, seeds, size)
    got_p = cc_kernel.propagate_min(init, size, tile=tile)
    want_p = cc_kernel.propagate_min_plain(init, size)
    torch.cuda.synchronize()
    err = max((got.long() - want.long()).abs().max().item(),
              (got_s.long() - want.long()).abs().max().item(),
              (got_t[slots].long() - want_t[slots].long()).abs().max().item(),
              (got_p.long() - want_p.long()).abs().max().item())
    log({"phase": "cc_parity", "case": name, "shape": list(fg.shape),
         "tile": list(tile) if tile else None,
         "fg_share": fg.float().mean().item(),
         "components": int((want.reshape(-1, size) == torch.arange(
             size, device=fg.device)).sum().item()),
         "touching_border": int(cc_kernel.stats_touch(
             want_t[slots]).sum().item()),
         "max_abs_err": err})
    if err or got.dtype != torch.int32 or got.shape != fg.shape or \
            got_t.shape != (b * (size + 1),):
        raise AssertionError(f"cc kernel differs from its plain version on "
                             f"{name}: max abs err {err}")
    return err


def cc_bound_ms(fg, roots: int = 0) -> float:
    """A bool mask read once and the int32 labels written once; with the
    stats, also each of the ``roots`` stats slots written once (every
    component's root and each image's background slot)."""
    return (fg.numel() * 5 + roots * 4) / PEAK_HBM_BYTES * 1e3


def cc_roots(torch, cc_kernel, fg) -> int:
    """The stats slots this mask's labels define: its components, plus one
    background slot per image."""
    size = fg.shape[-2] * fg.shape[-1]
    lbl = cc_kernel.cc_label(fg).reshape(-1, size)
    return int((lbl == torch.arange(size, device=fg.device)).sum().item()
               ) + lbl.shape[0]


def compare_dirs(a, b, names):
    """The named files of two directories are byte-equal."""
    for f in names:
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{f}: {a} and {b} differ")


def run_batch(engine, paths, size, out_dir):
    """process_batch on ``paths``; returns its wall time in s."""
    t0 = time.perf_counter()
    ok, failed = engine.process_batch(paths, size, size,
                                      [out_dir] * len(paths), batch_size=128,
                                      tier="full")
    if (ok, failed) != (len(paths), 0):
        raise AssertionError(f"process_batch: {ok} ok, {failed} failed")
    return time.perf_counter() - t0


def check_launches(launches, forwards, k3_per_forward):
    if launches["conv3x3_bias_act"] != 6 * forwards or \
            launches["conv3x3_bias_act_small_c"] != 4 * forwards:
        raise AssertionError(f"{launches} launches over {forwards} forwards: "
                             f"want 10 conv per forward (6 + 4)")
    if launches["cc_label"] != k3_per_forward * forwards:
        raise AssertionError(f"{launches} launches over {forwards} forwards: "
                             f"want {k3_per_forward} cc_label per forward")


def k6_inputs(torch, n, h, w, c, k, device, seed, exact=False):
    """Operands of the fused last decoder level at its natural layouts, bf16.

    Random: ReLU'd normal activations, He-scaled weights.  ``exact``: 0/1
    activations, sparse {-1, 0, 1} weights and integer biases, so every f32
    sum in any order is exact, and head columns 0 and 1 equal, so classes 0
    and 1 tie exactly wherever they lead: kernel and plain version must then
    agree bit for bit, first-max rule included."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device)

    def ternary(*shape):  # {-1, 0, 1}, nonzero with probability 1/8
        u = torch.rand(shape, generator=g, device=device)
        return (u < 1 / 16).float() - (u > 15 / 16).float()

    if exact:
        x = (rand(n, h // 2, w // 2, 2 * c) > 0).float()
        skip = (rand(n, h, w, c) > 0).float()
        ops = [x, skip, ternary(2 * c, 4 * c), ternary(c), ternary(3, 3, 2 * c, c),
               ternary(c), ternary(3, 3, c, c), ternary(c),
               (rand(c, k) * 1.2).round().clamp(-1, 1), ternary(k)]
        ops[8][:, 1], ops[9][1] = ops[8][:, 0], ops[9][0]
    else:
        ops = [torch.relu(rand(n, h // 2, w // 2, 2 * c)),
               torch.relu(rand(n, h, w, c)), rand(2 * c, 4 * c) / (2 * c) ** 0.5,
               rand(c) * 0.1, rand(3, 3, 2 * c, c) * (2 / (18 * c)) ** 0.5,
               rand(c) * 0.1, rand(3, 3, c, c) * (2 / (9 * c)) ** 0.5,
               rand(c) * 0.1, rand(c, k) / c ** 0.5, rand(k) * 0.1]
    return [t.to(torch.bfloat16).contiguous() for t in ops]


def check_k6(torch, dec1, name, ops, exact=False):
    """K6 against its plain version: equal masks except near ties (bit for
    bit when ``exact``, with the plain version on the CPU, whose direct f32
    convs keep integer sums exact where cuDNN may pick a Winograd or FFT
    algorithm).  Returns the max abs class difference outside near ties."""
    got = dec1.dec1_fused_masks(*ops)
    torch.cuda.synchronize()
    want = dec1.dec1_fused_plain(*[t.cpu() if exact else t for t in ops]
                                 ).to(got.device)
    tie = dec1.near_tie(dec1.dec1_head_input_plain(*ops[:8]), ops[8], ops[9])
    differ = got != want
    outside = differ if exact else differ & ~tie
    err = int((got.int() - want.int()).abs()[outside].max().item()
              ) if outside.any() else 0
    k = ops[8].shape[1]
    log({"phase": "dec1_parity", "case": name, "shape": list(ops[1].shape),
         "classes": k, "differing_pixels": int(differ.sum()),
         "near_tie_pixels": int(tie.sum()), "bad_pixels": int(outside.sum()),
         "class_counts": torch.bincount(want.flatten().long(),
                                        minlength=k).tolist(),
         "max_abs_err": err})
    if err or got.shape != want.shape or got.dtype != torch.uint8:
        raise AssertionError(f"K6 differs from its plain version on {name}: "
                             f"{int(outside.sum())} pixels outside near ties")
    return err


def k6_bound(skip_shape, k):
    """(bound ms, flop ms, byte ms) of the fused level at skip (N, H, W, C):
    the up-GEMM, both convs and the head at the tensor-core peak; x, skip and
    the weights read once, the u8 classes written once."""
    n, h, w, c = skip_shape
    m = n * h * w
    flops = 2.0 * (m // 4 * 2 * c * 4 * c + m * 9 * 2 * c * c + m * 9 * c * c
                   + m * c * k)
    weights = 2 * c * 4 * c + 9 * 2 * c * c + 9 * c * c + c * k + 3 * c + k
    nbytes = 2.0 * (m // 4 * 2 * c + m * c + weights) + m
    f_ms = flops / PEAK_BF16_FLOPS * 1e3
    b_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return max(f_ms, b_ms), f_ms, b_ms


def centre_head_bias(torch, checkpoint, registry, native, raw_io, preprocess,
                     path, raw_paths, size, device):
    """Rewrite the head bias of the checkpoint at ``path`` to minus the
    median logit of each class on ``raw_paths``: seeded random weights then
    paint every class, so the masks have contours and every artifact is
    written."""
    import numpy as np

    params, cfg = checkpoint.load(path)
    u8 = np.stack([native.preprocess_u8(np.asarray(raw_io.read_raw(
        p, size, size)), cfg.image_size) for p in raw_paths])
    model = registry.build(params, cfg, device)
    with torch.inference_mode():
        logits = model(preprocess.model_input_from_u8(
            torch.from_numpy(u8).to(device))[..., None])
    params["head"]["b"] = -logits.reshape(-1, cfg.num_classes).median(
        0).values.cpu().numpy()
    checkpoint.save(path, params, cfg)


def flagship_checkpoint(torch, np, tmp, dev):
    """The flagship ``ModelConfig()`` in ``tmp``: seeded weights (seed 0),
    the head bias centred on four synthetic 768² RAWs' logits.  Returns
    (checkpoint path, the 768² RAW paths)."""
    from unetseg_tpu_torch import checkpoint
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import preprocess

    in_dir = os.path.join(tmp, "in")
    os.makedirs(in_dir, exist_ok=True)
    paths = write_raws(raw_io, synth_slice, np, in_dir, N_FLAGSHIP, 768)
    ckpt = os.path.join(tmp, "models", "flagship.ckpt")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    checkpoint.create(ckpt, ModelConfig(**FLAGSHIP_KW), seed=0)
    centre_head_bias(torch, checkpoint, registry, native, raw_io, preprocess,
                     ckpt, paths[:4], 768, dev)
    return ckpt, paths


def flagship(torch, np, F, dev, card):
    """Phases 8-10: the flagship's kernels and main path.  Returns the
    records of K6, K4 and K5 for the kernels line."""
    from unetseg_tpu_torch import checkpoint, engine, service
    from unetseg_tpu_torch.benchmarks import dec1_phases, exp_bw
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import (cc_kernel, conv, dec1, halo_copy,
                                       preprocess)
    from unetseg_tpu_torch.ops.decode import decode_mask

    def reset_launches():
        for mod in (conv, cc_kernel, dec1, halo_copy):
            mod.reset_launches()

    def read_launches():
        return {**conv.LAUNCHES, **dec1.LAUNCHES,
                "cc_label": sum(cc_kernel.LAUNCHES.values())}

    # -- 8. flagship parity ------------------------------------------------
    worst = check_parity(torch, conv, dev, FLAGSHIP_CONVS + [STEM2_CONV], 2)
    log({"phase": "flagship_conv_parity", "max_abs_err": worst})
    k6_err = 0
    for name, (n, h, w, c, k, seed), exact in K6_CASES:
        k6_err = max(k6_err, check_k6(torch, dec1, name, k6_inputs(
            torch, n, h, w, c, k, dev, seed, exact), exact))
    x_bw = torch.randn(exp_bw.SHAPE, device=dev).to(torch.bfloat16)
    for offset, name in halo_copy.NAMES.items():
        got = halo_copy.halo_copy(x_bw, exp_bw.H, exp_bw.W2, offset)
        same = torch.equal(got, halo_copy.halo_copy_plain(
            x_bw, exp_bw.H, exp_bw.W2, offset))
        log({"phase": "copy_parity", "kernel": name, "shape": list(x_bw.shape),
             "bit_equal": same})
        if not same:
            raise AssertionError(f"{name} differs from the slice")

    with tempfile.TemporaryDirectory() as tmp:
        size = 768
        ckpt, paths = flagship_checkpoint(torch, np, tmp, dev)

        # -- 9. flagship main path -------------------------------------------
        reset_launches()
        if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log")):
            raise AssertionError("initialize_engine(flagship) returned False")
        eng = engine.get_engine()
        out = os.path.join(tmp, "out")
        batch_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            ok, failed = engine.process_batch(
                paths, size, size, [out] * N_FLAGSHIP,
                batch_size=FLAGSHIP_BATCH, tier="full")
            batch_s.append(time.perf_counter() - t0)
            if (ok, failed) != (N_FLAGSHIP, 0):
                raise AssertionError(f"process_batch: {ok} ok, {failed} failed")
        single = os.path.join(tmp, "single")
        t0 = time.perf_counter()
        if not engine.process_single_image(paths[3], size, size, single):
            raise AssertionError("process_single_image returned False")
        single_s = time.perf_counter() - t0
        for p in paths:
            check_artifacts(out, os.path.basename(p)[:-len(".raw")])
        check_artifacts(single, "slice_003")

        # Two slices on the card and on the CPU (plain convs, plain K6).
        u8_2 = torch.from_numpy(np.stack([native.preprocess_u8(np.asarray(
            raw_io.read_raw(p, size, size)), 512) for p in paths[:2]]))
        got = eng._masks(u8_2.to(dev)).cpu()
        launches = read_launches()
        forwards = eng.forwards
        params, cfg = checkpoint.load(ckpt)
        cpu_model = registry.build(params, cfg, device="cpu")
        x2 = preprocess.model_input_from_u8(u8_2)[..., None]
        with torch.inference_mode():
            want = cpu_model.masks(x2)
            trunk_cpu = cpu_model._trunk(x2)
            trunk_dev = [t.cpu() for t in eng.model._trunk(x2.to(dev))]
            head = (cpu_model.head_weight, cpu_model.head_bias)
            last = cpu_model.decoder[-1]
            weights = (last.up.weight, last.up.bias, last.conv1.weight,
                       last.conv1.bias, last.conv2.weight, last.conv2.bias)
            # K6 alone on real data: the card's masks against the plain
            # version run on the card's own trunk output.
            want_k6 = dec1.dec1_fused_plain(*trunk_dev, *weights, *head)
            tie_k6 = dec1.near_tie(dec1.dec1_head_input_plain(
                *trunk_dev, *weights), *head)
            c2_cpu = dec1.dec1_head_input_plain(*trunk_cpu, *weights)
        differ = got != want
        k6_bad = int(((got != want_k6) & ~tie_k6).sum())
        ratio = near_tie_ulps(dec1, differ, c2_cpu, *head)
        agree = 1 - differ.float().mean().item()
        trunk_dev_rel = max(((a.float() - b.float()).abs().max() /
                             b.float().abs().max()).item()
                            for a, b in zip(trunk_dev, trunk_cpu))
        log({"phase": "flagship_main_path", "config": "ModelConfig()",
             "process_batch_64_s": batch_s, "process_single_image_s": single_s,
             "forwards": forwards, "launches": launches,
             "artifacts": len(os.listdir(out)),
             "cpu_mask_agreement": agree,
             "differing_pixels_within_ulps": ratio or None,
             "k6_on_device_trunk_bad_pixels": k6_bad,
             "k6_on_device_trunk_differing": int((got != want_k6).sum()),
             "trunk_max_rel_dev": trunk_dev_rel,
             "class_share": (torch.bincount(got.flatten().long(), minlength=3)
                             / got.numel()).tolist(), **card})
        want_l = {"conv3x3_bias_act": 13, "conv3x3_bias_act_small_c": 3,
                  "dec1_fused": 1, "cc_label": 0}
        if any(launches[k] != v * forwards for k, v in want_l.items()):
            raise AssertionError(f"{launches} over {forwards} forwards: want "
                                 f"{want_l} per forward")
        if len(os.listdir(out)) != 5 * N_FLAGSHIP:
            raise AssertionError("flagship: not five artifacts per slice")
        if k6_bad:
            raise AssertionError(f"K6 on the card's trunk output differs from "
                                 f"its plain version at {k6_bad} pixels "
                                 f"outside near ties")
        # Seeded random weights with a centred head leave many pixels near a
        # tie, and the 16 convs before K6 each sum in another order on the
        # card than on the CPU: the two may part only at such pixels.
        if agree < CPU_AGREEMENT or not ratio or ratio > CPU_TIE_ULPS:
            raise AssertionError(f"flagship device vs CPU masks agree on "
                                 f"{agree} (bar {CPU_AGREEMENT}); differing "
                                 f"pixels within {ratio or '>64'} ulps (bar "
                                 f"{CPU_TIE_ULPS})")
        main_launches = launches

        svc = service.SegmentationService(port=0)
        addr = svc.start()
        try:
            for req in ({"cmd": "init", "cache": ckpt},
                        {"cmd": "process", "path": paths[-1], "width": size,
                         "height": size,
                         "output_dir": os.path.join(tmp, "svc_one")},
                        {"cmd": "shutdown"}):
                resp = service.request(addr, req, timeout=300)
                log({"phase": "flagship_service", "cmd": req["cmd"],
                     "resp": resp})
                if not resp.get("ok"):
                    raise AssertionError(f"service {req['cmd']}: {resp}")
        finally:
            svc.stop()
        check_artifacts(os.path.join(tmp, "svc_one"),
                        os.path.basename(paths[-1])[:-len(".raw")])

        # -- 10. flagship numbers ----------------------------------------------
        eng = engine.InferenceEngine(params, cfg)
        u8_32 = torch.from_numpy(np.stack([native.preprocess_u8(np.asarray(
            raw_io.read_raw(p, size, size)), 512)
            for p in paths[:FLAGSHIP_BATCH]])).to(dev)
    pipe_ms = time_ms(torch, lambda: eng._pipeline(u8_32), 10)
    log({"phase": "flagship_throughput", "batch": FLAGSHIP_BATCH,
         "ms_per_batch": pipe_ms,
         "slices_per_s": FLAGSHIP_BATCH / pipe_ms * 1e3, **card})
    prof = profile_pipeline(torch, lambda: eng._pipeline(u8_32))
    del prof["ops"]
    log({"phase": "flagship_profile", **prof, **card})

    for i, shape in enumerate(FLAGSHIP_CONVS):
        x, w, b = conv_inputs(torch, shape, FLAGSHIP_BATCH, dev, seed=400 + i)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        k_ms = time_ms(torch, lambda: conv.conv3x3_bias_act(x, w, b), 5)
        lib_ms = time_ms(torch, lambda: F.conv2d(xc, wc, b, padding=1), 5)
        bound, f_ms, b_ms = conv_bound(shape, FLAGSHIP_BATCH)
        log({"phase": "flagship_conv_time", "shape": [FLAGSHIP_BATCH, *shape],
             "variant": variant(shape[2]), "ms": k_ms, "library_ms": lib_ms,
             "bound_ms": bound, "flop_ms": f_ms, "byte_ms": b_ms, **card})
        del x, w, b, xc, wc

    # K6 on the real last-level inputs of a batch.
    model = eng.model
    last = model.decoder[-1]
    with torch.inference_mode():
        xin, skip = model._trunk(preprocess.model_input_from_u8(u8_32)[..., None])
    ops = [xin, skip, last.up.weight, last.up.bias, last.conv1.weight,
           last.conv1.bias, last.conv2.weight, last.conv2.bias,
           model.head_weight, model.head_bias]
    k6_err = max(k6_err, check_k6(torch, dec1, "flagship_b32", ops))
    hw, hb = model.head_weight, model.head_bias
    xc_w1 = last.conv1.weight.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    xc_w2 = last.conv2.weight.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def unfused():  # the port's own ops: UpConv, cat, K1, K2, head, argmax
        return decode_mask(last(xin, skip) @ hw + hb, 3)

    def library():  # cuBLAS up-conv and head, cuDNN convs
        y = torch.cat([skip, last.up(xin)], -1).permute(0, 3, 1, 2)
        y = torch.relu(F.conv2d(y, xc_w1, last.conv1.bias, padding=1))
        y = torch.relu(F.conv2d(y, xc_w2, last.conv2.bias, padding=1))
        return decode_mask(y.permute(0, 2, 3, 1) @ hw + hb, 3)

    with torch.inference_mode():
        lib_agree = (library() == dec1.dec1_fused_masks(*ops)).float().mean()
        k6_ms = time_ms(torch, lambda: dec1.dec1_fused_masks(*ops), 10)
        plain_ms = time_ms(torch, lambda: dec1.dec1_fused_plain(*ops), 3,
                           warmup=1)
        unfused_ms = time_ms(torch, unfused, 10)
        library_ms = time_ms(torch, library, 10)
    bound, f_ms, b_ms = k6_bound(skip.shape, 3)
    log({"phase": "dec1_time", "shape": list(skip.shape), "ms": k6_ms,
         "bound_ms": bound, "share_of_bound": bound / k6_ms,
         "flop_ms": f_ms, "byte_ms": b_ms,
         "plain_ms": plain_ms, "port_unfused_sequence_ms": unfused_ms,
         "library_sequence_ms": library_ms,
         "library_sequence_mask_agreement": lib_agree.item(),
         "tflops": f_ms * PEAK_BF16_FLOPS / 1e12 / k6_ms, **card})
    # Every C the kernel takes, at B = 32, 512² on random operands (the
    # flagship serves C = 64; the others must be right, not fast).
    for c in dec1.KERNEL_CHANNELS:
        ops_c = k6_inputs(torch, FLAGSHIP_BATCH, 512, 512, c, 3, dev, 500 + c)
        c_ms = time_ms(torch, lambda: dec1.dec1_fused_masks(*ops_c), 5)
        c_bound = k6_bound(ops_c[1].shape, 3)[0]
        log({"phase": "dec1_time_per_c", "C": c,
             "shape": list(ops_c[1].shape), "ms": c_ms, "bound_ms": c_bound,
             "share_of_bound": c_bound / c_ms, **card})
        del ops_c
    log({"phase": "dec1_phases", **dec1_phases.run(), **card})
    k6_record = {
        "name": "dec1_fused", "route": "cuda", "source": DEC1_SOURCE,
        "replaces": REPLACES["dec1_fused"],
        "launches": main_launches["dec1_fused"], "max_abs_err": k6_err,
        "ms": k6_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if f_ms >= b_ms else "bytes",
        "library_ms": None}
    del xin, skip, ops, u8_32, eng, model
    torch.cuda.empty_cache()

    records = [k6_record]
    copy_bound = exp_bw.bound_ms()
    copy_times = {}
    for offset, name in halo_copy.NAMES.items():
        k_ms = time_ms(torch, lambda: halo_copy.halo_copy(
            x_bw, exp_bw.H, exp_bw.W2, offset), 20)
        # The plain version, the slice made contiguous, is also the one
        # PyTorch call that computes the copy: one time serves both.
        lib_ms = time_ms(torch, lambda: halo_copy.halo_copy_plain(
            x_bw, exp_bw.H, exp_bw.W2, offset), 20)
        copy_times[name] = (k_ms, lib_ms)
        log({"phase": "copy_time", "kernel": name, "ms": k_ms,
             "gb_per_s": exp_bw.moved_bytes() / k_ms / 1e6,
             "plain_ms": lib_ms, "library_ms": lib_ms,
             "bound_ms": copy_bound, **card})
    reset_launches()
    if exp_bw.main() != 0:
        raise AssertionError("exp_bw.main() failed")
    probe_launches = dict(halo_copy.LAUNCHES)
    log({"phase": "exp_bw", "launches": probe_launches})
    for offset, name in halo_copy.NAMES.items():
        if not probe_launches[name]:
            raise AssertionError(f"exp_bw.main() never launched {name}")
        k_ms, lib_ms = copy_times[name]
        records.append({
            "name": name, "route": "cuda", "source": COPY_SOURCE,
            "replaces": REPLACES[name], "launches": probe_launches[name],
            "max_abs_err": 0, "ms": k_ms, "plain_ms": lib_ms,
            "bound_ms": copy_bound, "bound_by": "bytes", "library_ms": lib_ms})
    return records


def near_tie_ulps(dec1, differ, c2, wh, bh):
    """The fewest bf16 ulps of the absolute head sum (``dec1.near_tie``'s
    measure) within which every differing pixel lies, or None past 64."""
    return fewest_ulps(differ, lambda r: dec1.near_tie(c2, wh, bh, ulps=r))


def fewest_ulps(differ, tie):
    """The fewest ulps r in 1, 2, 4, ..., 64 with every differing pixel
    inside ``tie(r)``, or None past 64."""
    for r in (1, 2, 4, 8, 16, 32, 64):
        if not (differ & ~tie(r)).any():
            return r
    return None


def head_sums(torch, model, x):
    """(logits, absolute head sums), both (N, H, W, K) float32, of
    ``UNet.forward`` on NHWC ``x``: the logits by the forward's own ops, the
    sums |c2|.|wh| + |bh| (``dec1.near_tie``'s measure) in f32, both through
    depth-to-space for a stem-s model."""
    from unetseg_tpu_torch.models.unet import depth_to_space

    c2 = model.decoder[-1](*model._trunk(x))
    logits = c2 @ model.head_weight + model.head_bias
    absum = (c2.float().abs() @ model.head_weight.float().abs()
             + model.head_bias.float().abs())
    if model.cfg.stem > 1:
        logits = depth_to_space(logits, model.cfg.stem)
        absum = depth_to_space(absum, model.cfg.stem)
    return logits.float(), absum


def tta_sums(torch, tta, models, x):
    """Mean (logits, absolute head sums) of the 8-fold ensemble on one
    NHWC slice ``x`` (1, H, W, 1): weight space when ``models`` holds the 8
    variants, activation space (views of ``x`` through one model)
    otherwise."""
    lg = ab = 0
    for k in range(tta.N_TRANSFORMS):
        if isinstance(models, list):
            l_k, a_k = head_sums(torch, models[k], x)
        else:
            l_k, a_k = head_sums(torch, models, tta.dihedral(x[0], k)[None])
            l_k = tta.dihedral_inverse(l_k[0], k)[None]
            a_k = tta.dihedral_inverse(a_k[0], k)[None]
        lg, ab = lg + l_k, ab + a_k
    return lg / tta.N_TRANSFORMS, ab / tta.N_TRANSFORMS


def tiled_sums(torch, tiles, model, u8, window):
    """Blended (logits, absolute head sums) (H, W, K) of sliding windows of
    ``window`` at the default overlap over ``u8`` (H, W), by chunks."""
    stride = window - window // 2
    h, w = u8.shape
    x = tiles.extract_windows(u8, window, stride)[..., None].float() / 255.0
    parts = [head_sums(torch, model, x[i:i + tiles.MODEL_CHUNK])
             for i in range(0, x.shape[0], tiles.MODEL_CHUNK)]
    return tuple(tiles.blend_windows(torch.cat(p), h, w, window, stride)
                 for p in zip(*parts))


def check_config(torch, np, name, cfg, x, dev, card, seed=7):
    """One seeded model on the card against the CPU path: ``UNet.masks`` on
    ``x`` (NHWC, on the CPU) with the head bias centred on the card's
    logits; equal masks but for near ties, no K6 launch where the route is
    unfused, and the conv kernel once per 3x3 conv."""
    from unetseg_tpu_torch.models import registry, unet
    from unetseg_tpu_torch.ops import conv, dec1

    params = unet.init(cfg, torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        logits = registry.build(params, cfg, dev)(x.to(dev))
    params["head"]["b"] = -logits.reshape(-1, cfg.num_classes).median(
        0).values.cpu().numpy()
    model = registry.build(params, cfg, dev)
    cpu_model = registry.build(params, cfg, "cpu")
    conv.reset_launches()
    dec1.reset_launches()
    with torch.inference_mode():
        got = model.masks(x.to(dev)).cpu()
        launches = {**conv.LAUNCHES, **dec1.LAUNCHES}
        want = cpu_model.masks(x)
        c2 = cpu_model.decoder[-1](*cpu_model._trunk(x))
    differ = got != want
    ratio = near_tie_ulps(dec1, differ, c2, cpu_model.head_weight,
                          cpu_model.head_bias)
    agree = 1 - differ.float().mean().item()
    convs = 4 * cfg.depth + 2
    log({"phase": "config", "config": name, "route": model.route,
         "shape": list(x.shape), "launches": launches,
         "cpu_mask_agreement": agree, "differing_pixels_within_ulps": ratio,
         "classes_seen": int(torch.unique(got).numel()), **card})
    if model.route != "unfused" or launches["dec1_fused"] or \
            sum(v for k, v in launches.items() if k != "dec1_fused") != convs:
        raise AssertionError(f"{name}: route {model.route}, {launches}: want "
                             f"the unfused route, {convs} convs, no K6")
    if agree < CONFIG_AGREEMENT or not ratio or ratio > CPU_TIE_ULPS:
        raise AssertionError(f"{name}: card vs CPU masks agree on {agree}, "
                             f"differing pixels within {ratio} ulps")
    return params


def configs(torch, np, dev, card):
    """Phase 11: configs the card used to refuse.  A stem-1 base-128 model
    and the 12-class stem-1 model of benchmarks/exp_slim_arch.py (4 input
    channels: a space-to-depth of the slice) through ``UNet.masks``; a
    base-8 model (D = 8 padded to 16) through ``UNet.masks`` and served by
    the engine; a float32 model refused by ``initialize_engine`` with its
    reason in the log."""
    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import unet
    from unetseg_tpu_torch.ops import conv, dec1, preprocess

    rng = np.random.default_rng(31)
    raws = [synth_slice(rng, 768)[0] for _ in range(CONFIG_BATCH)]

    def inputs(size):
        u8 = np.stack([native.preprocess_u8(r, size) for r in raws])
        return preprocess.model_input_from_u8(torch.from_numpy(u8))[..., None]

    check_config(torch, np, "stem1_base128", ModelConfig(base_channels=128),
                 inputs(256), dev, card)
    check_config(torch, np, "stem1_in4_classes12",
                 ModelConfig(in_channels=4, num_classes=12),
                 unet.space_to_depth(inputs(512), 2), dev, card)
    base8 = ModelConfig(base_channels=8)
    params = check_config(torch, np, "stem1_base8", base8, inputs(512), dev,
                          card)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "models", "base8.ckpt")
        os.makedirs(os.path.dirname(ckpt))
        checkpoint.save(ckpt, params, base8)
        paths = []
        for i, r in enumerate(raws):
            paths.append(os.path.join(tmp, f"slice_{i:03d}.raw"))
            raw_io.write_raw(paths[-1], r)
        conv.reset_launches()
        dec1.reset_launches()
        if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log")):
            raise AssertionError("initialize_engine(base 8) returned False")
        eng = engine.get_engine()
        out = os.path.join(tmp, "out")
        ok, failed = engine.process_batch(paths, 768, 768, [out] * len(paths),
                                          batch_size=CONFIG_BATCH)
        launches = {**conv.LAUNCHES, **dec1.LAUNCHES}
        log({"phase": "config_served", "config": "stem1_base8",
             "processed": ok, "failed": failed, "forwards": eng.forwards,
             "launches": launches, "artifacts": len(os.listdir(out))})
        if (ok, failed) != (len(paths), 0) or launches["dec1_fused"] or \
                launches["conv3x3_bias_act_small_c"] + launches[
                    "conv3x3_bias_act"] != (4 * base8.depth + 2) * eng.forwards:
            raise AssertionError("base-8 model: not served through the conv "
                                 "kernel alone")
        engine.cleanup_resources()

        f32 = os.path.join(tmp, "models", "f32.ckpt")
        f32_cfg = ModelConfig(base_channels=16, depth=1,
                              compute_dtype="float32")
        checkpoint.create(f32, f32_cfg, seed=0)
        log_dir = os.path.join(tmp, "log_f32")
        refused = not engine.initialize_engine(f32, log_dir=log_dir)
        engine.cleanup_resources()
        with open(os.path.join(log_dir, "segmentation_log.txt")) as f:
            reason = [line.strip() for line in f if "error" in line]
        log({"phase": "config_f32", "refused": refused, "reason": reason})
        if not refused or not any("ROADMAP.md" in r for r in reason):
            raise AssertionError(f"float32 on CUDA: refused {refused}, "
                                 f"reason {reason}")


def reset_all_launches():
    from unetseg_tpu_torch.ops import cc_kernel, conv, dec1

    for mod in (conv, cc_kernel, dec1):
        mod.reset_launches()


def all_launches() -> dict:
    from unetseg_tpu_torch.ops import cc_kernel, conv, dec1

    return {**conv.LAUNCHES, **dec1.LAUNCHES,
            "cc_label": sum(cc_kernel.LAUNCHES.values())}


@contextlib.contextmanager
def plain_convs():
    """The UNet's 3x3 convs through the conv's plain version (a float32
    conv, one cast) on any device: the reference that the TTA and window
    paths are held against, on the CPU for slim4 and on the card for the
    flagship."""
    from unetseg_tpu_torch.models import unet
    from unetseg_tpu_torch.ops import conv

    saved = unet.conv3x3_bias_act
    unet.conv3x3_bias_act = conv.conv3x3_bias_act_plain
    try:
        yield
    finally:
        unet.conv3x3_bias_act = saved


def convs_per_forward(model) -> dict:
    """Conv kernel launches of one ``UNet.forward`` by variant: every 3x3
    conv, the last level's included (the logits path takes no K6)."""
    from unetseg_tpu_torch.models.unet import Conv3x3

    out = {"conv3x3_bias_act": 0, "conv3x3_bias_act_small_c": 0}
    for m in model.modules():
        if isinstance(m, Conv3x3):
            out[variant(m.weight.shape[2])] += 1
    return out


def check_mode_launches(what, launches, passes, per_forward, device_post):
    """A served image's launches: ``passes`` forwards of ``per_forward``
    convs, no K6, and the device cleanup's 2 K3 calls when it runs."""
    want = {k: v * passes for k, v in per_forward.items()}
    want.update(dec1_fused=0, cc_label=2 if device_post else 0)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")


def serve_one(engine, ckpt, tmp, tag, raw_path, w, h, device_post, **kw):
    """``process_single_image(raw_path, **kw)`` on a fresh engine (host or
    device cleanup), with the counters set to 0 just before it.  Returns
    (out dir, its artifact names, launches, model passes, wall s)."""
    if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log"),
                                    device_postprocess=device_post):
        raise AssertionError(f"{tag}: initialize_engine returned False")
    eng = engine.get_engine()
    out = os.path.join(tmp, f"{tag}_{'device' if device_post else 'host'}")
    reset_all_launches()
    before = eng.forwards
    t0 = time.perf_counter()
    if not engine.process_single_image(raw_path, w, h, out, **kw):
        raise AssertionError(f"{tag}: process_single_image({kw}) failed")
    wall = time.perf_counter() - t0
    launches, passes = all_launches(), eng.forwards - before
    engine.cleanup_resources()
    return out, sorted(os.listdir(out)), launches, passes, wall


def preprocess_device(torch, np, dev, card):
    """Phase 12: the device preprocess on the card, bit-equal to the same
    functions on the CPU."""
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.ops import preprocess

    rng = np.random.default_rng(41)
    h, w = TILED_RAW
    raws = {"random_768": rng.integers(0, 65536, (768, 768), np.uint16),
            f"synth_{h}x{w}": synth_slice(rng, max(h, w))[0][:h, :w],
            "constant_768": np.full((768, 768), 1234, np.uint16)}
    for name, raw in raws.items():
        host = torch.from_numpy(raw)
        on_card = host.to(dev)
        for fn in (preprocess.normalize_u8, preprocess.resize_normalize_u8):
            got = fn(on_card).cpu()
            want = fn(host)
            differing = int((got != want).sum()) if got.shape == want.shape \
                else -1
            log({"phase": "preprocess_device", "image": name,
                 "fn": fn.__name__, "shape": list(raw.shape),
                 "out_shape": list(got.shape), "differing": differing,
                 "ms": time_ms(torch, lambda: fn(on_card), 10), **card})
            if differing or got.dtype != torch.uint8:
                raise AssertionError(f"{fn.__name__} on {name}: the card "
                                     f"differs from the CPU ({differing})")


def tta_phase(torch, np, name, ckpt, raw_path, tmp, dev, card, ref_dev):
    """Phase 13 for one model: ``process_single_image(tta=True)`` with host
    and with device cleanup; weight-space against activation-space masks on
    the card; the card against the plain convs on ``ref_dev``; times (the
    first call's with the 8 variants' build)."""
    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.ops import dec1, preprocess
    from unetseg_tpu_torch.ops.decode import decode_mask
    from unetseg_tpu_torch.parallel import tta

    params, cfg = checkpoint.load(ckpt)
    eng = engine.InferenceEngine(params, cfg, dev)
    per_forward = convs_per_forward(eng.model)
    served = {}
    for device_post in (False, True):
        out, names, launches, passes, wall = serve_one(
            engine, ckpt, tmp, f"{name}_tta", raw_path, TTA_RAW, TTA_RAW,
            device_post, tta=True)
        log({"phase": "tta", "model": name,
             "cleanup": "device" if device_post else "host",
             "passes": passes, "launches": launches,
             "convs_per_forward": per_forward, "artifacts": names,
             "process_single_image_s": wall, **card})
        if passes != tta.N_TRANSFORMS:
            raise AssertionError(f"{name} tta: {passes} passes, want 8")
        check_mode_launches(f"{name} tta", launches, passes, per_forward,
                            device_post)
        check_artifacts(out, os.path.basename(raw_path)[:-len(".raw")])
        served[device_post] = (out, names)
    if served[False][1] != served[True][1]:
        raise AssertionError(f"{name} tta: host and device cleanup wrote "
                             f"different artifact sets")
    compare_dirs(served[False][0], served[True][0], served[False][1])

    u8 = native.preprocess_u8(np.asarray(raw_io.read_raw(
        raw_path, TTA_RAW, TTA_RAW)), cfg.image_size)
    u8_d = torch.from_numpy(u8).to(dev)
    variants = tta.weight_variants(params, cfg, dev)
    act_pipe = tta.make_tta_pipeline(eng.model, device_postprocess=False)
    x = preprocess.model_input_from_u8(u8_d)[None, ..., None]
    t0 = time.perf_counter()
    with torch.inference_mode():
        ws = eng.infer_tta(u8).cpu()
    first_call_ms = (time.perf_counter() - t0) * 1e3
    with torch.inference_mode():
        act = act_pipe(u8_d).cpu()
        lg, ab = tta_sums(torch, tta, variants, x)
    lg, ab = lg[0].cpu(), ab[0].cpu()
    if not torch.equal(decode_mask(lg, cfg.num_classes), ws):
        raise AssertionError(f"{name} tta: the engine's masks are not the "
                             f"argmax of the variants' mean logits")
    differ = ws != act
    ulps = fewest_ulps(differ, lambda r: dec1.near_tie_sums(lg, ab, r))
    record = {"phase": "tta_forms", "model": name,
              "ws_vs_act_differing": int(differ.sum()),
              "ws_vs_act_within_ulps": ulps,
              "class_share": (torch.bincount(ws.flatten().long(),
                                             minlength=cfg.num_classes)
                              / ws.numel()).tolist()}
    if ulps is None or ulps > CPU_TIE_ULPS:
        log(record)
        raise AssertionError(f"{name} tta: weight- and activation-space "
                             f"masks part outside {CPU_TIE_ULPS} ulps")
    ref = engine.InferenceEngine(params, cfg, ref_dev)
    with plain_convs(), torch.inference_mode():
        ref_masks = ref.infer_tta(u8).cpu()
        lg_r, ab_r = tta_sums(torch, tta, tta.weight_variants(
            params, cfg, ref_dev), x.to(ref_dev))
    differ = ws != ref_masks
    agree = 1 - differ.float().mean().item()
    ref_ulps = fewest_ulps(differ, lambda r: dec1.near_tie_sums(
        lg_r[0].cpu(), ab_r[0].cpu(), r))
    record.update(reference=f"plain convs on {ref_dev}",
                  reference_mask_agreement=agree,
                  reference_differing_within_ulps=ref_ulps)
    log(record)
    if agree < CPU_AGREEMENT or ref_ulps is None or ref_ulps > CPU_TIE_ULPS:
        raise AssertionError(f"{name} tta: card vs plain convs on {ref_dev} "
                             f"agree on {agree}, within {ref_ulps} ulps")
    del ref, lg_r, ab_r

    u8_1 = u8_d[None]
    with torch.inference_mode():
        times = {"weight_space_ms": time_ms(torch, lambda: eng._tta(u8_1), 10),
                 "activation_space_ms": time_ms(torch, lambda: act_pipe(u8_d),
                                                10),
                 "plain_slice_ms": time_ms(torch, lambda: eng._pipeline(u8_1),
                                           10)}
    log({"phase": "tta_time", "model": name, "shape": list(u8.shape),
         "weight_space_first_call_ms": first_call_ms, **times, **card})
    del eng, variants, act_pipe
    torch.cuda.empty_cache()


def tiled_phase(torch, np, name, ckpt, tmp, dev, card, ref_dev):
    """Phase 14 for one model: ``process_single_image(window=...)`` on the
    regular grid, the irregular one and the padded image, with host and
    with device cleanup; K3 on the native-size and cropped masks; the card
    against the plain convs on ``ref_dev`` (on the card: TILED_RAW, whose
    windows pass at batches 32 and 3); times."""
    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.ops import (cc, cc_kernel, dec1, morphology,
                                       postprocess, preprocess)
    from unetseg_tpu_torch.ops.decode import decode_mask
    from unetseg_tpu_torch.parallel import tiles

    params, cfg = checkpoint.load(ckpt)
    eng = engine.InferenceEngine(params, cfg, dev)
    per_forward = convs_per_forward(eng.model)
    rng = np.random.default_rng(43)
    raws = {}
    ref_hw = TILED_CPU_RAW if str(ref_dev) == "cpu" else TILED_RAW
    for tag, (h, w) in (("big", TILED_RAW), ("small", SMALL_RAW),
                        ("ref", ref_hw)):
        raws[tag] = (os.path.join(tmp, f"{name}_{tag}.raw"), h, w)
        raw_io.write_raw(raws[tag][0],
                         synth_slice(rng, max(h, w))[0][:h, :w])
    u8s = {tag: preprocess.normalize_u8(torch.from_numpy(np.asarray(
        raw_io.read_raw(p, w, h))).to(dev)) for tag, (p, h, w) in raws.items()}

    def plan(tag, overlap):
        """(window, stride, windows) of ``infer_tiled`` on ``raws[tag]``."""
        h, w = u8s[tag].shape
        window, ov = eng.tile_window(h, w, TILED_WINDOW, overlap)
        padded = tiles._pad_to_window(u8s[tag], window)[0]
        return window, window - ov, tiles.extract_windows(
            padded, window, window - ov).shape[0]

    cases = (("regular", "big", None), ("irregular", "big", IRREGULAR_OVERLAP),
             ("padded", "small", None))
    for case, tag, overlap in cases:
        path, h, w = raws[tag]
        window, stride, n_windows = plan(tag, overlap)
        served = {}
        for device_post in (False, True):
            out, names, launches, passes, wall = serve_one(
                engine, ckpt, tmp, f"{name}_{case}", path, w, h, device_post,
                window=TILED_WINDOW, overlap=overlap)
            log({"phase": "tiled", "model": name, "case": case,
                 "image": [h, w], "window": window, "stride": stride,
                 "windows": n_windows,
                 "cleanup": "device" if device_post else "host",
                 "passes": passes, "launches": launches, "artifacts": names,
                 "process_single_image_s": wall, **card})
            if passes != -(-n_windows // tiles.MODEL_CHUNK):
                raise AssertionError(f"{name} {case}: {passes} passes for "
                                     f"{n_windows} windows")
            check_mode_launches(f"{name} {case}", launches, passes,
                                per_forward, device_post)
            base = os.path.basename(path)[:-len(".raw")]
            with open(os.path.join(out, base + "_original_sizes.json")) as f:
                sizes = json.load(f)[os.path.basename(path)]
            if (sizes["scaled_width"], sizes["scaled_height"]) != (w, h) or \
                    len(names) < 3:
                raise AssertionError(f"{name} {case}: {names}, sizes {sizes}")
            served[device_post] = (out, names)
        if served[False][1] != served[True][1]:
            raise AssertionError(f"{name} {case}: host and device cleanup "
                                 f"wrote different artifact sets")
        compare_dirs(served[False][0], served[True][0], served[False][1])

    # K3 on what window mode feeds it: the native-size and cropped masks.
    cc_err = 0
    for tag in ("big", "small"):
        masks = eng.infer_tiled(u8s[tag], TILED_WINDOW)[None]
        inv = masks != postprocess.FOREGROUND_VALUE
        opened = morphology.open_(~inv, postprocess.MORPH_KERNEL_SIZE)
        for kind, fg, seed in (("inverse", inv, 360), ("opened_fg", opened,
                                                       361)):
            cc_err = max(cc_err, check_cc(torch, cc, cc_kernel,
                                          f"{name}_tiled_{tag}_{kind}", fg,
                                          seed))
    path, h, w = raws["ref"]
    got = eng.infer_tiled(u8s["ref"], TILED_WINDOW).cpu()
    u8_r = u8s["ref"].to(ref_dev)
    ref = engine.InferenceEngine(params, cfg, ref_dev)
    with plain_convs():
        want = ref.infer_tiled(u8_r, TILED_WINDOW).cpu()
        with torch.inference_mode():
            lg, ab = tiled_sums(torch, tiles, ref.model, u8_r, TILED_WINDOW)
    lg, ab = lg.cpu(), ab.cpu()
    if not torch.equal(decode_mask(lg, cfg.num_classes), want):
        raise AssertionError(f"{name} tiled: the reference masks are not the "
                             f"argmax of the blended logits")
    differ = got != want
    agree = 1 - differ.float().mean().item()
    ulps = fewest_ulps(differ, lambda r: dec1.near_tie_sums(lg, ab, r))
    log({"phase": "tiled_reference", "model": name, "image": [h, w],
         "reference": f"plain convs on {ref_dev}", "passes": ref.forwards,
         "reference_mask_agreement": agree, "differing_within_ulps": ulps})
    if agree < CPU_AGREEMENT or ulps is None or ulps > CPU_TIE_ULPS:
        raise AssertionError(f"{name} tiled: card vs plain convs on {ref_dev} "
                             f"agree on {agree}, within {ulps} ulps")
    del ref, lg, ab

    # Where a 2048 x 1536 image's time goes, by CUDA events.
    path, h, w = raws["big"]
    raw_d = torch.from_numpy(np.asarray(raw_io.read_raw(path, w, h))).to(dev)
    u8 = u8s["big"]
    eng_dev = engine.InferenceEngine(params, cfg, dev, device_postprocess=True)
    window, stride, n_windows = plan("big", None)
    _, i_stride, i_windows = plan("big", IRREGULAR_OVERLAP)
    with torch.inference_mode():
        lt = tiles._window_logits(eng.model, u8, window, stride)
        lt_i = tiles._window_logits(eng.model, u8, window, i_stride)
        logits = tiles.blend_windows(lt, h, w, window, stride)
        mask = decode_mask(logits, cfg.num_classes)
        times = {
            "preprocess_ms": time_ms(torch, lambda: preprocess.normalize_u8(
                raw_d), 5),
            "model_ms": time_ms(torch, lambda: tiles._window_logits(
                eng.model, u8, window, stride), 3),
            "blend_ms": time_ms(torch, lambda: tiles.blend_windows(
                lt, h, w, window, stride), 5),
            "irregular_blend_ms": time_ms(torch, lambda: tiles.blend_windows(
                lt_i, h, w, window, i_stride), 5),
            "argmax_ms": time_ms(torch, lambda: decode_mask(
                logits, cfg.num_classes), 5),
            "device_cleanup_ms": time_ms(
                torch, lambda: postprocess.postprocess_masks(mask[None]), 5),
            "pipeline_host_cleanup_ms": time_ms(
                torch, lambda: eng.infer_tiled(u8, TILED_WINDOW), 3),
            "pipeline_device_cleanup_ms": time_ms(
                torch, lambda: eng_dev.infer_tiled(u8, TILED_WINDOW), 3)}
    mask_np = mask[None].cpu().numpy()
    t0 = time.perf_counter()
    native.postprocess_batch(mask_np)
    times["host_cpp_cleanup_ms"] = (time.perf_counter() - t0) * 1e3
    log({"phase": "tiled_time", "model": name, "image": [h, w],
         "window": window, "windows": n_windows, "stride": stride,
         "irregular_windows": i_windows, "irregular_stride": i_stride,
         "passes": -(-n_windows // tiles.MODEL_CHUNK), **times, **card})
    del eng, eng_dev, lt, lt_i, logits
    torch.cuda.empty_cache()
    return cc_err


def tta_and_windows(torch, np, dev, card):
    """Phases 12-14: the device preprocess, the conv kernel at the shapes
    only the logits paths give it, TTA and sliding windows, for slim4 and
    the flagship.  Returns {kernel: worst error} (K3's is 0, or the run
    fails)."""
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import raw as raw_io
    from unetseg_tpu_torch.ops import conv

    preprocess_device(torch, np, dev, card)
    worst = {}
    for batch in LOGITS_BATCHES:
        for v, err in check_parity(torch, conv, dev, LOGITS_CONVS,
                                   batch).items():
            worst[v] = max(worst.get(v, 0.0), err)
    log({"phase": "logits_conv_parity", "shapes": LOGITS_CONVS,
         "batches": list(LOGITS_BATCHES), "max_abs_err": worst})
    torch.cuda.empty_cache()
    cc_err = 0
    with tempfile.TemporaryDirectory() as tmp:
        flag_dir = os.path.join(tmp, "flagship")
        flag_ckpt, _ = flagship_checkpoint(torch, np, flag_dir, dev)
        raw_path = os.path.join(tmp, "tta_slice.raw")
        raw_io.write_raw(raw_path, synth_slice(np.random.default_rng(42),
                                               TTA_RAW)[0])
        for name, ckpt, ref_dev in (("slim4", CKPT, "cpu"),
                                    ("flagship", flag_ckpt, dev)):
            tta_phase(torch, np, name, ckpt, raw_path, tmp, dev, card,
                      ref_dev)
            cc_err = max(cc_err, tiled_phase(torch, np, name, ckpt, tmp, dev,
                                             card, ref_dev))
    return {**worst, "cc_label": cc_err}


# Phase 15: the study runner (BASELINE config 4): slim4 on STUDY_SLICES
# synthetic 768² RAWs at STUDY_BATCH (300 at 128: a ragged tail of 44), the
# flagship on N_FLAGSHIP RAWs at FLAGSHIP_BATCH.
STUDY_SLICES = 300
STUDY_BATCH = 128
STUDY_RAW = 768
# Phase 16: the bench's gates, as bench.py holds them.
BENCH_GATE = 0.999
BENCH_TIMEOUT_S = 900
# Kernel launches of one UNet.masks forward.
MASKS_LAUNCHES = {"slim4": {"conv3x3_bias_act": 6,
                            "conv3x3_bias_act_small_c": 4, "dec1_fused": 0},
                  "flagship": {"conv3x3_bias_act": 13,
                               "conv3x3_bias_act_small_c": 3,
                               "dec1_fused": 1}}


def study_raws(np, d, n, size):
    """``n`` synthetic RAWs in ``d``, slice i drawn from seed (2024, i),
    written by 8 threads."""
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import raw as raw_io

    os.makedirs(d, exist_ok=True)

    def one(i):
        p = os.path.join(d, f"slice_{i:03d}.raw")
        raw_io.write_raw(p, synth_slice(np.random.default_rng((2024, i)),
                                        size)[0])
        return p

    with ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(one, range(n)))


def study_model(torch, np, name, ckpt, paths, batch, tmp, dev, card):
    """Phase 15 for one model: ``engine.process_batch`` (the reference:
    tier full), then the four study modes, the counters set to 0 just before
    each; every mode's masks equal, the full artifacts byte-equal to
    process_batch's, the resident modes' JSONs too; launches exact; slices/s,
    the host stages and the device's idle share of each.  Returns the
    launches of the four counted runs, summed."""
    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.ops import preprocess
    from unetseg_tpu_torch.parallel import pipeline

    size = STUDY_RAW
    n = len(paths)
    n_batches = -(-n // batch)
    ref_dir = os.path.join(tmp, f"{name}_process_batch")
    if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log")):
        raise AssertionError(f"{name}: initialize_engine returned False")
    engine.process_batch(paths, size, size, [ref_dir] * n, batch_size=batch,
                         tier="full")  # warm-up of the ragged tail's batch
    t0 = time.perf_counter()
    ok, failed = engine.process_batch(paths, size, size, [ref_dir] * n,
                                      batch_size=batch, tier="full")
    ref_s = time.perf_counter() - t0
    if (ok, failed) != (n, 0):
        raise AssertionError(f"{name} process_batch: {ok} ok, {failed} failed")
    prof = profile_pipeline(torch, lambda: engine.process_batch(
        paths, size, size, [ref_dir] * n, batch_size=batch, tier="full"),
        iters=1)
    log({"phase": "study", "model": name, "mode": "process_batch",
         "slices": n, "batch": batch, "wall_s": ref_s,
         "slices_per_sec": n / ref_s,
         "device_idle_share": prof["device_idle_share"],
         "device_ms": prof["device_ms_per_iter"],
         "profiled_wall_ms": prof["wall_ms_per_iter"], **card})
    engine.cleanup_resources()

    params, cfg = checkpoint.load(ckpt)
    for device_post in (False, True):  # warm-up outside the counted runs
        pipeline.study_engine(params, cfg, dev, device_post).compile(batch)
    out = {m: os.path.join(tmp, f"{name}_{m}") for m in
           ("full", "resident", "resident_post")}
    modes = {
        "full": lambda: pipeline.run_study(
            params, cfg, paths, size, size, batch_size=batch,
            host_preprocess=True, artifacts="full", out_dir=out["full"],
            keep_masks=True, device=dev),
        "device_pre": lambda: pipeline.run_study(
            params, cfg, paths, size, size, batch_size=batch,
            host_preprocess=False, keep_masks=True, device=dev),
        "resident": lambda: pipeline.run_study_device_resident(
            params, cfg, paths, size, size, batch_size=batch,
            artifacts="json", out_dir=out["resident"], keep_masks=True,
            device=dev),
        "resident_post": lambda: pipeline.run_study_device_resident(
            params, cfg, paths, size, size, batch_size=batch,
            artifacts="json", out_dir=out["resident_post"], keep_masks=True,
            device_postprocess=True, device=dev)}
    total = {}
    masks = {}
    for mode, run in modes.items():
        engs = [pipeline.study_engine(params, cfg, dev, p)
                for p in (False, True)]
        forwards0 = sum(e.forwards for e in engs)
        reset_all_launches()
        pipeline.STAGES.reset()
        res = run()
        launches = all_launches()
        forwards = sum(e.forwards for e in engs) - forwards0
        stages = pipeline.STAGES.summary()
        masks[mode] = res.masks
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        prof = profile_pipeline(torch, run, iters=1)
        log({"phase": "study", "model": name, "mode": mode, "slices": n,
             "batch": batch, "slices_per_sec": res.slices_per_sec,
             "wall_s": res.wall_s, "inference_s": res.inference_s,
             "stage_s": res.stage_s,
             "host_stages_s": {k: v["total_s"] for k, v in stages.items()},
             "host_stage_calls": {k: v["calls"] for k, v in stages.items()},
             "forwards": forwards, "launches": launches,
             "device_idle_share": prof["device_idle_share"],
             "device_ms": prof["device_ms_per_iter"],
             "profiled_wall_ms": prof["wall_ms_per_iter"], **card})
        want = {k: v * n_batches for k, v in MASKS_LAUNCHES[name].items()}
        want["cc_label"] = 2 * n_batches if mode == "resident_post" else 0
        if forwards != n_batches or launches != want:
            raise AssertionError(f"{name} {mode}: {forwards} forwards, "
                                 f"launches {launches}, want {want}")
        if res.n_slices != n or res.masks.shape != (n, 512, 512):
            raise AssertionError(f"{name} {mode}: {res}")
    for mode, m in masks.items():
        differing = int((m != masks["full"]).sum())
        if differing and mode != "device_pre":
            raise AssertionError(f"{name}: the {mode} study's masks differ "
                                 f"from the full study's at {differing} "
                                 f"pixels")
    # The device preprocess is JAX's float32 one, the host's the C++
    # float64 one: a few u8 pixels differ by one gray level.  Where the
    # masks differ, the u8 must, and the masks must be the host cleanup of
    # the argmax of the device's own u8.
    slices = np.nonzero((masks["device_pre"] != masks["full"]).any(
        axis=(1, 2)))[0]
    u8_differing = 0
    if slices.size:
        raws_d = torch.from_numpy(np.stack([np.asarray(raw_io.read_raw(
            paths[i], size, size)) for i in slices])).to(dev)
        u8_d = preprocess.resize_normalize_u8(raws_d, cfg.image_size)
        u8_h = np.stack([native.preprocess_u8(np.asarray(raw_io.read_raw(
            paths[i], size, size)), cfg.image_size) for i in slices])
        eng = pipeline.study_engine(params, cfg, dev)
        want = native.postprocess_batch(eng.to_host(eng._masks(u8_d))())
        u8_np = u8_d.cpu().numpy()
        u8_differing = int((u8_np != u8_h).sum())
        if not (u8_np != u8_h).any(axis=(1, 2)).all() or \
                np.abs(u8_np.astype(int) - u8_h).max() > 1 or \
                not np.array_equal(want, masks["device_pre"][slices]):
            raise AssertionError(f"{name}: the device-preprocess study's "
                                 f"masks differ on slices {slices.tolist()} "
                                 f"beyond its u8")
    names = sorted(os.listdir(ref_dir))
    if len(names) < 3 * n or names != sorted(os.listdir(out["full"])):
        raise AssertionError(f"{name}: the study and process_batch wrote "
                             f"different artifact sets")
    compare_dirs(ref_dir, out["full"], names)
    jsons = [f for f in names if f.endswith(".json")]
    for mode in ("resident", "resident_post"):
        if sorted(os.listdir(out[mode])) != jsons:
            raise AssertionError(f"{name} {mode}: other JSON files")
        compare_dirs(ref_dir, out[mode], jsons)
    log({"phase": "study_parity", "model": name, "slices": n,
         "artifacts": len(names),
         "masks_equal": [m for m in masks if m != "device_pre"],
         "device_pre_differing_pixels": int(
             (masks["device_pre"] != masks["full"]).sum()),
         "device_pre_differing_slices": slices.tolist(),
         "device_pre_u8_differing_pixels": u8_differing,
         "fg_share": float((masks["full"] == 2).mean())})
    for d in (ref_dir, *out.values()):
        shutil.rmtree(d)
    return total


def study(torch, np, dev, card):
    """Phase 15 for slim4 and the flagship; returns the counted runs'
    launches by kernel."""
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = study_raws(np, os.path.join(tmp, "in"), STUDY_SLICES,
                           STUDY_RAW)
        runs = [("slim4", CKPT, paths, STUDY_BATCH)]
        flag_ckpt, flag_paths = flagship_checkpoint(
            torch, np, os.path.join(tmp, "flagship"), dev)
        runs.append(("flagship", flag_ckpt, flag_paths, FLAGSHIP_BATCH))
        for name, ckpt, p, batch in runs:
            for k, v in study_model(torch, np, name, ckpt, p, batch, tmp,
                                    dev, card).items():
                total[k] = total.get(k, 0) + v
            torch.cuda.empty_cache()
    return total


def bench(card):
    """Phase 16: ``python -m unetseg_tpu_torch.bench`` in a subprocess; its
    JSON line logged as it is; fg_iou_min and parity_polygon_iou at least
    BENCH_GATE."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "unetseg_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    log({"phase": "bench", "returncode": proc.returncode,
         "seconds": seconds, **card})
    if lines:
        log(lines[-1])
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench exited {proc.returncode}: "
                             f"{proc.stderr[-4000:]}")
    out = json.loads(lines[-1])
    for key in ("fg_iou_min", "parity_polygon_iou"):
        if out[key] is None or out[key] < BENCH_GATE:
            raise AssertionError(f"bench: {key} {out[key]} < {BENCH_GATE}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    import torch.nn.functional as F

    from unetseg_tpu_torch import checkpoint, engine, service
    from unetseg_tpu_torch.benchmarks import dec1_phases
    from unetseg_tpu_torch.data import synth_batch, synth_slice
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.metrics import foreground_iou
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import (cc, cc_kernel, conv, dec1, halo_copy,
                                       morphology, postprocess)
    from unetseg_tpu_torch.ops.preprocess import preprocess_oracle_u8

    def reset_launches():
        conv.reset_launches()
        cc_kernel.reset_launches()

    def read_launches():
        return {**conv.LAUNCHES, "cc_label": sum(cc_kernel.LAUNCHES.values())}

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

    # -- 2. build (every kernel and the host library, all at once) ----------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=6) as pool:
        for fut in [pool.submit(lib.load) for lib in (
                conv, cc_kernel, dec1, halo_copy, native, dec1_phases)]:
            fut.result()
    log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3)})
    for r in conv.resources():
        log({"phase": "conv_resources", **r})
    k6_res = dec1.resources()
    for r in k6_res:
        log({"phase": "dec1_resources", **r})
    if len(k6_res) != len(dec1.KERNEL_CHANNELS) or \
            any(r["spill_bytes"] for r in k6_res):
        raise AssertionError(f"K6: want {len(dec1.KERNEL_CHANNELS)} "
                             f"instantiations without spills, got {k6_res}")
    cc_res = cc_kernel.resources()
    for r in cc_res:
        log({"phase": "cc_resources", **r})
    if len(cc_res) != 8 or any(r["spill_bytes"] for r in cc_res):
        raise AssertionError(f"K3: want 8 kernels without spills, got "
                             f"{cc_res}")

    # -- 3. kernel parity on the card --------------------------------------
    max_err = check_parity(torch, conv, dev, SLIM4_CONVS + EXTRA_CONVS, 8)
    for v, err in check_parity(torch, conv, dev, EDGE_CONVS,
                               EDGE_BATCH).items():
        max_err[v] = max(max_err.get(v, 0.0), err)
    cc_err = 0
    for i, (name, fg) in enumerate(cc_cases(np)):
        cc_err = max(cc_err, check_cc(torch, cc, cc_kernel, name,
                                      torch.from_numpy(fg).to(dev), 300 + i))
    speckle = torch.from_numpy(np.random.default_rng(5).random(
        (128, 512, 512)) > 0.5).to(dev)
    cc_err = max(cc_err, check_cc(torch, cc, cc_kernel, "speckle", speckle,
                                  310))
    cc_err = max(cc_err, check_cc(torch, cc, cc_kernel, "speckle_8x16",
                                  speckle[:8], 311, (8, 16)))
    for i, (name, fg, tile) in enumerate(cc_edge_cases(np)):
        cc_err = max(cc_err, check_cc(torch, cc, cc_kernel, name,
                                      torch.from_numpy(fg).to(dev), 340 + i,
                                      tile))

    with tempfile.TemporaryDirectory() as tmp:
        in_dir = os.path.join(tmp, "in")
        os.makedirs(in_dir)
        size = 768
        paths = write_raws(raw_io, synth_slice, np, in_dir, N_RAWS, size)
        host_out = os.path.join(tmp, "out_host")
        dev_out = os.path.join(tmp, "out_device")

        # -- 4. main path, host cleanup ---------------------------------------
        reset_launches()
        if not engine.initialize_engine(CKPT, log_dir=os.path.join(tmp, "log")):
            raise AssertionError("initialize_engine returned False")
        eng = engine.get_engine()
        host_batch_s = [run_batch(engine, paths, size, host_out) for _ in range(2)]
        check_artifacts(host_out, "slice_017")
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
        launches = read_launches()
        forwards = eng.forwards
        log({"phase": "main_path", "cleanup": "host",
             "process_batch_256_s": host_batch_s,
             "process_single_image_s": single_s, "forwards": forwards,
             "launches": launches, "fg_iou_mean": float(np.mean(ious)),
             "fg_iou_min": float(np.min(ious)), **card})
        check_launches(launches, forwards, 0)
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

        # A batch of 128 real argmax masks: K3 parity on what serving feeds it.
        batch = 128
        raws128, _ = synth_batch(np.random.default_rng(77), batch)
        u8_real = torch.from_numpy(np.stack(
            [native.preprocess_u8(r, 512) for r in raws128])).to(dev)
        masks = eng._masks(u8_real)
        inv = masks != postprocess.FOREGROUND_VALUE
        opened = morphology.open_(~inv, postprocess.MORPH_KERNEL_SIZE)
        for name, fg, seed in (("real_inverse", inv, 320),
                               ("real_opened_fg", opened, 321)):
            cc_err = max(cc_err, check_cc(torch, cc, cc_kernel, name, fg, seed))

        # -- 5. main path, device cleanup ----------------------------------
        reset_launches()
        if not engine.initialize_engine(CKPT, log_dir=os.path.join(tmp, "log"),
                                        device_postprocess=True):
            raise AssertionError("initialize_engine(device_postprocess=True) "
                                 "returned False")
        eng = engine.get_engine()
        dev_batch_s = [run_batch(engine, paths, size, dev_out) for _ in range(2)]
        single_dev = os.path.join(tmp, "single_device")
        t0 = time.perf_counter()
        if not engine.process_single_image(paths[3], size, size, single_dev):
            raise AssertionError("process_single_image returned False")
        single_dev_s = time.perf_counter() - t0
        dev_launches = read_launches()
        dev_forwards = eng.forwards
        log({"phase": "main_path", "cleanup": "device",
             "process_batch_256_s": dev_batch_s,
             "process_single_image_s": single_dev_s,
             "forwards": dev_forwards, "launches": dev_launches, **card})
        check_launches(dev_launches, dev_forwards, 2)
        # A slice without contours has no overlay and no contour JSON.
        names = sorted(os.listdir(host_out))
        log({"phase": "artifacts", "host_cleanup": len(names),
             "device_cleanup": len(os.listdir(dev_out)),
             "contour_jsons": sum(n.endswith(".json") and not n.endswith(
                 "_sizes.json") for n in names)})
        if len(names) < 3 * N_RAWS or names != sorted(os.listdir(dev_out)):
            raise AssertionError("device and host cleanup wrote different "
                                 "artifact sets")
        compare_dirs(host_out, dev_out, names)
        compare_dirs(single_dir, single_dev, sorted(os.listdir(single_dir)))

        # Batches of 128: device cleanup == host C++ cleanup, bit for bit,
        # and the cleanup never waits on the card.  The real masks, the same
        # with 1% salt and 1% pepper (holes to fill, specks to drop), and the
        # speckle as a mask.
        masks = eng._masks(u8_real)
        masks_np = masks.cpu().numpy()
        if not torch.equal(eng._pipeline(u8_real),
                           postprocess.postprocess_masks(masks)):
            raise AssertionError("pipeline and postprocess_masks disagree")
        noise = torch.rand(masks.shape, generator=torch.Generator(
            device=dev).manual_seed(330), device=dev)
        salted = torch.where(noise < 0.01, 2, torch.where(noise < 0.02, 0,
                                                          masks)).to(torch.uint8)
        for name, m in (("real", masks), ("salt_pepper", salted),
                        ("speckle", (speckle * 2).to(torch.uint8))):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                cleaned = postprocess.postprocess_masks(m)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            m_np = m.cpu().numpy()
            host_cleaned = native.postprocess_batch(m_np)
            same = np.array_equal(cleaned.cpu().numpy(), host_cleaned)
            log({"phase": "device_cleanup_parity", "masks": name,
                 "batch": m.shape[0], "bit_equal": same,
                 "pixels_changed_by_cleanup": int(
                     (host_cleaned != np.where(m_np == 2, 2, 0)).sum()),
                 "fg_share": float((host_cleaned == 2).mean())})
            if not same:
                raise AssertionError(f"device cleanup differs from the host "
                                     f"C++ cleanup on the {name} masks")

        # -- 6. the TCP service, device cleanup ------------------------------
        svc_in = os.path.join(tmp, "svc_in")
        svc_out = os.path.join(tmp, "svc_out")
        os.makedirs(svc_in)
        for p in paths[:N_SERVICE]:
            shutil.copy(p, svc_in)
        reset_launches()
        svc = service.SegmentationService(port=0, device_postprocess=True)
        addr = svc.start()
        try:
            def ask(req):
                resp = service.request(addr, req, timeout=300)
                log({"phase": "service", "cmd": req["cmd"],
                     "resp": resp if req["cmd"] != "metrics" else
                     {"ok": resp["ok"], "records": len(resp["records"])}})
                if not resp.get("ok"):
                    raise AssertionError(f"service {req['cmd']}: {resp}")
                return resp

            ask({"cmd": "init", "cache": CKPT})
            svc_eng = engine.get_engine()
            r = ask({"cmd": "process", "path": svc_in, "width": size,
                     "height": size, "output_dir": svc_out, "tier": "full"})
            if r["processed"] != N_SERVICE or r["failed"]:
                raise AssertionError(f"service directory request: {r}")
            ask({"cmd": "process", "path": paths[5], "width": size,
                 "height": size, "output_dir": os.path.join(tmp, "svc_one")})
            st = ask({"cmd": "status"})
            if not (st["initialized"] and st["device_postprocess"]
                    and st["processed"] == N_SERVICE + 1):
                raise AssertionError(f"service status: {st}")
            if not ask({"cmd": "metrics", "n": 5})["records"]:
                raise AssertionError("service metrics: no records")
            svc_launches = read_launches()
            svc_forwards = svc_eng.forwards
            ask({"cmd": "shutdown"})
        finally:
            svc.stop()
        log({"phase": "service_path", "forwards": svc_forwards,
             "launches": svc_launches})
        check_launches(svc_launches, svc_forwards, 2)
        svc_names = sorted(os.listdir(svc_out))
        bases = tuple(os.path.basename(p)[:-len(".raw")] + s
                      for p in paths[:N_SERVICE] for s in ("_", "."))
        if svc_names != [n for n in names if n.startswith(bases)]:
            raise AssertionError(f"service wrote {len(svc_names)} artifacts, "
                                 f"not those of the host cleanup")
        compare_dirs(host_out, svc_out, svc_names)

    # -- 7. numbers ----------------------------------------------------------
    # The device-cleanup engine was torn down with the service; rebuild it
    # without the log to time the pipeline with and without the cleanup.
    params, cfg = checkpoint.load(CKPT)
    eng = engine.InferenceEngine(params, cfg)
    eng_dev = engine.InferenceEngine(params, cfg, device_postprocess=True)
    iters = 20
    for label, e in (("host_cleanup", eng), ("device_cleanup", eng_dev)):
        pipe_ms = time_ms(torch, lambda: e._pipeline(u8_real), iters)
        log({"phase": "throughput", "pipeline": label, "batch": batch,
             "slices_per_s": batch / pipe_ms * 1e3, "ms_per_batch": pipe_ms,
             **card})
        prof = profile_pipeline(torch, lambda: e._pipeline(u8_real))
        del prof["ops"]
        log({"phase": "profile", "pipeline": label, **prof, **card})

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

    # K3 per call at batch 128: the two calls of one cleanup batch on the
    # real masks (the inverse, then the opened foreground), and the speckle;
    # the labels-only entry and the stats entry the cleanup calls.
    cc_sum = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, fg in (("real_inverse", inv), ("real_opened_fg", opened),
                     ("speckle", speckle)):
        roots = cc_roots(torch, cc_kernel, fg)
        for entry, fn, plain, bound in (
                ("labels", cc_kernel.cc_label, cc.cc_label, cc_bound_ms(fg)),
                ("stats", cc_kernel.cc_label_stats,
                 cc_kernel.cc_label_stats_plain, cc_bound_ms(fg, roots))):
            k_ms = time_ms(torch, lambda: fn(fg), iters)
            plain_ms = time_ms(torch, lambda: plain(fg), 3, warmup=1)
            log({"phase": "cc_time", "input": name, "entry": entry,
                 "shape": list(fg.shape), "components": roots - fg.shape[0],
                 "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "share_of_bound": bound / k_ms, "bound_by": "bytes",
                 "library_ms": None, **card})
            if name != "speckle" and entry == "stats":
                for key, val in (("ms", k_ms), ("plain_ms", plain_ms),
                                 ("bound_ms", bound)):
                    cc_sum[key] += val
    dev_clean_ms = time_ms(torch, lambda: postprocess.postprocess_masks(masks),
                           iters)
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        native.postprocess_batch(masks_np)
        host_s.append(time.perf_counter() - t0)
    log({"phase": "cleanup_time", "batch": batch,
         "device_ms_per_batch": dev_clean_ms,
         "host_cpp_ms_per_batch": [t * 1e3 for t in host_s],
         "host_cpus": os.cpu_count(), **card})
    # The device cleanup alone, by kernel: no per-pixel scatter is left.
    prof = profile_pipeline(
        torch, lambda: postprocess.postprocess_masks(masks), top=30)
    scatters = [k for k in prof.pop("ops")
                if "scatter" in k.lower() or "index_fill" in k.lower()]
    log({"phase": "cleanup_profile", "batch": batch, **prof,
         "scatter_or_index_fill": scatters, **card})
    if scatters:
        raise AssertionError(f"the device cleanup still runs {scatters}")
    kernels.append({
        "name": "cc_label", "route": "cuda", "source": CC_SOURCE,
        "replaces": REPLACES["cc_label"], "launches": dev_launches["cc_label"],
        "max_abs_err": cc_err, "ms": cc_sum["ms"],
        "plain_ms": cc_sum["plain_ms"], "bound_ms": cc_sum["bound_ms"],
        "bound_by": "bytes", "library_ms": None})
    del u8_real, masks, masks_np, inv, opened, speckle, eng, eng_dev
    torch.cuda.empty_cache()
    kernels += flagship(torch, np, F, dev, card)
    torch.cuda.empty_cache()
    configs(torch, np, dev, card)
    torch.cuda.empty_cache()
    for name, err in tta_and_windows(torch, np, dev, card).items():
        for k in kernels:
            if k["name"] == name:
                k["max_abs_err"] = max(k["max_abs_err"], err)
    torch.cuda.empty_cache()
    for name, n in study(torch, np, dev, card).items():
        for k in kernels:
            if k["name"] == name:
                k["launches"] += n
    torch.cuda.empty_cache()
    bench(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
