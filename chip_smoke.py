#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``unetseg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:

1. Device: the card's name and power limit (nvidia-smi); no CUDA -> exit 1.
2. Build: all six kernel sources (conv, the float32 conv K8, CCL, fused
   last decoder level, halo copy, the int8 conv K7; nvcc, sm_90a), K6's
   phase-stamped build and the host C++ library, all at once; then
   the conv kernel's, K6's, the CCL passes', K8's and K7's registers,
   spills and shared memory per instantiation, as ``nvcc -Xptxas -v``
   reported them, one line each (``conv_resources``, ``dec1_resources``,
   ``cc_resources``, ``f32_resources``, ``s8_resources``); a spill in K6,
   K3, K8 or K7 fails the run.
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
   served by the engine; a float32 model (refused before K8) served by
   the engine, every conv in K8.

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
17. The confidence cascade (``cascade``, P8): slim4 the student, the seeded
   flagship (head bias centred) the fallback, ``flagship_slim4_robust``
   the co-model, on 128 of phase 4's 768² RAWs at batch 128.  For each
   router (margin, disagree, both), with host and with device cleanup, the
   counters set to 0 just before each ``infer_cascade``: thresholds that
   route none (masks bit-equal to the plain slim4 engine's), all
   (bit-equal to the fallback engine's at batch 128) and half (64 routed
   in a bucket of 64, every row spliced exactly: the routed rows the
   fallback engine's at that bucket and at batch 128); per call 6 K1 + 4
   K2 for the student, 6 + 4 more for the co-model (disagree, both), 13 K1
   + 3 K2 + 1 K6 for a fallback pass, 2 K3 per pass with device cleanup.
   The student's and the fallback's masks at batch 128 equal their masks
   in chunks of 32, the batch phase 10 holds K6 to its plain version at.
   The statistic on two slices against the CPU path: the margin within
   1e-2 of it relative plus 1e-2, the disagreement within the pixels where
   the two models' masks differ between the card and the CPU.
   ``process_batch`` (tier full) and
   ``process_single_image`` under each router at the REPL's defaults
   (margin 1.5; 106 px), launches exact; the TCP service's ``init`` with
   the cascade fields and one directory ``process``.  ms per batch of 128
   by CUDA events: the plain pass, each router pass, the fallback at
   buckets 1, 64 and 128; the routed count at the defaults.
18. Per-class JSON (``per_class``, P6, BASELINE config 2) for slim4 and the
   seeded flagship (head bias centred on these RAWs) on 64 512² RAWs at
   batch 32: ``process_batch(per_class=True)`` (launches exact),
   ``process_single_image(per_class=True)`` plain, with ``tta=True`` and
   with ``window=512`` (a 768² RAW), every ``_classes.json`` byte-equal to
   the pure path's (``io/contours_py`` + ``io/jsonfmt``) of the same
   decoded mask; ``run_study(per_class=True, artifacts="full")`` byte-equal
   to process_batch's files; the device cleanup refused.  ``compat``: the
   normalized PNG of ``preprocess_raw`` decodes to
   ``native.preprocess_u8``'s pixels, ``process_single_mask`` on the
   engine's mask writes its contour JSON.  Study slices/s with and without
   per-class JSON on phase 15's study size (300 512² RAWs at batch 32),
   three rounds after a warm one, the two modes interleaved.

19. The model zoo (``zoo``, P10): UNet++ (``ModelConfig(arch="unetpp")``,
   with and without deep supervision) and Attention U-Net at full width
   and depth (base 64, depth 4, bf16), seeded weights with the head bias
   centred.  Every served conv shape has a spill-free instantiation; the
   shapes new to K1 (D = 64 at 512² with C = 128-320, C = 192, 320, 384,
   512 at 256², 768) against the plain conv at batch 2 and timed at 32.
   Per model on 64 768² RAWs at batch 32: ``process_batch`` and
   ``process_single_image`` with host and with device cleanup, artifacts
   byte-equal between the two, per forward 23 K1 + 7 K2 (UNet++) or 14 +
   4 (Attention U-Net), no K6, 2 K3 a batch with device cleanup; masks on
   two slices against the CPU path >= 99.5% equal (UNet++: 99%, see
   ``ZOO_AGREEMENT``), every differing pixel within 4 ulps of
   ``dec1.near_tie_sums``; ms per batch (CUDA events),
   slices/s and the device time by kernel.  Attention U-Net through phases
   13 and 14 (``tta_phase``, ``tiled_phase``, the plain-conv reference on
   the card).  The importers: a full-width ``ModelConfig()`` torch UNet
   with BN after every 3x3 conv, through ``.pt`` ->
   ``params_from_torch_state_dict`` (BN folded) and through an ``.onnx``
   written by ``write_onnx_graph`` -> ``load_onnx``: trees bit-equal,
   both checkpoints served with bit-equal masks.

20. The partition pool and the dp engine (``partitions``, P9b), for slim4
   and the seeded flagship: ``make_partitioned_engines(4)`` on the one card
   gives one engine; the TCP service with ``partitions=4`` pools the
   global engine itself (one card) and answers 8
   concurrent clients (one single-file ``process`` each), every artifact
   byte-equal to ``process_batch``'s, launches exact; an engine over
   ``["cuda:0", "cuda:0"]`` splits a batch of 128 in two parts, masks
   bit-equal to the one-device engine's (ms per batch of both); its TTA is
   the mesh weight-space form, bit-equal to the sequential form; launches
   exact.
21. The w8a8 slim4 (``w8a8``, P11): K7 (``csrc/conv3x3_s8.cu``) bit-equal
   to its plain version on phase 3's shapes; ``quantize_checkpoint`` on
   the card from models/flagship_slim4.ckpt, calibrated on two
   ``training_batch(default_rng(77), 8)`` batches; the w8a8 and the bf16
   slim4 pipelines at batch 128 with host and device cleanup, in turns
   (ms per batch, slices/s), the w8a8 device time by kernel and idle
   share; K7 per shape against its bound (int8 operations at 1,979 TOP/s,
   or bytes at 3.35 TB/s), im2col + ``torch._int_mm`` (``library_ms``), its
   plain version and K1/K2 on the bf16 shapes; card vs CPU masks on two
   slices >= 99.9% equal; on bench.py's pool (seed 991, 32 slices) the
   polygon IoU against the float parent (bf16 on the card) >= 0.999, the
   module's contract; every entry point once (``process_batch``,
   ``process_single_image`` plain, TTA in activation space and windows,
   ``run_study``, ``run_study_device_resident`` with device cleanup, the
   service with ``partitions=4``), 10 K7 and no K1/K2/K6 launch per
   forward, artifacts byte-equal to ``process_batch``'s.

22. Float32 (``f32``, P13): TF32 off for cuDNN and cuBLAS (asserted).  K8
   (``csrc/conv3x3_f32.cu``) against its plain version and both against a
   float64 reference on every conv shape slim4, the flagship and the zoo
   serve (batch 2) and on the tiling's edges (C = 1, 4, 48, 80, 96; D = 48,
   112; ragged B, H, W; with and without ReLU): within ``F32_TOL`` of max
   |out| and at most ``F32_VS_LIBRARY`` times F.conv2d's own float32
   error.  K8 per shape beside its bound (float32 operations at 67
   TFLOP/s, or bytes), F.conv2d in float32 and its plain version, summed
   per slim4 forward at 128 (the kernels line) and per flagship forward at
   32.  The seeded flagship (head centred) and slim4 re-configured to
   float32, counters set to 0 just before each call: ``process_batch``,
   ``process_single_image`` plain, TTA, windows and with device cleanup,
   ``run_study``, the TCP service, the REPL; every forward's convs in K8,
   no K1/K2/K6; artifacts byte-equal where two entry points serve one
   slice; logits on two slices within ``F32_LOGIT_TOL`` of the CPU path's,
   masks equal but at near ties; ms per batch and slices/s beside bf16's
   in turns, the device time by kernel.  The cascade (float32 slim4
   student, float32 flagship fallback) and UNet++ and Attention U-Net in
   float32 through ``process_batch``.
23. Training (``train``, P12): ``Conv3x3Function``'s output, dx, dw and db
   against autograd through the plain version, bf16 and float32, on phase
   22's shapes; train-to-serve at tests/test_train_to_serve.py's size and
   asserts (64², base 8, depth 2, float32, 150 steps at lr 1e-2: the last
   loss below 0.3x the first, held-out IoU above 0.75), counters set to 0
   just before it (per step every conv in K8 and each but the first's data
   gradient); the trained checkpoint served on the card and on the CPU,
   contour JSONs byte-equal where the masks are; a ``save_state`` /
   ``load_state`` resume bit-equal to the uninterrupted run (cuDNN
   deterministic); the dp step over two positions of the card against the
   one-device step, with boundary weights.
24. The flagship recipe (``train_flagship``,
   ``unetseg_tpu_torch/benchmarks/train_flagship.py``: bf16, remat, batch
   8, lr 3e-4) for ``TRAIN_STEPS`` steps, counters set to 0 just before
   it: per step 3 x 18 - 3 K1/K2 launches (forward, the remat recompute of
   every stage but the bottleneck, 17 data gradients), no K6; ms per step,
   training slices/s, peak memory, the device time by kernel and idle
   share, and per step the forward, dgrad and wgrad times by CUDA events;
   the loss falls.  ``F32_TRAIN_STEPS`` float32 flagship steps, timed;
   ``DISTILL_STEPS`` distillation steps, slim4 the student, the seeded
   flagship's logits the teacher.

The line before the last is the ``{"kernels": [...]}`` record, each conv
kernel's entry with its data-gradient launches (``dgrad_launches``); the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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
            v = conv.variant(shape[2], torch.bfloat16)
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
            launches["conv3x3_bias_act_small_c"] != 4 * forwards or \
            launches["conv3x3_bias_act_f32"]:
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
    bias = -logits.reshape(-1, cfg.num_classes).median(0).values.cpu().numpy()
    # UNet++ averages its heads' logits: every head takes the same bias
    for site in params["heads"] if "heads" in params else [params["head"]]:
        site["b"] = bias
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
             "variant": conv.variant(shape[2], torch.bfloat16), "ms": k_ms, "library_ms": lib_ms,
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
    """(logits, absolute head sums), both (N, H, W, K) float32, of the
    model's forward on NHWC ``x``: the logits by the forward's own ops, the
    sums |c2|.|wh| + |bh| (``dec1.near_tie``'s measure) in f32, both through
    depth-to-space for a stem-s model; for UNet++ both averaged over its
    heads, as its logits are."""
    from unetseg_tpu_torch.models.unet import depth_to_space

    if hasattr(model, "heads"):  # UNet++: the mean over its heads
        feats = model.head_inputs(x)
        logits = absum = 0
        for head, f in zip(model.heads, feats):
            logits = logits + head(f).float()
            absum = absum + (f.float().abs() @ head.weight.float().abs()
                             + head.bias.float().abs())
        return logits / len(feats), absum / len(feats)
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
    the engine; a float32 model served by the engine, every conv in K8."""
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

        # float32, refused before K8 (P13): served, every conv in K8
        f32 = os.path.join(tmp, "models", "f32.ckpt")
        f32_cfg = ModelConfig(base_channels=16, depth=1,
                              compute_dtype="float32")
        checkpoint.create(f32, f32_cfg, seed=0)
        if not engine.initialize_engine(f32, log_dir=os.path.join(tmp, "lf")):
            raise AssertionError("initialize_engine(float32) returned False")
        eng = engine.get_engine()
        forwards0 = eng.forwards
        conv.reset_launches()
        dec1.reset_launches()
        f32_out = os.path.join(tmp, "out_f32")
        ok, failed = engine.process_batch(paths, 768, 768,
                                          [f32_out] * len(paths),
                                          batch_size=CONFIG_BATCH)
        launches = {**conv.LAUNCHES, **dec1.LAUNCHES}
        engine.cleanup_resources()
        forwards = eng.forwards - forwards0
        log({"phase": "config_f32", "processed": ok, "failed": failed,
             "forwards": forwards, "launches": launches})
        want = dict.fromkeys(launches, 0)
        want["conv3x3_bias_act_f32"] = (4 * f32_cfg.depth + 2) * forwards
        if (ok, failed) != (len(paths), 0) or launches != want:
            raise AssertionError(f"float32 model: {ok} ok, {failed} failed, "
                                 f"launches {launches}, want {want}")


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
    """The models' 3x3 convs through the conv's plain version (a float32
    conv, one cast) on any device: the reference that the TTA and window
    paths are held against, on the CPU for slim4 and on the card for the
    flagship.  ``Conv3x3Function`` calls ``conv.conv3x3_bias_act``, so
    the swap is made there."""
    from unetseg_tpu_torch.ops import conv

    saved = conv.conv3x3_bias_act
    conv.conv3x3_bias_act = conv.conv3x3_bias_act_plain
    try:
        yield
    finally:
        conv.conv3x3_bias_act = saved


def convs_per_forward(model) -> dict:
    """Conv kernel launches of one ``UNet.forward`` by variant: every 3x3
    conv, the last level's included (the logits path takes no K6)."""
    from unetseg_tpu_torch.models.unet import Conv3x3
    from unetseg_tpu_torch.ops import conv

    out = {"conv3x3_bias_act": 0, "conv3x3_bias_act_small_c": 0,
           "conv3x3_bias_act_f32": 0}
    for m in model.modules():
        if isinstance(m, Conv3x3):
            out[conv.variant(m.weight.shape[2], m.weight.dtype)] += 1
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


def tta_phase(torch, np, name, ckpt, raw_path, tmp, dev, card, ref_dev,
              contours=True):
    """Phase 13 for one model: ``process_single_image(tta=True)`` with host
    and with device cleanup; weight-space against activation-space masks on
    the card; the card against the plain convs on ``ref_dev``; times (the
    first call's with the 8 variants' build).  ``contours``: the slice's
    cleaned mask keeps an organ, so all five artifacts are written (phase
    19's seeded zoo models paint speckle the cleanup clears: three)."""
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
        if contours or len(names) != 3:
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
        ensemble = eng._tta[1]
        times = {"weight_space_ms": time_ms(torch, lambda: ensemble(u8_1),
                                            10),
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
                            "conv3x3_bias_act_small_c": 4,
                            "conv3x3_bias_act_f32": 0, "dec1_fused": 0},
                  "flagship": {"conv3x3_bias_act": 13,
                               "conv3x3_bias_act_small_c": 3,
                               "conv3x3_bias_act_f32": 0,
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


# Phase 17: the confidence cascade (P8): slim4 the student, the seeded
# flagship the fallback, slim4_robust the co-model, on CASCADE_BATCH of
# phase 4's 768² RAWs (the same seed).
ROBUST_CKPT = os.path.join(REPO, "models", "flagship_slim4_robust.ckpt")
CASCADE_BATCH = 128
CASCADE_BUCKETS = (1, 64, 128)
CASCADE_ROUTERS = ("margin", "disagree", "both")
# The REPL's defaults: margin 1.5; 106 disagreeing pixels.
CASCADE_MARGIN = 1.5
CASCADE_DISAGREE_PX = 106.0
CASCADE_CPU_SLICES = 2
# The card's boundary margin against the CPU's: |card - cpu| <= rtol * |cpu|
# + atol (bf16 on the card, float32 on the CPU).
CASCADE_MARGIN_RTOL = 1e-2
CASCADE_MARGIN_ATOL = 1e-2
N_CASCADE_SERVICE = 32
# Phase 18: per-class JSON (BASELINE config 2): 512² RAWs at batch 32, and
# one 768² RAW for window mode.
PER_CLASS_SLICES = 64
# Its study rates: phase 15's study size, PER_CLASS_REPEATS rounds.
PER_CLASS_TIME_SLICES = STUDY_SLICES
PER_CLASS_REPEATS = 3
PER_CLASS_BATCH = 32
PER_CLASS_RAW = 512
PER_CLASS_WINDOW = 512
PER_CLASS_WINDOW_RAW = 768
PURE_WORKERS = 8


def add_launches(*parts) -> dict:
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + v
    return out


def cascade_thresholds(np, router, stat, margin):
    """(threshold, margin threshold) that route half the batch, and the rows
    they route: the margin router the lower half of the margins, the
    disagree router the upper half of the disagreements, the both router
    the top quarter by disagreement and then the lowest margins among the
    rest, so that each leg routes slices the other does not."""
    n = stat.size
    half = n // 2
    s = np.sort(stat)
    if router == "margin":
        thr = float((s[half - 1] + s[half]) / 2)
        return thr, CASCADE_MARGIN, np.nonzero(stat < thr)[0]
    if router == "disagree":
        thr = float((s[half - 1] + s[half]) / 2)
        return thr, CASCADE_MARGIN, np.nonzero(stat > thr)[0]
    q = n - n // 4
    d_thr = float((s[q - 1] + s[q]) / 2)
    rest = np.nonzero(stat <= d_thr)[0]
    need = min(max(half - (n - rest.size), 1), rest.size - 1)
    m = np.sort(margin[rest])
    m_thr = float((m[need - 1] + m[need]) / 2)
    return d_thr, m_thr, np.nonzero((stat > d_thr) | (margin < m_thr))[0]


def default_routed(np, router, stat, margin) -> int:
    """Slices the REPL's default thresholds route."""
    if router == "margin":
        return int((stat < CASCADE_MARGIN).sum())
    if router == "disagree":
        return int((stat > CASCADE_DISAGREE_PX).sum())
    return int(((stat > CASCADE_DISAGREE_PX)
                | (margin < CASCADE_MARGIN)).sum())


def cascade_pass_launches(router, post, student_model):
    """(launches of the router pass, of a fallback pass): the margin and
    both routers run the student's logits (``UNet.forward``: every conv in
    the conv kernel, no K6), the disagree router its masks; the disagree
    and both routers the co-model's masks (slim4's geometry); the fallback
    its masks (the flagship: K6); 2 K3 per pass with device cleanup."""
    zero = {"conv3x3_bias_act": 0, "conv3x3_bias_act_small_c": 0,
            "conv3x3_bias_act_f32": 0, "dec1_fused": 0, "cc_label": 0}
    cleanup = {"cc_label": 2 if post else 0}
    student = (MASKS_LAUNCHES["slim4"] if router == "disagree" else
               convs_per_forward(student_model))
    co = MASKS_LAUNCHES["slim4"] if router != "margin" else {}
    return (add_launches(zero, student, co, cleanup),
            add_launches(zero, MASKS_LAUNCHES["flagship"], cleanup))


def router_masks(torch, eng, u8_dev):
    """The student's and the co-model's masks on a u8 batch, before the
    cleanup, by the routes :meth:`InferenceEngine._router_pass` takes: the
    student's logits and argmax for the both router, its masks for the
    disagree router; the co-model's masks."""
    from unetseg_tpu_torch.ops import preprocess
    from unetseg_tpu_torch.ops.decode import decode_mask

    with torch.inference_mode():
        x = preprocess.model_input_from_u8(u8_dev)[..., None]
        student = (eng.model.masks(x) if eng.cascade_router == "disagree"
                   else decode_mask(eng.model(x), eng.cfg.num_classes))
        co = eng._cascade_co_models[0].masks(x)
    return student.cpu().numpy(), co.cpu().numpy()


def cascade_router(torch, np, router, post, params, u8, u8_dev, refs, dev,
                   card):
    """Phase 17 for one router and cleanup: route none, all and half, the
    counters set to 0 just before each call; returns (the calls' launches,
    the statistic, the margin, the engine)."""
    from unetseg_tpu_torch import engine
    from unetseg_tpu_torch.models import registry

    n = u8.shape[0]
    eng = engine.InferenceEngine(*params["student"], device=dev,
                                 device_postprocess=post)
    co = params["co"] if router != "margin" else (None, None)
    eng.attach_cascade(*params["fallback"], router=router, co_params=co[0],
                       co_cfg=co[1])
    eng.compile_cascade(n)
    _, stat_d, margin_d = eng._router_pass(u8_dev)
    stat = stat_d.cpu().numpy()
    margin = stat if margin_d is None else margin_d.cpu().numpy()
    router_pass, fallback_pass = cascade_pass_launches(router, post,
                                                       eng.model)
    st_masks, fb_masks, fb_eng = refs[post]
    half_thr, half_m_thr, half_rows = cascade_thresholds(np, router, stat,
                                                         margin)
    cases = {"none": ((-np.inf, CASCADE_MARGIN) if router == "margin" else
                      (np.inf, -np.inf)),
             "all": ((np.inf, CASCADE_MARGIN) if router == "margin" else
                     (-1.0, np.inf)),
             "half": (half_thr, half_m_thr)}
    buckets = []
    fallback = eng._fallback_pass
    eng._fallback_pass = lambda u: buckets.append(u.shape[0]) or fallback(u)
    total = {}
    for case, (thr, m_thr) in cases.items():
        eng.cascade_threshold, eng.cascade_margin_threshold = thr, m_thr
        buckets.clear()
        reset_all_launches()
        t0 = time.perf_counter()
        masks, got_stat, n_routed = eng.infer_cascade(u8)
        wall = time.perf_counter() - t0
        launches = all_launches()
        total = add_launches(total, launches)
        want = add_launches(router_pass, fallback_pass if n_routed else {})
        rows = {"none": np.arange(0), "all": np.arange(n),
                "half": half_rows}[case]
        bucket = min(1 << (rows.size - 1).bit_length(), n) if rows.size \
            else None
        record = {"phase": "cascade", "router": router,
                  "cleanup": "device" if post else "host", "case": case,
                  "batch": n, "threshold": thr, "margin_threshold": m_thr,
                  "routed": n_routed, "buckets": list(buckets),
                  "launches": launches, "wall_s": wall, **card}
        if not np.array_equal(got_stat, stat):
            raise AssertionError(f"cascade {router}: the statistic moved "
                                 f"between two runs of the same batch")
        if launches != want:
            raise AssertionError(f"cascade {router} {case}: launches "
                                 f"{launches}, want {want}")
        if n_routed != rows.size or buckets != ([bucket] if bucket else []):
            raise AssertionError(f"cascade {router} {case}: routed "
                                 f"{n_routed} in {buckets}, want {rows.size} "
                                 f"in {bucket}")
        if case == "half" and rows.size != n // 2:
            s = np.sort(stat)
            if s[n // 2 - 1] != s[n // 2]:
                raise AssertionError(f"cascade {router}: {rows.size} routed "
                                     f"at the half threshold, want {n // 2}")
            record["median_tie"] = True
        keep = np.setdiff1d(np.arange(n), rows)
        if not np.array_equal(masks[keep], st_masks[keep]):
            raise AssertionError(f"cascade {router} {case}: unrouted rows "
                                 f"differ from the plain student engine's")
        if case == "all" and not np.array_equal(masks, fb_masks):
            raise AssertionError(f"cascade {router}: route-all masks differ "
                                 f"from the fallback engine's")
        if case == "half":
            sub = np.concatenate([u8[rows], np.repeat(
                u8[rows[:1]], bucket - rows.size, axis=0)])
            want_rows = fb_eng.to_host(fb_eng.infer(sub))()[:rows.size]
            if not np.array_equal(masks[rows], want_rows):
                raise AssertionError(f"cascade {router}: the routed rows "
                                     f"differ from the fallback engine's at "
                                     f"bucket {bucket}")
            # the bucket's rows against the same rows at batch n (held to
            # chunks of FLAGSHIP_BATCH above)
            differ = int((masks[rows] != fb_masks[rows]).sum())
            record["routed_vs_fallback_batch_%d_differing_pixels" % n] = differ
            if differ:
                raise AssertionError(f"cascade {router}: the routed rows at "
                                     f"bucket {bucket} differ from the "
                                     f"fallback's at batch {n} at {differ} "
                                     f"pixels")
        log(record)
    eng._fallback_pass = fallback
    # The card's statistic against the CPU path on two slices: the margin
    # within CASCADE_MARGIN_RTOL/ATOL; the disagreement within the pixels
    # where the two models' masks (before the cleanup, as the router counts
    # them) differ between the card and the CPU, its largest honest gap.
    cpu = engine.InferenceEngine(*params["student"], device="cpu")
    cpu.attach_cascade(*params["fallback"], router=router, co_params=co[0],
                       co_cfg=co[1])
    k = CASCADE_CPU_SLICES
    u8_k = torch.from_numpy(u8[:k])
    _, cpu_stat, cpu_margin = cpu._router_pass(u8_k)
    cpu_stat = cpu_stat.numpy()
    cpu_margin = cpu_stat if cpu_margin is None else cpu_margin.numpy()
    record = {"phase": "cascade_cpu", "router": router,
              "cleanup": "device" if post else "host",
              "card": stat[:k].tolist(), "cpu": cpu_stat.tolist()}
    if router != "disagree":
        card_m, cpu_m = margin[:k], cpu_margin
        gap = np.abs(card_m - cpu_m)
        bound = CASCADE_MARGIN_RTOL * np.abs(cpu_m) + CASCADE_MARGIN_ATOL
        record.update(card_margin=card_m.tolist(), cpu_margin=cpu_m.tolist(),
                      margin_gap=gap.tolist(), margin_bound=bound.tolist())
        if (gap > bound).any():
            raise AssertionError(f"cascade {router}: card margin "
                                 f"{card_m.tolist()} against the CPU's "
                                 f"{cpu_m.tolist()}, beyond {bound.tolist()}")
    if router != "margin":
        card_s, card_c = (m[:k] for m in router_masks(torch, eng, u8_dev))
        cpu_s, cpu_c = router_masks(torch, cpu, u8_k)
        slack = ((card_s != cpu_s).reshape(k, -1).sum(1)
                 + (card_c != cpu_c).reshape(k, -1).sum(1))
        if not np.array_equal((card_s != card_c).reshape(k, -1).sum(1),
                              stat[:k]):
            raise AssertionError(f"cascade {router}: the card's statistic "
                                 f"is not its models' disagreement")
        gap = np.abs(stat[:k] - cpu_stat)
        record.update(disagree_gap=gap.tolist(), disagree_bound=slack.tolist())
        if (gap > slack).any():
            raise AssertionError(f"cascade {router}: card disagreement "
                                 f"{stat[:k].tolist()} against the CPU's "
                                 f"{cpu_stat.tolist()}, beyond {slack.tolist()}")
    log(record)
    del cpu, registry
    return total, stat, margin, eng


def cascade_phase(torch, np, dev, card):
    """Phase 17: the confidence cascade at batch CASCADE_BATCH for each
    router, with host and device cleanup; its entry points and the TCP
    service; its times.  Returns the counted calls' launches by kernel."""
    from unetseg_tpu_torch import checkpoint, engine, service
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import native, raw as raw_io

    n = CASCADE_BATCH
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        fb_ckpt, _ = flagship_checkpoint(torch, np,
                                         os.path.join(tmp, "flagship"), dev)
        in_dir = os.path.join(tmp, "in")
        os.makedirs(in_dir)
        paths = write_raws(raw_io, synth_slice, np, in_dir, n, 768)
        u8 = np.stack([native.preprocess_u8(np.asarray(raw_io.read_raw(
            p, 768, 768)), 512) for p in paths])
        u8_dev = torch.from_numpy(u8).to(dev)
        params = {k: checkpoint.load(c) for k, c in (
            ("student", CKPT), ("fallback", fb_ckpt), ("co", ROBUST_CKPT))}
        refs = {}
        for post in (False, True):
            st = engine.InferenceEngine(*params["student"], device=dev,
                                        device_postprocess=post)
            fb = engine.InferenceEngine(*params["fallback"], device=dev,
                                        device_postprocess=post)
            refs[post] = (st.to_host(st.infer(u8))(),
                          fb.to_host(fb.infer(u8))(), fb)
            # Batch 128 against the batch the kernels are held to their
            # plain versions at (phase 10's check_k6 on the flagship's
            # trunk at FLAGSHIP_BATCH): the same masks, row for row.
            for (got, e), name in zip(((refs[post][0], st),
                                       (refs[post][1], fb)),
                                      ("student", "fallback")):
                chunked = np.concatenate([e.to_host(e.infer(
                    u8[i:i + FLAGSHIP_BATCH]))() for i in range(
                        0, n, FLAGSHIP_BATCH)])
                differ = int((chunked != got).sum())
                log({"phase": "cascade_batch_invariance", "model": name,
                     "cleanup": "device" if post else "host", "batch": n,
                     "chunk": FLAGSHIP_BATCH, "differing_pixels": differ})
                if differ:
                    raise AssertionError(
                        f"cascade: the {name}'s masks at batch {n} differ "
                        f"from its masks in chunks of {FLAGSHIP_BATCH} at "
                        f"{differ} pixels")
        engines = {}
        for router in CASCADE_ROUTERS:
            for post in (False, True):
                launches, stat, margin, eng = cascade_router(
                    torch, np, router, post, params, u8, u8_dev, refs, dev,
                    card)
                total = add_launches(total, launches)
                if not post:
                    engines[router] = (eng, stat, margin)
                torch.cuda.empty_cache()
        del refs

        # ms per batch by CUDA events, host cleanup.
        plain = engine.InferenceEngine(*params["student"], device=dev)
        plain.compile(n)
        times = {"plain": time_ms(torch, lambda: plain._pipeline(u8_dev), 10)}
        for router, (eng, stat, margin) in engines.items():
            times[router] = time_ms(torch, lambda: eng._router_pass(u8_dev),
                                    10)
        eng = engines["margin"][0]
        for b in CASCADE_BUCKETS:
            times[f"fallback_{b}"] = time_ms(
                torch, lambda: eng._fallback_pass(u8_dev[:b]), 5)
        walls = {}
        for router, (eng, stat, margin) in engines.items():
            eng.cascade_threshold = (CASCADE_MARGIN if router == "margin"
                                     else CASCADE_DISAGREE_PX)
            eng.cascade_margin_threshold = CASCADE_MARGIN
            eng.infer_cascade(u8)
            t0 = time.perf_counter()
            _, _, routed = eng.infer_cascade(u8)
            walls[router] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                             "routed": routed}
            if routed != default_routed(np, router, stat, margin):
                raise AssertionError(f"cascade {router}: {routed} routed at "
                                     f"the REPL's defaults")
        stats = {r: (stat, margin) for r, (_, stat, margin)
                 in engines.items()}
        log({"phase": "cascade_time", "batch": n, "ms_per_batch": times,
             "infer_cascade_at_defaults": walls,
             "defaults": {"margin": CASCADE_MARGIN,
                          "disagree_px": CASCADE_DISAGREE_PX}, **card})
        del engines, plain, eng
        torch.cuda.empty_cache()

        # The entry points under each router, host cleanup, the REPL's
        # default thresholds.
        for router in CASCADE_ROUTERS:
            kw = dict(cascade_ckpt=fb_ckpt, cascade_router=router,
                      cascade_co_ckpt=ROBUST_CKPT,
                      cascade_threshold=CASCADE_MARGIN if router == "margin"
                      else CASCADE_DISAGREE_PX)
            if not engine.initialize_engine(
                    CKPT, log_dir=os.path.join(tmp, "log"), device=dev, **kw):
                raise AssertionError(f"cascade {router}: initialize_engine "
                                     f"returned False")
            eng = engine.get_engine()
            out = os.path.join(tmp, f"batch_{router}")
            reset_all_launches()
            t0 = time.perf_counter()
            ok, failed = engine.process_batch(paths, 768, 768, [out] * n,
                                              batch_size=n, tier="full")
            wall = time.perf_counter() - t0
            launches = all_launches()
            total = add_launches(total, launches)
            with open(engine.GLOBAL_LOG.jsonl_path) as f:
                routed = [json.loads(line) for line in f][-1]["cascade_routed"]
            if (ok, failed) != (n, 0):
                raise AssertionError(f"cascade {router} process_batch: {ok} "
                                     f"ok, {failed} failed")
            router_pass, fallback_pass = cascade_pass_launches(
                router, False, eng.model)
            want = add_launches(router_pass, fallback_pass if routed else {})
            if launches != want or routed != default_routed(
                    np, router, *stats[router]):
                raise AssertionError(f"cascade {router} process_batch: "
                                     f"{routed} routed, launches {launches}, "
                                     f"want {want}")
            names = set(os.listdir(out))
            for p in paths:
                base = os.path.basename(p)[:-len(".raw")]
                if not {base + a for a in ARTIFACTS[:3]} <= names:
                    raise AssertionError(f"cascade {router}: {base} lacks "
                                         f"artifacts")
            check_artifacts(out, os.path.basename(
                paths[min(17, n - 1)])[:-len(".raw")])
            single = os.path.join(tmp, f"single_{router}")
            if not engine.process_single_image(paths[3], 768, 768, single):
                raise AssertionError(f"cascade {router}: "
                                     f"process_single_image failed")
            check_artifacts(single, "slice_003")
            log({"phase": "cascade_entry_points", "router": router,
                 "process_batch_s": wall, "routed": routed,
                 "artifacts": len(names), "launches": launches,
                 "init_forwards": eng.forwards, **card})
            engine.cleanup_resources()
            torch.cuda.empty_cache()

        # The TCP service: init with the cascade fields, one directory.
        svc_in = os.path.join(tmp, "svc_in")
        os.makedirs(svc_in)
        for p in paths[:N_CASCADE_SERVICE]:
            shutil.copy(p, svc_in)
        svc = service.SegmentationService(port=0, device=dev)
        addr = svc.start()
        try:
            resps = []
            for req in ({"cmd": "init", "cache": CKPT, "cascade": fb_ckpt,
                         "cascade_router": "both", "cascade_co": ROBUST_CKPT,
                         "cascade_threshold": CASCADE_DISAGREE_PX,
                         "cascade_margin_threshold": CASCADE_MARGIN},
                        {"cmd": "process", "path": svc_in, "width": 768,
                         "height": 768,
                         "output_dir": os.path.join(tmp, "svc_out")},
                        {"cmd": "status"}, {"cmd": "shutdown"}):
                resps.append(service.request(addr, req, timeout=300))
                if not resps[-1].get("ok"):
                    raise AssertionError(f"cascade service {req['cmd']}: "
                                         f"{resps[-1]}")
        finally:
            svc.stop()
        if resps[1]["processed"] != N_CASCADE_SERVICE or resps[1]["failed"]:
            raise AssertionError(f"cascade service: {resps[1]}")
        log({"phase": "cascade_service", "responses": resps})
    return total


def pure_classes_json(decoded, base, w, h) -> bytes:
    """``{base}_classes.json`` of one decoded mask by the pure path
    (``io/contours_py`` + ``io/jsonfmt``)."""
    import numpy as np

    from unetseg_tpu_torch.io import contours_py, jsonfmt

    labeled = []
    for idx, cls in enumerate((1, 2)):
        cs = contours_py.extract_contours(
            np.where(decoded == cls, 255, 0).astype(np.uint8))
        cs = contours_py.map_contour_points(cs, w / decoded.shape[1],
                                            h / decoded.shape[0])
        labeled += [(cls, idx, c) for c in cs]
    return jsonfmt.contour_json_bytes_labeled(labeled, base, w, h)


def check_pure(pool, items):
    """Every (file, decoded mask, base, w, h) of ``items``: the file's
    bytes equal the pure path's.  Returns how many shapes of each class
    the files hold."""
    futures = [(path, pool.submit(pure_classes_json, m, base, w, h))
               for path, m, base, w, h in items]
    shapes = {1: 0, 2: 0}
    for path, fut in futures:
        with open(path, "rb") as f:
            got = f.read()
        if got != fut.result():
            raise AssertionError(f"{path}: not the pure path's bytes")
        for shape in json.loads(got)["shapes"]:
            shapes[shape["label"]] += 1
    return shapes


def check_compat(np, raw_path, u8, out, bases, cdir):
    """Phase 18's compat checks: ``compat.preprocess_raw`` writes
    ``native.preprocess_u8``'s pixels; ``compat.process_single_mask`` on the
    engine's mask, size JSON and normalized PNG of the first slice with
    contours writes the engine's contour JSON, byte for byte, and its
    overlay's pixels."""
    from unetseg_tpu_torch import compat
    from unetseg_tpu_torch.io import png

    size = PER_CLASS_RAW
    if not compat.preprocess_raw(raw_path, os.path.join(cdir, "n.png"),
                                 os.path.join(cdir, "s.json"), size, size):
        raise AssertionError("compat.preprocess_raw failed")
    if not np.array_equal(png.read_png_gray(os.path.join(cdir, "n.png")),
                          u8):
        raise AssertionError("compat: the normalized PNG is not "
                             "native.preprocess_u8's pixels")
    b0 = next((b for b in bases if os.path.exists(os.path.join(
        out, b + ".json"))), None)
    if b0 is None:
        raise AssertionError("compat: no slice has contours")
    compat.process_single_mask(
        os.path.join(out, b0 + "_mask.png"), cdir,
        os.path.join(out, b0 + "_original_sizes.json"),
        os.path.join(out, b0 + "_normalized.png"), b0)
    compare_dirs(out, cdir, [b0 + ".json"])
    if not np.array_equal(
            png.read_png_bgr(os.path.join(cdir, b0 + "_contour_overlay.png")),
            png.read_png_bgr(os.path.join(out, b0 + "_contour_overlay.png"))):
        raise AssertionError("compat: the overlay's pixels differ from the "
                             "engine's")


def per_class_model(torch, np, name, ckpt, paths, win_raw, tmp, dev, card,
                    pool):
    """Phase 18 for one model; returns the counted runs' launches."""
    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.ops import preprocess
    from unetseg_tpu_torch.parallel import pipeline

    n, size, batch = len(paths), PER_CLASS_RAW, PER_CLASS_BATCH
    total = {}
    if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log"),
                                    device=dev):
        raise AssertionError(f"per_class {name}: initialize_engine failed")
    eng = engine.get_engine()
    out = os.path.join(tmp, f"{name}_batch")
    reset_all_launches()
    forwards0 = eng.forwards
    t0 = time.perf_counter()
    ok, failed = engine.process_batch(paths, size, size, [out] * n,
                                      batch_size=batch, tier="full",
                                      per_class=True)
    wall = time.perf_counter() - t0
    pb_launches, forwards = all_launches(), eng.forwards - forwards0
    total = add_launches(total, pb_launches)
    want = add_launches({k: v * forwards for k, v in
                         MASKS_LAUNCHES[name].items()}, {"cc_label": 0})
    if (ok, failed) != (n, 0) or pb_launches != want:
        raise AssertionError(f"per_class {name} process_batch: {ok} ok, "
                             f"{failed} failed, launches {pb_launches}, want "
                             f"{want}")
    u8 = np.stack([native.preprocess_u8(np.asarray(raw_io.read_raw(
        p, size, size)), 512) for p in paths])
    decoded = np.concatenate([eng.to_host(eng._masks(eng._put(
        u8[i:i + batch])))() for i in range(0, n, batch)])
    bases = [os.path.basename(p)[:-len(".raw")] for p in paths]
    items = [(os.path.join(out, b + "_classes.json"), decoded[i], b, size,
              size) for i, b in enumerate(bases)]

    # process_single_image: plain, TTA and window mode.
    single = {}
    for mode, kw in (("plain", {}), ("tta", {"tta": True}),
                     ("window", {"window": PER_CLASS_WINDOW})):
        d = os.path.join(tmp, f"{name}_single_{mode}")
        raw_path, w = (win_raw, PER_CLASS_WINDOW_RAW) if mode == "window" \
            else (paths[0], size)
        t0 = time.perf_counter()
        if not engine.process_single_image(raw_path, w, w, d, per_class=True,
                                           **kw):
            raise AssertionError(f"per_class {name} {mode}: failed")
        single[mode] = time.perf_counter() - t0
        base = os.path.basename(raw_path)[:-len(".raw")]
        if mode == "window":
            raw = np.asarray(raw_io.read_raw(raw_path, w, w))
            with torch.inference_mode():
                u8_dev = preprocess.normalize_u8(eng._put(np.array(raw)))
            m = eng.to_host(eng.infer_tiled(u8_dev, PER_CLASS_WINDOW)[None])()
        elif mode == "tta":
            m = eng.to_host(eng.infer_tta(u8[0])[None])()
        else:
            m = eng.to_host(eng._masks(eng._put(u8[:1])))()
        items.append((os.path.join(d, base + "_classes.json"), m[0], base,
                      w, w))
    shapes = check_pure(pool, items)

    if name == "slim4":
        check_compat(np, paths[0], u8[0], out, bases,
                     os.path.join(tmp, f"{name}_compat"))
    engine.cleanup_resources()

    # The study runner, with and without per-class JSON.
    params, cfg = checkpoint.load(ckpt)
    seng = pipeline.study_engine(params, cfg, dev)
    seng.compile(batch)
    for pc in (True, False):
        sdir = os.path.join(tmp, f"{name}_study_{pc}")
        reset_all_launches()
        forwards0 = seng.forwards
        pipeline.run_study(params, cfg, paths, size, size,
                           batch_size=batch, host_preprocess=True,
                           artifacts="full", out_dir=sdir, per_class=pc,
                           device=dev)
        s_launches, s_forwards = all_launches(), seng.forwards - forwards0
        total = add_launches(total, s_launches)
        want = add_launches({k: v * s_forwards for k, v in
                             MASKS_LAUNCHES[name].items()}, {"cc_label": 0})
        if s_launches != want or s_forwards != -(-n // batch):
            raise AssertionError(f"per_class {name} study: {s_forwards} "
                                 f"forwards, launches {s_launches}")
        names = sorted(os.listdir(sdir))
        want_names = sorted(f for f in os.listdir(out)
                            if pc or not f.endswith("_classes.json"))
        if names != want_names:
            raise AssertionError(f"per_class {name} study (per_class={pc}) "
                                 f"wrote other files than process_batch")
        compare_dirs(out, sdir, names)

    # The all-device mode refuses it, as the JAX engine does.
    if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log"),
                                    device=dev, device_postprocess=True):
        raise AssertionError("per_class: device-cleanup init failed")
    refused = not engine.process_single_image(
        paths[0], size, size, os.path.join(tmp, "refused"), per_class=True)
    try:
        engine.process_batch(paths[:1], size, size,
                             [os.path.join(tmp, "refused")], per_class=True)
        refused = False
    except ValueError as e:
        refused = refused and "per_class" in str(e)
    engine.cleanup_resources()
    if not refused:
        raise AssertionError("per_class: device cleanup was not refused")
    log({"phase": "per_class", "model": name, "slices": n, "batch": batch,
         "process_batch_s": wall, "launches": pb_launches,
         "forwards": forwards, "classes_jsons": len(items), "shapes_by_class": shapes,
         "single_image_s": single, "device_postprocess_refused": refused,
         **card})
    return total


def per_class_study_time(torch, np, name, ckpt, paths, tmp, dev, card):
    """Study slices/s with and without per-class JSON on ``paths``
    (PER_CLASS_TIME_SLICES 512² RAWs) at PER_CLASS_BATCH, artifacts "full":
    a warm round, then PER_CLASS_REPEATS rounds, each mode once a round and
    the order alternating, so drift falls on both modes alike."""
    from unetseg_tpu_torch import checkpoint
    from unetseg_tpu_torch.parallel import pipeline

    size, batch = PER_CLASS_RAW, PER_CLASS_BATCH
    params, cfg = checkpoint.load(ckpt)
    pipeline.study_engine(params, cfg, dev).compile(batch)
    rates, walls = {True: [], False: []}, {True: [], False: []}
    out = os.path.join(tmp, f"{name}_time")
    for r in range(PER_CLASS_REPEATS + 1):
        for pc in ((True, False) if r % 2 else (False, True)):
            res = pipeline.run_study(params, cfg, paths, size, size,
                                     batch_size=batch, host_preprocess=True,
                                     artifacts="full", out_dir=out,
                                     per_class=pc, device=dev)
            shutil.rmtree(out)
            if res.n_slices != len(paths):
                raise AssertionError(f"per_class {name} timing study: "
                                     f"{res.n_slices} slices")
            if r:
                rates[pc].append(res.slices_per_sec)
                walls[pc].append(res.wall_s)
    med = {pc: float(np.median(v)) for pc, v in rates.items()}
    log({"phase": "per_class_study_time", "model": name,
         "slices": len(paths), "batch": batch, "repeats": PER_CLASS_REPEATS,
         "slices_per_sec": {"per_class": rates[True],
                            "without": rates[False]},
         "wall_s": {"per_class": walls[True], "without": walls[False]},
         "median_slices_per_sec": {"per_class": med[True],
                                   "without": med[False]},
         "per_class_cost": 1.0 - med[True] / med[False],
         "host_cpus": os.cpu_count(), **card})


def per_class_phase(torch, np, dev, card):
    """Phase 18: per-class JSON (BASELINE config 2) for slim4 and the seeded
    flagship; returns the counted runs' launches by kernel."""
    import multiprocessing

    from unetseg_tpu_torch import checkpoint
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import preprocess

    total = {}
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            max_workers=PURE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for d in ("in", "win"):
            os.makedirs(os.path.join(tmp, d))
        paths = write_raws(raw_io, synth_slice, np, os.path.join(tmp, "in"),
                           PER_CLASS_SLICES, PER_CLASS_RAW)
        win_raw = write_raws(raw_io, synth_slice, np,
                             os.path.join(tmp, "win"), 1,
                             PER_CLASS_WINDOW_RAW)[0]
        flag_ckpt, _ = flagship_checkpoint(torch, np,
                                           os.path.join(tmp, "flagship"), dev)
        # its head bias centred on this phase's own 512² RAWs
        centre_head_bias(torch, checkpoint, registry, native, raw_io,
                         preprocess, flag_ckpt, paths[:4], PER_CLASS_RAW, dev)
        for name, ckpt in (("slim4", CKPT), ("flagship", flag_ckpt)):
            total = add_launches(total, per_class_model(
                torch, np, name, ckpt, paths, win_raw, tmp, dev, card, pool))
            torch.cuda.empty_cache()
        time_paths = study_raws(np, os.path.join(tmp, "time"),
                                PER_CLASS_TIME_SLICES, PER_CLASS_RAW)
        for name, ckpt in (("slim4", CKPT), ("flagship", flag_ckpt)):
            per_class_study_time(torch, np, name, ckpt, time_paths, tmp, dev,
                                 card)
            torch.cuda.empty_cache()
    return total



# Phase 19: the model zoo (P10).  (H, W, C, D) of UNet++'s 30 3x3 convs at
# 512² in forward order (the backbone's 10, then X(i, j) for j = 1..4 over
# i, conv1 over (j + 1) * c_i channels, conv2), and Attention U-Net's 18
# (the flagship's 16 and its last level's two, which K6 does not take).
UNETPP_CONVS = [(512, 512, 1, 64), (512, 512, 64, 64), (256, 256, 64, 128),
                (256, 256, 128, 128), (128, 128, 128, 256),
                (128, 128, 256, 256), (64, 64, 256, 512), (64, 64, 512, 512),
                (32, 32, 512, 1024), (32, 32, 1024, 1024),
                (512, 512, 128, 64), (512, 512, 64, 64),
                (256, 256, 256, 128), (256, 256, 128, 128),
                (128, 128, 512, 256), (128, 128, 256, 256),
                (64, 64, 1024, 512), (64, 64, 512, 512),
                (512, 512, 192, 64), (512, 512, 64, 64),
                (256, 256, 384, 128), (256, 256, 128, 128),
                (128, 128, 768, 256), (128, 128, 256, 256),
                (512, 512, 256, 64), (512, 512, 64, 64),
                (256, 256, 512, 128), (256, 256, 128, 128),
                (512, 512, 320, 64), (512, 512, 64, 64)]
ATTENTION_CONVS = FLAGSHIP_CONVS + [(512, 512, 128, 64), (512, 512, 64, 64)]
# The shapes these two give K1 that no model served before them: D = 64 at
# 512² (bn = 64) with C = 128 .. 320, and C = 192, 320, 384, 512 (at 256²),
# 768; parity at ZOO_PARITY_BATCH, times at ZOO_BATCH.
ZOO_NEW_CONVS = sorted(set(UNETPP_CONVS + ATTENTION_CONVS)
                       - set(FLAGSHIP_CONVS))
ZOO_PARITY_BATCH = 2
ZOO_BATCH = 32
N_ZOO = 64      # 768² RAWs of each model's process_batch: two batches
# name -> ModelConfig keywords (full width and depth: base 64, depth 4)
ZOO_MODELS = {"unetpp": {"arch": "unetpp"},
              "unetpp_ds": {"arch": "unetpp", "deep_supervision": True},
              "attention_unet": {"arch": "attention_unet"}}
# The importers' model: the flagship ModelConfig() (keywords: none).
IMPORT_KW: dict = {}
# Card-vs-CPU mask agreement of each family (every differing pixel must
# also lie within CPU_TIE_ULPS).  UNet++'s heads read X(0, j) after
# 2 (j + 1) convs at full resolution: its centred seeded heads leave about
# 0.55% of two slices' pixels differing between the card and the CPU, all
# within 2 ulps of a tie (PERF.md §6), under the flagship's 0.995.
ZOO_AGREEMENT = {"unetpp": 0.99, "attention_unet": CPU_AGREEMENT}
# K1 and K2 launches per forward of each family.
ZOO_LAUNCHES = {"unetpp": {"conv3x3_bias_act": 23,
                           "conv3x3_bias_act_small_c": 7,
                           "conv3x3_bias_act_f32": 0},
                "attention_unet": {"conv3x3_bias_act": 14,
                                   "conv3x3_bias_act_small_c": 4,
                                   "conv3x3_bias_act_f32": 0}}


def zoo_conv_shapes(torch, F, conv, dev, card):
    """Phase 19's conv checks: every served shape of both families has an
    instantiation without spills; the new shapes against the plain conv
    at batch ``ZOO_PARITY_BATCH``, then timed at ``ZOO_BATCH`` beside the
    bound and ``F.conv2d``.  Returns {variant: max abs err}."""
    built = {(r["bkc"], r["bn"], r["fold"]): r for r in conv.resources()}
    plans = {}
    for h, w, c, d in sorted(set(UNETPP_CONVS + ATTENTION_CONVS)):
        p = conv.tile_plan(ZOO_BATCH, h, w, c + -c % 16, d)
        r = built.get((p.bkc, p.bn, p.fold))
        plans[f"{h}x{w}x{c}->{d}"] = [p.bkc, p.bn, p.fold]
        if r is None or r["spill_bytes"]:
            raise AssertionError(f"conv ({h}, {w}, {c}, {d}): instantiation "
                                 f"{p.bkc, p.bn, p.fold} missing or spills")
    log({"phase": "zoo_conv_plans", "bkc_bn_fold": plans})
    worst = check_parity(torch, conv, dev, ZOO_NEW_CONVS, ZOO_PARITY_BATCH)
    log({"phase": "zoo_conv_parity", "shapes": ZOO_NEW_CONVS,
         "batch": ZOO_PARITY_BATCH, "max_abs_err": worst})
    for i, shape in enumerate(ZOO_NEW_CONVS):
        x, w, b = conv_inputs(torch, shape, ZOO_BATCH, dev, seed=600 + i)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        k_ms = time_ms(torch, lambda: conv.conv3x3_bias_act(x, w, b), 5)
        lib_ms = time_ms(torch, lambda: F.conv2d(xc, wc, b, padding=1), 5)
        bound, f_ms, b_ms = conv_bound(shape, ZOO_BATCH)
        p = conv.tile_plan(ZOO_BATCH, *shape)
        log({"phase": "zoo_conv_time", "shape": [ZOO_BATCH, *shape],
             "variant": conv.variant(shape[2], torch.bfloat16), "bkc_bn_fold": [p.bkc, p.bn,
                                                           p.fold],
             "ms": k_ms, "library_ms": lib_ms, "bound_ms": bound,
             "share_of_bound": bound / k_ms, "flop_ms": f_ms, "byte_ms": b_ms,
             **card})
        del x, w, b, xc, wc
    torch.cuda.empty_cache()
    return worst


def zoo_model(torch, np, name, ckpt, paths, tmp, dev, card):
    """Phase 19 for one model: ``process_batch`` (batch ``ZOO_BATCH``, tier
    full) and ``process_single_image`` with host and with device cleanup,
    launches exact, artifacts byte-equal between the two cleanups; masks on
    two slices against the CPU path; ms per batch, slices/s and the device
    time by kernel.  Returns the counted runs' launches by kernel."""
    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import dec1, preprocess
    from unetseg_tpu_torch.ops.decode import decode_mask

    params, cfg = checkpoint.load(ckpt)
    per_forward = ZOO_LAUNCHES[cfg.arch]
    size = 768
    total = {}
    outs = {}
    for device_post in (False, True):
        tag = "device" if device_post else "host"
        if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log"),
                                        device_postprocess=device_post):
            raise AssertionError(f"{name}: initialize_engine returned False")
        eng = engine.get_engine()
        out = os.path.join(tmp, f"{name}_{tag}")
        single = os.path.join(tmp, f"{name}_{tag}_single")
        reset_all_launches()
        forwards0 = eng.forwards
        t0 = time.perf_counter()
        ok, failed = engine.process_batch(paths, size, size, [out] * len(paths),
                                          batch_size=ZOO_BATCH, tier="full")
        batch_s = time.perf_counter() - t0
        if (ok, failed) != (len(paths), 0):
            raise AssertionError(f"{name}: process_batch {ok} ok, "
                                 f"{failed} failed")
        if not engine.process_single_image(paths[3], size, size, single):
            raise AssertionError(f"{name}: process_single_image failed")
        launches, forwards = all_launches(), eng.forwards - forwards0
        engine.cleanup_resources()
        want = {k: v * forwards for k, v in per_forward.items()}
        want.update(dec1_fused=0, cc_label=2 * forwards if device_post else 0)
        names = os.listdir(out)
        contours = sum(n.endswith(".json") and not n.endswith("_sizes.json")
                       for n in names)
        log({"phase": "zoo_main_path", "model": name, "cleanup": tag,
             "process_batch_s": batch_s, "forwards": forwards,
             "launches": launches, "artifacts": len(names),
             "contour_jsons": contours, **card})
        if launches != want or forwards < -(-len(paths) // ZOO_BATCH) + 1:
            raise AssertionError(f"{name} {tag}: {forwards} forwards, "
                                 f"launches {launches}, want {want}")
        # A slice whose cleaned mask keeps no organ writes no overlay and
        # no contour JSON: seeded UNet++ heads paint speckle that the
        # cleanup's open and 6%-of-area rule may clear (logged, not held).
        if len(names) < 3 * len(paths):
            raise AssertionError(f"{name} {tag}: {len(names)} artifacts "
                                 f"for {len(paths)} slices")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        outs[device_post] = (out, single)
    for a, b in zip(outs[False], outs[True]):
        names = sorted(os.listdir(a))
        if names != sorted(os.listdir(b)):
            raise AssertionError(f"{name}: host and device cleanup wrote "
                                 f"different artifact sets")
        compare_dirs(a, b, names)

    # Two slices on the card and on the CPU (the plain convs).
    eng = engine.InferenceEngine(params, cfg, dev)
    u8_32 = torch.from_numpy(np.stack([native.preprocess_u8(np.asarray(
        raw_io.read_raw(p, size, size)), cfg.image_size)
        for p in paths[:ZOO_BATCH]]))
    got = eng._masks(u8_32[:2].to(dev)).cpu()
    cpu_model = registry.build(params, cfg, device="cpu")
    with torch.inference_mode():
        lg, ab = head_sums(torch, cpu_model, preprocess.model_input_from_u8(
            u8_32[:2])[..., None])
    want = decode_mask(lg, cfg.num_classes)
    differ = got != want
    agree = 1 - differ.float().mean().item()
    ulps = fewest_ulps(differ, lambda r: dec1.near_tie_sums(lg, ab, r))
    del cpu_model, lg, ab

    u8_d = u8_32.to(dev)
    pipe_ms = time_ms(torch, lambda: eng._pipeline(u8_d), 5)
    prof = profile_pipeline(torch, lambda: eng._pipeline(u8_d), iters=3,
                            top=12)
    del prof["ops"]
    log({"phase": "zoo_model", "model": name, "config": ZOO_MODELS[name],
         "cpu_mask_agreement": agree, "differing_pixels_within_ulps": ulps,
         "class_share": (torch.bincount(got.flatten().long(), minlength=3)
                         / got.numel()).tolist(),
         "batch": ZOO_BATCH, "ms_per_batch": pipe_ms,
         "slices_per_s": ZOO_BATCH / pipe_ms * 1e3, "profile": prof, **card})
    bar = ZOO_AGREEMENT[cfg.arch]
    if agree < bar or ulps is None or ulps > CPU_TIE_ULPS:
        raise AssertionError(f"{name}: card vs CPU masks agree on {agree} "
                             f"(bar {bar}), differing pixels within "
                             f"{ulps} ulps (bar {CPU_TIE_ULPS})")
    del eng, u8_d
    torch.cuda.empty_cache()
    return total


def zoo_importers(torch, np, tmp, paths, dev, card):
    """Phase 19's importers: a full-width canonical torch UNet with BN
    statistics after every 3x3 conv, through the ``.pt`` route
    (``params_from_torch_state_dict``, BN folded, ``checkpoint.save``) and
    through an ``.onnx`` the port writes (``write_onnx_graph``, live
    BatchNormalization nodes) and ``load_onnx``; both trees bit-equal, both
    checkpoints (head bias centred) served by ``initialize_engine`` with
    bit-equal masks."""
    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import import_onnx, import_torch, registry
    from unetseg_tpu_torch.ops import preprocess

    cfg = ModelConfig(**IMPORT_KW)
    torch.manual_seed(19)
    model = import_torch.build_torch_unet(cfg)
    # He-normal weights, as a trained UNet's keep their scale through the
    # depth (torch's default init shrinks it until the logits are flat)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                torch.nn.init.kaiming_normal_(m.weight, nonlinearity="relu")
                m.bias.normal_(0.0, 0.1)
    sd = model.state_dict()
    sd.update({k: torch.from_numpy(v) for k, v in bn_state(np, sd, 19).items()})
    pt = os.path.join(tmp, "unet_bn.pt")
    torch.save(sd, pt)
    sd = torch.load(pt, map_location="cpu")
    pt_tree = fold_bn_tree(import_torch, checkpoint.params_from_torch_state_dict(
        sd, cfg), sd)
    onnx_path = os.path.join(tmp, "unet_bn.onnx")
    import_onnx.write_onnx_graph(onnx_path, *unet_onnx_graph(
        np, {k: v.numpy() for k, v in sd.items()}, cfg))
    onnx_tree, onnx_cfg = import_onnx.load_onnx(onnx_path)
    pt_leaves, onnx_leaves = tree_leaves(pt_tree), tree_leaves(onnx_tree)
    same_tree = len(pt_leaves) == len(onnx_leaves) and all(
        a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                              b.view(np.uint32))
        for a, b in zip(pt_leaves, onnx_leaves))
    inferred = ("depth", "base_channels", "in_channels", "num_classes")
    if any(getattr(onnx_cfg, f) != getattr(cfg, f) for f in inferred):
        raise AssertionError(f"load_onnx inferred {onnx_cfg}, want {cfg}")
    masks = {}
    for route, tree in (("pt", pt_tree), ("onnx", onnx_tree)):
        ckpt = os.path.join(tmp, "models", f"imported_{route}.ckpt")
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        checkpoint.save(ckpt, tree, cfg)
        # seeded weights paint one class: centre both heads alike
        centre_head_bias(torch, checkpoint, registry, native, raw_io,
                         preprocess, ckpt, paths[:4], 768, dev)
        if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log")):
            raise AssertionError(f"initialize_engine({route}) returned False")
        eng = engine.get_engine()
        out = os.path.join(tmp, f"imported_{route}")
        ok, failed = engine.process_batch(paths[:ZOO_BATCH], 768, 768,
                                          [out] * ZOO_BATCH,
                                          batch_size=ZOO_BATCH)
        u8 = np.stack([native.preprocess_u8(np.asarray(raw_io.read_raw(
            p, 768, 768)), cfg.image_size) for p in paths[:4]])
        masks[route] = eng.to_host(eng.infer(u8))()
        engine.cleanup_resources()
        if (ok, failed) != (ZOO_BATCH, 0):
            raise AssertionError(f"{route}: process_batch {ok} ok, "
                                 f"{failed} failed")
    log({"phase": "zoo_importers", "config": "ModelConfig() + BN",
         "onnx_config": {"depth": onnx_cfg.depth,
                         "base_channels": onnx_cfg.base_channels},
         "bn_groups": sum(k.endswith("_bn.weight") for k in sd),
         "trees_bit_equal": same_tree,
         "masks_bit_equal": bool(np.array_equal(masks["pt"],
                                                masks["onnx"])),
         "class_share": np.bincount(masks["pt"].ravel(), minlength=3).tolist(),
         **card})
    if not same_tree or not np.array_equal(masks["pt"], masks["onnx"]):
        raise AssertionError("the .pt and .onnx routes differ")


def tree_leaves(tree) -> list:
    """The arrays of a parameter tree, in key order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in tree_leaves(v)]
    return [tree]


def zoo_phase(torch, np, dev, card):
    """Phase 19: UNet++ (with and without deep supervision) and Attention
    U-Net at full width, one TTA call and the window images for Attention
    U-Net, and the importers.  Returns ({kernel: counted launches},
    {variant: worst conv error})."""
    import torch.nn.functional as F

    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import conv, preprocess

    worst = zoo_conv_shapes(torch, F, conv, dev, card)
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "in"))
        paths = write_raws(raw_io, synth_slice, np, os.path.join(tmp, "in"),
                           N_ZOO, 768)
        ckpts = {}
        for name, kw in ZOO_MODELS.items():
            ckpts[name] = os.path.join(tmp, "models", f"{name}.ckpt")
            os.makedirs(os.path.dirname(ckpts[name]), exist_ok=True)
            checkpoint.create(ckpts[name], ModelConfig(**kw), seed=0)
            centre_head_bias(torch, checkpoint, registry, native, raw_io,
                             preprocess, ckpts[name], paths[:4], 768, dev)
            for k, v in zoo_model(torch, np, name, ckpts[name], paths, tmp,
                                  dev, card).items():
                total[k] = total.get(k, 0) + v
        raw_path = os.path.join(tmp, "tta_slice.raw")
        raw_io.write_raw(raw_path, synth_slice(np.random.default_rng(42),
                                               TTA_RAW)[0])
        tta_phase(torch, np, "attention_unet", ckpts["attention_unet"],
                  raw_path, tmp, dev, card, dev, contours=False)
        cc_err = tiled_phase(torch, np, "attention_unet",
                             ckpts["attention_unet"], tmp, dev, card, dev)
        engine.cleanup_resources()
        zoo_importers(torch, np, tmp, paths, dev, card)
    torch.cuda.empty_cache()
    return total, {**worst, "cc_label": cc_err}


def bn_state(np, sd, seed):
    """BatchNorm statistics after every 3x3 conv of a canonical torch UNet
    state dict ``sd`` (``models/import_torch.py`` naming), as a BN-trained
    UNet's ``.pt`` holds them: ``<conv>_bn.weight``, ``.bias``,
    ``.running_mean``, ``.running_var``, float32, seeded."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, w in sd.items():
        if key.endswith(".weight") and tuple(w.shape[2:]) == (3, 3):
            c = w.shape[0]
            prefix = key[:-len(".weight")] + "_bn."
            for name, val in (("weight", rng.uniform(0.5, 1.5, c)),
                              ("bias", rng.uniform(-0.3, 0.3, c)),
                              ("running_mean", rng.uniform(-0.5, 0.5, c)),
                              ("running_var", rng.uniform(0.5, 2.0, c))):
                out[prefix + name] = val.astype(np.float32)
    return out


def fold_bn_tree(import_torch, params, sd):
    """The ``.pt`` route's BatchNorm: fold each ``<conv>_bn.*`` group of
    ``sd`` into its conv site of the JAX-layout tree ``params``
    (``import_torch.fold_batchnorm``, eps 1e-5), in place."""
    for key in sd:
        if not key.endswith("_bn.weight"):
            continue
        prefix = key[:-len("_bn.weight")]
        node = params
        parts = prefix.split(".")
        for part in parts[:-1]:
            node = node[int(part)] if part.isdigit() else node[part]
        bn = [sd[f"{prefix}_bn.{n}"] for n in ("weight", "bias",
                                               "running_mean", "running_var")]
        node[parts[-1]] = import_torch.fold_batchnorm(node[parts[-1]], *bn)
    return params


def unet_onnx_graph(np, sd, cfg):
    """(nodes, tensors) of the canonical UNet of ``cfg`` with the weights
    of the state dict ``sd`` for ``import_onnx.write_onnx_graph``: Conv
    (-> BatchNormalization where ``sd`` holds ``<conv>_bn.*``) -> Relu
    pairs, MaxPools, ConvTranspose + Concat decoder stages, a 1x1 head;
    tensors under the state dict's names."""
    k3 = {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]}
    nodes, tensors = [], {}

    def t(key):
        tensors[key] = np.asarray(sd[key], np.float32)
        return key

    def conv(x, prefix, attrs=k3, relu=True):
        y = prefix + ":conv"
        nodes.append(("Conv", [x, t(prefix + ".weight"), t(prefix + ".bias")],
                      [y], attrs))
        if prefix + "_bn.weight" in sd:
            nodes.append(("BatchNormalization", [y] + [
                t(f"{prefix}_bn.{n}") for n in (
                    "weight", "bias", "running_mean", "running_var")],
                [y + ":bn"], {"epsilon": 1e-5}))
            y += ":bn"
        if relu:
            nodes.append(("Relu", [y], [y + ":relu"], None))
            y += ":relu"
        return y

    x, skips = "input", []
    for i in range(cfg.depth):
        x = conv(conv(x, f"encoder.{i}.conv1"), f"encoder.{i}.conv2")
        skips.append(x)
        nodes.append(("MaxPool", [x], [x + ":pool"],
                      {"kernel_shape": [2, 2], "strides": [2, 2]}))
        x += ":pool"
    x = conv(conv(x, "bottleneck.conv1"), "bottleneck.conv2")
    for i, skip in enumerate(reversed(skips)):
        up = f"decoder.{i}.up"
        nodes.append(("ConvTranspose", [x, t(up + ".weight"), t(up + ".bias")],
                      [up + ":y"], {"kernel_shape": [2, 2], "strides": [2, 2]}))
        nodes.append(("Concat", [skip, up + ":y"], [up + ":cat"], {"axis": 1}))
        x = conv(conv(up + ":cat", f"decoder.{i}.conv1"), f"decoder.{i}.conv2")
    conv(x, "head", {"kernel_shape": [1, 1], "pads": [0, 0, 0, 0]},
         relu=False)
    return nodes, tensors


# Phase 20: the partition pool and the dp engine (P9b), for slim4 and the
# seeded flagship: the service's concurrent clients, the batch split over a
# device list that repeats the one card (the split is by position), and
# the mesh weight-space TTA.
N_CLIENTS = 8
DP_DEVICES = ("cuda:0", "cuda:0")
DP_BATCH = 128
# Phase 21: the w8a8 slim4 (P11).  Calibration as benchmarks/
# quantize_slim.py (two training batches of 8, seed 77); the kernel's
# parity shapes are phase 3's; the accuracy pool is bench.py's (seed 991,
# 32 slices); the pipeline is timed at batch 128.
W8A8_CALIB = (77, 2, 8)
W8A8_BATCH = 128
W8A8_CPU_SLICES = 2
W8A8_CPU_AGREEMENT = 0.999
# quantize.py's accuracy contract: polygon IoU against the float parent.
W8A8_POLYGON_IOU = 0.999
N_W8A8 = 32      # 768² RAWs of the entry points
K7_SOURCE = "unetseg_tpu_torch/csrc/conv3x3_s8.cu"
K7_REPLACES = ("unetseg_tpu/quantize.py:223 (_conv_w8a8: "
               "lax.conv_general_dilated; no Pallas kernel)")
PEAK_INT8_OPS = 1979e12
# K7 launches of one w8a8 slim4 forward: every 3x3 conv.
W8A8_LAUNCHES = {"conv3x3_s8": 10, "conv3x3_bias_act": 0,
                 "conv3x3_bias_act_small_c": 0, "conv3x3_bias_act_f32": 0,
                 "dec1_fused": 0}


def pool_clients(service, addr, paths, size, tmp, tag):
    """``N_CLIENTS`` concurrent clients, one single-file ``process`` each;
    returns their output dirs."""
    def one(i):
        out = os.path.join(tmp, f"{tag}_client{i}")
        resp = service.request(addr, {
            "cmd": "process", "path": paths[i], "width": size,
            "height": size, "output_dir": out}, timeout=300)
        if not resp.get("ok"):
            raise AssertionError(f"{tag} client {i}: {resp}")
        return out

    with ThreadPoolExecutor(max_workers=N_CLIENTS) as pool:
        return list(pool.map(one, range(N_CLIENTS)))


def partitions_model(torch, np, name, ckpt, paths, tmp, dev, card):
    """Phase 20 for one model; returns the counted runs' launches."""
    from unetseg_tpu_torch import checkpoint, engine, service
    from unetseg_tpu_torch.io import native, raw as raw_io

    size, per_fwd = 768, MASKS_LAUNCHES[name]
    total: dict = {}
    # make_partitioned_engines on one card: one engine
    if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log"),
                                    device=dev):
        raise AssertionError(f"{name}: initialize_engine returned False")
    parts = engine.make_partitioned_engines(4)
    if len(parts) != 1 or parts[0].devices != [dev]:
        raise AssertionError(f"{name}: make_partitioned_engines(4) on one "
                             f"card gave {[p.devices for p in parts]}")
    ref = os.path.join(tmp, f"{name}_ref")
    engine.process_batch(paths[:N_CLIENTS], size, size,
                         [ref] * N_CLIENTS, batch_size=N_CLIENTS)
    engine.cleanup_resources()

    # the service with --partitions 4: 8 concurrent clients
    svc = service.SegmentationService(port=0, partitions=4, device=str(dev))
    addr = svc.start()
    try:
        reset_all_launches()
        if not service.request(addr, {"cmd": "init", "cache": ckpt},
                               timeout=300).get("ok"):
            raise AssertionError(f"{name}: service init failed")
        base, pool = engine.get_engine(), list(svc._engines)
        t0 = time.perf_counter()
        outs = pool_clients(service, addr, paths, size, tmp, name)
        clients_s = time.perf_counter() - t0
        st = service.request(addr, {"cmd": "status"}, timeout=60)
        launches = all_launches()
        forwards = base.forwards
        service.request(addr, {"cmd": "shutdown"}, timeout=60)
    finally:
        svc.stop()
    want = {k: v * forwards for k, v in per_fwd.items()}
    want["cc_label"] = 0
    log({"phase": "partitions_service", "model": name, "pool": len(pool),
         "clients": N_CLIENTS, "clients_s": clients_s, "status": st,
         "forwards": forwards, "launches": launches})
    if len(pool) != 1 or pool[0] is not base or st["partitions"] != 4 or \
            st["processed"] != N_CLIENTS or launches != want:
        raise AssertionError(f"{name} pool service: pool {len(pool)}, "
                             f"status {st}, launches {launches} want {want}")
    for p, out in zip(paths, outs):
        base_name = os.path.basename(p)[:-len(".raw")]
        names = sorted(f for f in os.listdir(out))
        if names != sorted(f for f in os.listdir(ref)
                           if f.startswith(base_name + "_")
                           or f == base_name + ".json"):
            raise AssertionError(f"{name}: client artifacts {names}")
        compare_dirs(ref, out, names)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v

    # the dp engine over the card twice, at batch DP_BATCH
    params, cfg = checkpoint.load(ckpt)
    u8 = torch.from_numpy(np.stack([native.preprocess_u8(np.asarray(
        raw_io.read_raw(p, size, size)), 512) for p in
        (paths * (DP_BATCH // len(paths) + 1))[:DP_BATCH]])).to(dev)
    multi = engine.InferenceEngine(params, cfg, devices=list(DP_DEVICES))
    single = engine.InferenceEngine(params, cfg, device=dev)
    reset_all_launches()
    got = multi._masks(u8)
    want_masks = single._masks(u8)
    torch.cuda.synchronize()
    launches = all_launches()
    forwards = multi.forwards + single.forwards
    equal = torch.equal(got, want_masks)
    multi_ms = time_ms(torch, lambda: multi._masks(u8), 5)
    single_ms = time_ms(torch, lambda: single._masks(u8), 5)
    want = {k: v * forwards for k, v in per_fwd.items()}
    want["cc_label"] = 0
    log({"phase": "partitions_dp", "model": name, "devices": DP_DEVICES,
         "batch": DP_BATCH, "bit_equal": equal, "forwards": forwards,
         "launches": launches, "dp_ms_per_batch": multi_ms,
         "single_ms_per_batch": single_ms, **card})
    if not equal:
        raise AssertionError(f"{name}: the dp engine's masks differ from the "
                             f"one-device engine's")
    if forwards != len(DP_DEVICES) + 1 or launches != want:
        raise AssertionError(f"{name} dp: {forwards} forwards, launches "
                             f"{launches}, want {want}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v

    # the mesh weight-space TTA against the sequential form
    u8_2d = u8[0].cpu().numpy()
    reset_all_launches()
    got = multi.infer_tta(u8_2d)
    want_masks = single.infer_tta(u8_2d)
    torch.cuda.synchronize()
    launches = all_launches()
    tta_fwd = convs_per_forward(multi.model)
    want = {k: v * 2 * 8 for k, v in tta_fwd.items()}
    want.update(dec1_fused=0, cc_label=0)
    equal = torch.equal(got, want_masks)
    log({"phase": "partitions_tta", "model": name, "devices": DP_DEVICES,
         "form": multi._tta[0], "bit_equal": equal, "launches": launches})
    if not equal or multi._tta[0] != "ws" or launches != want:
        raise AssertionError(f"{name} mesh TTA: equal {equal}, launches "
                             f"{launches}, want {want}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def partitions_phase(torch, np, dev, card):
    """Phase 20 for slim4 and the seeded flagship; returns launches."""
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import raw as raw_io

    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        in_dir = os.path.join(tmp, "in")
        os.makedirs(in_dir)
        paths = write_raws(raw_io, synth_slice, np, in_dir, N_CLIENTS, 768)
        flag_ckpt, _ = flagship_checkpoint(torch, np,
                                           os.path.join(tmp, "flagship"), dev)
        for name, ckpt in (("slim4", CKPT), ("flagship", flag_ckpt)):
            for k, v in partitions_model(torch, np, name, ckpt, paths, tmp,
                                         dev, card).items():
                total[k] = total.get(k, 0) + v
            torch.cuda.empty_cache()
    return total


def s8_inputs(torch, shape, batch, device, seed):
    """Random int8 operands of K7 (K-major weights), positive scales."""
    h, w, c, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-127, 128, (batch, h, w, c), generator=g,
                      device=device, dtype=torch.int8)
    wk = torch.randint(-127, 128, (3, 3, d, c), generator=g, device=device,
                       dtype=torch.int8)
    scale = torch.rand((d,), generator=g, device=device) * 1e-3 + 1e-5
    bias = torch.randn((d,), generator=g, device=device)
    return x, wk, scale, bias


def s8_bound(shape, batch):
    """(bound ms, operations ms, bytes ms) of one K7 call: each input read
    once (int8 x and w, f32 scale and bias), the f32 output written once,
    against the int8 tensor-core peak."""
    h, w, c, d = shape
    m = batch * h * w
    ops = 2.0 * m * d * 9 * c
    nbytes = m * c + 9 * c * d + 8 * d + 4 * m * d
    o_ms = ops / PEAK_INT8_OPS * 1e3
    b_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return max(o_ms, b_ms), o_ms, b_ms


def s8_library(torch, F, quantize, conv_s8, x, wk, scale, bias):
    """The library route to K7's function: im2col of the int8 input (nine
    shifted views), one ``torch._int_mm`` (cuBLASLt), the f32 epilogue."""
    b, h, w, c = x.shape
    d = wk.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(-1, 9 * c)
    wm = wk.permute(0, 1, 3, 2).reshape(9 * c, d)
    acc = quantize.int8_matmul(cols, wm).reshape(b, h, w, d)
    return conv_s8.dequant(acc, scale, bias, relu=True)


def w8a8_phase(torch, np, F, dev, card):
    """Phase 21: the w8a8 slim4.  Returns (K7's kernels-line entry, the
    counted runs' launches of the other kernels)."""
    from unetseg_tpu_torch import checkpoint, engine, metrics, quantize, \
        service
    from unetseg_tpu_torch.data import synth_batch, synth_slice, \
        training_batch
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import conv, conv_s8, decode
    from unetseg_tpu_torch.ops.preprocess import preprocess_oracle_u8
    from unetseg_tpu_torch.parallel import pipeline

    # K7 against its plain version, bit for bit
    err = 0.0
    for batch, shapes in ((8, SLIM4_CONVS + EXTRA_CONVS),
                          (EDGE_BATCH, EDGE_CONVS)):
        for i, shape in enumerate(shapes):
            ops = s8_inputs(torch, shape, batch, dev, 500 + i)
            for relu in (True, False):
                got = conv_s8.conv3x3_s8(*ops, relu=relu)
                want = conv_s8.conv3x3_s8_plain(*ops, relu=relu)
                torch.cuda.synchronize()
                e = (got - want).abs().max().item()
                log({"phase": "k7_parity", "shape": [batch, *shape],
                     "relu": relu, "max_abs_err": e,
                     "bit_equal": torch.equal(got, want)})
                if not torch.equal(got, want):
                    raise AssertionError(f"K7 {shape}: differs from its "
                                         f"plain version by {e}")
                err = max(err, e)

    with tempfile.TemporaryDirectory() as tmp:
        # quantize on the card
        seed, n_batches, n = W8A8_CALIB
        rng = np.random.default_rng(seed)
        calib = [training_batch(rng, n)[0] for _ in range(n_batches)]
        q_ckpt = os.path.join(tmp, "models", "flagship_slim4_w8a8.ckpt")
        os.makedirs(os.path.dirname(q_ckpt))
        t0 = time.perf_counter()
        q, qcfg = quantize.quantize_checkpoint(CKPT, q_ckpt, calib,
                                               device=dev)
        quantize_s = time.perf_counter() - t0
        params, cfg = checkpoint.load(CKPT)
        log({"phase": "w8a8_quantize", "seconds": quantize_s,
             "arch": qcfg.arch, "compute_dtype": qcfg.compute_dtype,
             "ckpt_bytes": os.path.getsize(q_ckpt),
             "parent_bytes": os.path.getsize(CKPT)})
        qm = registry.build(q, qcfg, dev)
        if qm.encoder[0].conv1.weight.dtype != torch.int8 or \
                qm.head.scale.dtype != torch.float32:
            raise AssertionError("the w8a8 model was cast")

        # the pipelines at batch W8A8_BATCH, both cleanups, against bf16
        raws, labels = synth_batch(np.random.default_rng(77), W8A8_BATCH)
        u8 = torch.from_numpy(np.stack([native.preprocess_u8(r, 512)
                                        for r in raws])).to(dev)
        rows = {}
        for post in (False, True):
            q_eng = engine.InferenceEngine(q, qcfg, dev, post)
            f_eng = engine.InferenceEngine(params, cfg, dev, post)
            ms = {}
            for label, e in (("bf16", f_eng), ("w8a8", q_eng),
                             ("w8a8_2", q_eng), ("bf16_2", f_eng)):
                ms[label] = time_ms(torch, lambda: e._pipeline(u8), 20)
            cleanup = "device" if post else "host"
            for label in ("bf16", "w8a8"):
                t = [ms[label], ms[label + "_2"]]
                rows[(label, cleanup)] = t
                log({"phase": "w8a8_throughput", "model": label,
                     "cleanup": cleanup, "batch": W8A8_BATCH,
                     "ms_per_batch": t,
                     "slices_per_s": [W8A8_BATCH / v * 1e3 for v in t],
                     **card})
            if not post:
                prof = profile_pipeline(torch, lambda: q_eng._pipeline(u8),
                                        top=12)
                del prof["ops"]
                log({"phase": "w8a8_profile", "batch": W8A8_BATCH, **prof,
                     **card})
            del q_eng, f_eng
        torch.cuda.empty_cache()

        # K7 per forward against its bound, the library route, K1/K2
        sums = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                              "ops_ms", "byte_ms", "bf16_ms"), 0.0)
        for i, shape in enumerate(SLIM4_CONVS):
            ops = s8_inputs(torch, shape, W8A8_BATCH, dev, 600 + i)
            k_ms = time_ms(torch, lambda: conv_s8.conv3x3_s8(*ops), 10)
            lib_ms = time_ms(torch, lambda: s8_library(
                torch, F, quantize, conv_s8, *ops), 5)
            plain_ms = time_ms(torch, lambda: conv_s8.conv3x3_s8_plain(
                *ops), 2, warmup=1)
            xb, wb, bb = conv_inputs(torch, shape, W8A8_BATCH, dev, 600 + i)
            bf_ms = time_ms(torch, lambda: conv.conv3x3_bias_act(xb, wb, bb),
                            10)
            bound, o_ms, b_ms = s8_bound(shape, W8A8_BATCH)
            log({"phase": "k7_time", "shape": [W8A8_BATCH, *shape],
                 "ms": k_ms, "library_ms": lib_ms, "plain_ms": plain_ms,
                 "bound_ms": bound, "ops_ms": o_ms, "byte_ms": b_ms,
                 "share_of_bound": bound / k_ms, "k1_k2_bf16_ms": bf_ms,
                 **card})
            for key, val in (("ms", k_ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("bound_ms", bound),
                             ("ops_ms", o_ms), ("byte_ms", b_ms),
                             ("bf16_ms", bf_ms)):
                sums[key] += val
            del ops, xb, wb, bb
        log({"phase": "k7_per_forward", "batch": W8A8_BATCH, **sums, **card})

        # the card's masks against the CPU w8a8 path, same tree
        x2 = (u8[:W8A8_CPU_SLICES].float() / 255.0)[..., None]
        cpu_model = registry.build(q, qcfg, "cpu")
        with torch.inference_mode():
            card_masks = qm.masks(x2).cpu()
            card_logits = qm(x2)
            cpu_masks = cpu_model.masks(x2.cpu())
        agree = (card_masks == cpu_masks).float().mean().item()
        log({"phase": "w8a8_cpu_reference", "slices": W8A8_CPU_SLICES,
             "mask_agreement": agree,
             "finite": bool(torch.isfinite(card_logits).all()),
             "shape": list(card_logits.shape)})
        if agree < W8A8_CPU_AGREEMENT or \
                not torch.isfinite(card_logits).all():
            raise AssertionError(f"w8a8 card vs CPU masks agree on {agree}")

        # the accuracy contract on bench.py's pool, against the float parent
        raws, labels = synth_batch(np.random.default_rng(991), 32)
        xv = torch.from_numpy(np.stack([preprocess_oracle_u8(r, 512)
                                        for r in raws]).astype(np.float32)
                              / 255.0)[..., None].to(dev)
        fm = registry.build(params, cfg, dev)
        with torch.inference_mode():
            mq, mf = qm.masks(xv).cpu().numpy(), fm.masks(xv).cpu().numpy()
        cq, cf = native.postprocess_batch(mq), native.postprocess_batch(mf)
        ious = [metrics.polygon_iou(
            native.scaled_polygons(decode.mask_to_image_np(cq[i]), 512, 512),
            native.scaled_polygons(decode.mask_to_image_np(cf[i]), 512, 512),
            512, 512) for i in range(32)]
        fg = [metrics.foreground_iou(mq[i], labels[i]) for i in range(32)]
        log({"phase": "w8a8_accuracy", "slices": 32,
             "pixel_agreement": float((mq == mf).mean()),
             "polygon_iou_mean": float(np.mean(ious)),
             "polygon_iou_min": float(np.min(ious)),
             "fg_iou_mean": float(np.mean(fg)),
             "fg_iou_min": float(np.min(fg)), **card})
        if np.mean(ious) < W8A8_POLYGON_IOU:
            raise AssertionError(f"w8a8 polygon IoU {np.mean(ious)} against "
                                 f"the float parent < {W8A8_POLYGON_IOU}")
        del qm, fm, cpu_model, xv, u8
        torch.cuda.empty_cache()

        # every entry point once, the counters set to 0 just before each
        in_dir = os.path.join(tmp, "in")
        os.makedirs(in_dir)
        size = 768
        paths = write_raws(raw_io, synth_slice, np, in_dir, N_W8A8, size)
        launches_total: dict = {}

        def counted(what, fn, engines, device_post=False):
            reset_all_launches()
            conv_s8.reset_launches()
            before = [e.forwards for e in engines()]
            fn()
            torch.cuda.synchronize()
            got = {**all_launches(), **conv_s8.LAUNCHES}
            fwd = sum(e.forwards for e in engines()) - sum(before)
            want = {k: v * fwd for k, v in W8A8_LAUNCHES.items()}
            log({"phase": "w8a8_entry_point", "what": what,
                 "forwards": fwd, "launches": got})
            if fwd < 1 or {k: got[k] for k in want} != want or \
                    (got["cc_label"] != 0 and not device_post):
                raise AssertionError(f"w8a8 {what}: {fwd} forwards, "
                                     f"launches {got}, want {want}")
            for k, v in got.items():
                launches_total[k] = launches_total.get(k, 0) + v

        if not engine.initialize_engine(q_ckpt, device=dev,
                                        log_dir=os.path.join(tmp, "log")):
            raise AssertionError("w8a8 initialize_engine returned False")
        eng = engine.get_engine()
        out_b = os.path.join(tmp, "batch")
        counted("process_batch", lambda: run_batch(engine, paths, size,
                                                   out_b), lambda: [eng])
        check_artifacts(out_b, "slice_017")
        def single(out, kw):
            if not engine.process_single_image(paths[17], size, size, out,
                                               **kw):
                raise AssertionError(f"w8a8 process_single_image({kw})")

        for mode, kw in (("plain", {}), ("tta", {"tta": True}),
                         ("window", {"window": 512})):
            out = os.path.join(tmp, f"single_{mode}")
            counted(f"process_single_image_{mode}",
                    lambda: single(out, kw), lambda: [eng])
            check_artifacts(out, "slice_017")
        compare_dirs(out_b, os.path.join(tmp, "single_plain"),
                     sorted(os.listdir(os.path.join(tmp, "single_plain"))))
        engine.cleanup_resources()
        study_dir = os.path.join(tmp, "study")
        res = {}
        counted("run_study", lambda: res.update(r=pipeline.run_study(
            q, qcfg, paths, size, size, batch_size=N_W8A8,
            host_preprocess=True, artifacts="full", out_dir=study_dir,
            device=dev)), lambda: [pipeline.study_engine(q, qcfg, dev)])
        compare_dirs(out_b, study_dir, sorted(os.listdir(out_b)))
        resident = os.path.join(tmp, "resident")
        counted("run_study_device_resident_device_cleanup",
                lambda: pipeline.run_study_device_resident(
                    q, qcfg, paths, size, size, batch_size=N_W8A8,
                    artifacts="json", out_dir=resident,
                    device_postprocess=True, device=dev),
                lambda: [pipeline.study_engine(q, qcfg, dev, True)],
                device_post=True)
        svc = service.SegmentationService(port=0, partitions=4,
                                          device=str(dev))
        addr = svc.start()
        try:
            out_s = os.path.join(tmp, "svc")
            holder = {}

            def serve():
                for req in ({"cmd": "init", "cache": q_ckpt},
                            {"cmd": "process", "path": in_dir,
                             "width": size, "height": size,
                             "output_dir": out_s}):
                    r = service.request(addr, req, timeout=300)
                    if not r.get("ok"):
                        raise AssertionError(f"w8a8 service: {r}")
                    holder["pool"] = list(svc._engines)
            # the one-card pool is the global engine itself
            counted("service", serve, lambda: list({id(e): e for e in [
                engine.get_engine()] + holder.get("pool", []) if e}.values()))
            service.request(addr, {"cmd": "shutdown"}, timeout=60)
        finally:
            svc.stop()
        compare_dirs(out_b, out_s, sorted(os.listdir(out_b)))
    entry = {"name": "conv3x3_s8", "route": "cuda", "source": K7_SOURCE,
             "replaces": K7_REPLACES,
             "launches": launches_total.pop("conv3x3_s8"),
             "max_abs_err": err, "ms": sums["ms"],
             "plain_ms": sums["plain_ms"], "bound_ms": sums["bound_ms"],
             "bound_by": ("operations" if sums["ops_ms"] >= sums["byte_ms"]
                          else "bytes"),
             "library_ms": sums["library_ms"]}
    return entry, launches_total


# ---------------------------------------------------------------------------
# Phases 22-24: float32 serving (K8, P13) and training (P12)
# ---------------------------------------------------------------------------

F32_SOURCE = "unetseg_tpu_torch/csrc/conv3x3_f32.cu"
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet), K8's
# design (SIMT FMAs); bytes at PEAK_HBM_BYTES.
PEAK_F32_FLOPS = 67e12
# K8 against a float64 reference, relative to max |output|; and at most
# F32_VS_LIBRARY times F.conv2d's own float32 error (TF32 off), or one f32
# ulp of max |output| where F.conv2d's is 0.
F32_TOL = 2e-5
F32_VS_LIBRARY = 4
# K8's parity shapes: every conv shape slim4, the flagship and the zoo serve
# (at F32_PARITY_BATCH), and the tiling's edges (C = 1, 4, 48, 80, 96;
# D = 48, 112; ragged B, H, W) at EDGE_BATCH.
F32_SERVED_CONVS = sorted(set(SLIM4_CONVS + FLAGSHIP_CONVS + ZOO_NEW_CONVS
                              + [STEM2_CONV]))
F32_EDGE_CONVS = EDGE_CONVS + EXTRA_CONVS + [(9, 70, 1, 16), (5, 33, 4, 112)]
F32_PARITY_BATCH = 2
# The float32 main path: (model, batch, RAWs of its process_batch).
F32_MODELS = {"flagship": (FLAGSHIP_BATCH, N_FLAGSHIP), "slim4": (128, 128)}
# Card vs CPU float32 logits: within F32_LOGIT_TOL of max(1, max |logit|);
# masks equal but where the CPU's top-2 gap is within F32_TIE of it.
F32_LOGIT_TOL = 1e-4
F32_TIE = 1e-3
N_F32_ZOO = 32
F32_ZOO_KW: dict = {}  # the zoo at full width and depth
# Phase 23: the autograd Function on these shapes; train-to-serve at the
# size of tests/test_train_to_serve.py.
GRAD_TOL = {"float32": 2e-5, "bfloat16": RTOL}
T2S_KW = dict(base_channels=8, depth=2, image_size=64,
              compute_dtype="float32")
T2S_STEPS = 150
T2S_SERVED = 8
# Phase 24: the flagship recipe (benchmarks/train_flagship.py) for a few
# dozen steps; float32 and distillation steps at full width.
TRAIN_STEPS = 30
TRAIN_POOL = 128
TRAIN_BATCH = 8
F32_TRAIN_STEPS = 3
DISTILL_STEPS = 5
# The flagship's 3x3 convs in a training step: the 16 of FLAGSHIP_CONVS and
# the last level's two (the logits path runs them outside K6).
TRAIN_LAST_CONVS = LOGITS_CONVS + [(512, 512, 64, 64)]


def f32_inputs(torch, shape, batch, device, seed):
    h, w, c, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, h, w, c), generator=g, device=device)
    wt = torch.randn((3, 3, c, d), generator=g, device=device) / (9 * c) ** 0.5
    b = torch.randn((d,), generator=g, device=device) * 0.1
    return x, wt, b


def f32_bound(shape, batch):
    """(bound ms, flop ms, byte ms) of one float32 conv: its operations at
    the float32 SIMT rate, each input read once and the output written
    once."""
    h, w, c, d = shape
    m = batch * h * w
    f_ms = 2.0 * m * d * 9 * c / PEAK_F32_FLOPS * 1e3
    b_ms = 4.0 * (m * c + 9 * c * d + d + m * d) / PEAK_HBM_BYTES * 1e3
    return max(f_ms, b_ms), f_ms, b_ms


def check_k8(torch, conv, dev, shapes, batch, seed0, relu=True):
    """K8 against its plain version (cuDNN float32, TF32 off) and both
    against a float64 reference.  Returns max |K8 - plain|."""
    worst = 0.0
    rows = []
    for i, shape in enumerate(shapes):
        x, w, b = f32_inputs(torch, shape, batch, dev, seed0 + i)
        got = conv.conv3x3_bias_act(x, w, b, relu)
        plain = conv.conv3x3_bias_act_plain(x, w, b, relu)
        ref = conv.conv3x3_bias_act_plain(x.double(), w.double(), b.double(),
                                          relu)
        torch.cuda.synchronize()
        scale = max(float(ref.abs().max()), 1e-30)
        k_err = float((got.double() - ref).abs().max())
        p_err = float((plain.double() - ref).abs().max())
        worst = max(worst, float((got - plain).abs().max()))
        rows.append([batch, *shape, k_err / scale, p_err / scale])
        if not (k_err <= F32_TOL * scale and
                k_err <= max(F32_VS_LIBRARY * p_err, 2.0 ** -24 * scale)):
            raise AssertionError(
                f"K8 {[batch, *shape]}: error {k_err} against float64 "
                f"(max |out| {scale}); F.conv2d's {p_err}")
        del x, w, b, got, plain, ref
    log({"phase": "k8_parity", "relu": relu, "max_abs_err": worst,
         "batch_h_w_c_d_k8_err_f_conv2d_err": rows})
    return worst


def k8_times(torch, F, conv, dev, shapes, batch, card, tag):
    """K8, the plain version and F.conv2d (float32, channels-last, TF32
    off) per shape at ``batch``, beside the bound; returns their sums."""
    acc = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "flop_ms", "byte_ms"), 0.0)
    for i, shape in enumerate(shapes):
        x, w, b = f32_inputs(torch, shape, batch, dev, 700 + i)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        k_ms = time_ms(torch, lambda: conv.conv3x3_bias_act(x, w, b), 3, 1)
        lib_ms = time_ms(torch, lambda: F.conv2d(xc, wc, b, padding=1), 3, 1)
        plain_ms = time_ms(torch, lambda: conv.conv3x3_bias_act_plain(
            x, w, b), 2, 1)
        bound, f_ms, b_ms = f32_bound(shape, batch)
        log({"phase": "k8_time", "model": tag, "shape": [batch, *shape],
             "ms": k_ms, "library_ms": lib_ms, "plain_ms": plain_ms,
             "bound_ms": bound, "share_of_bound": bound / k_ms,
             "tflops": 2.0 * batch * shape[0] * shape[1] * shape[2]
             * shape[3] * 9 / k_ms / 1e9, **card})
        for key, val in (("ms", k_ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bound),
                         ("flop_ms", f_ms), ("byte_ms", b_ms)):
            acc[key] += val
        del x, w, b, xc, wc
    torch.cuda.empty_cache()
    log({"phase": "k8_per_forward", "model": tag, "batch": batch, **acc,
         **card})
    return acc


def f32_checkpoint(torch, np, src, dst, dev, raw_paths=None, **kw):
    """``src`` re-configured to float32 (``kw`` more config changes) at
    ``dst``; with ``raw_paths`` the head bias centred on their logits."""
    import dataclasses

    from unetseg_tpu_torch import checkpoint
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import preprocess

    params, cfg = checkpoint.load(src)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    checkpoint.save(dst, params, dataclasses.replace(
        cfg, compute_dtype="float32", **kw))
    if raw_paths:
        centre_head_bias(torch, checkpoint, registry, native, raw_io,
                         preprocess, dst, raw_paths, 768, dev)
    return dst


def counted_run(torch, what, fn, engines, per_forward, device_post=False):
    """``fn()`` with the counters set to 0 just before it: every forward
    of ``engines()`` launches ``per_forward`` (K8 only), no K6, K3 only
    with device cleanup.  Returns the launches."""
    reset_all_launches()
    before = sum(e.forwards for e in engines())
    fn()
    torch.cuda.synchronize()
    launches = all_launches()
    fwd = sum(e.forwards for e in engines()) - before
    want = {k: v * fwd for k, v in per_forward.items()}
    want["dec1_fused"] = 0
    log({"phase": "f32_entry_point", "what": what, "forwards": fwd,
         "launches": launches})
    if fwd < 1 or {k: launches[k] for k in want} != want or \
            bool(launches["cc_label"]) != device_post:
        raise AssertionError(f"float32 {what}: {fwd} forwards, launches "
                             f"{launches}, want {want}")
    return launches


def f32_model(torch, np, name, ckpt, bf16_ckpt, paths, tiled_raw, batch, tmp,
              dev, card):
    """Phase 22 for one float32 model: every entry point (process_batch,
    process_single_image plain, TTA, windows and with device cleanup,
    run_study, the TCP service, the REPL), launches exact, artifacts
    byte-equal where two paths serve the same slice; logits and masks
    against the CPU path; ms per batch beside bf16's.  Returns the counted
    runs' launches."""
    import io

    from unetseg_tpu_torch import checkpoint, cli, engine, service
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import preprocess
    from unetseg_tpu_torch.parallel import pipeline

    params, cfg = checkpoint.load(ckpt)
    size, n = 768, len(paths)
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def global_engine():
        eng = engine.get_engine()
        return [eng] if eng is not None else []

    if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log")):
        raise AssertionError(f"{name} f32: initialize_engine returned False")
    model = engine.get_engine().model
    per_fwd = convs_per_forward(model)
    if model.route != "unfused" or per_fwd["conv3x3_bias_act_f32"] != \
            sum(per_fwd.values()):
        raise AssertionError(f"{name} f32: route {model.route}, {per_fwd}")
    outs = {k: os.path.join(tmp, f"{name}_f32_{k}") for k in
            ("batch", "single", "tta", "tiled", "study", "svc", "repl",
             "single_device")}
    add(counted_run(torch, "process_batch", lambda: engine.process_batch(
        paths, size, size, [outs["batch"]] * n, batch_size=batch,
        tier="full"), global_engine, per_fwd))
    for base in ("slice_003", "slice_005", "slice_006"):
        check_artifacts(outs["batch"], base)
    add(counted_run(torch, "process_single_image",
                    lambda: engine.process_single_image(
                        paths[3], size, size, outs["single"]),
                    global_engine, per_fwd))
    compare_dirs(outs["batch"], outs["single"], sorted(os.listdir(
        outs["single"])))
    add(counted_run(torch, "tta", lambda: engine.process_single_image(
        paths[3], size, size, outs["tta"], tta=True), global_engine,
        per_fwd))
    check_artifacts(outs["tta"], "slice_003")
    h, w = TILED_RAW
    add(counted_run(torch, "window", lambda: engine.process_single_image(
        tiled_raw, w, h, outs["tiled"], window=TILED_WINDOW),
        global_engine, per_fwd))
    engine.cleanup_resources()

    if not engine.initialize_engine(ckpt, log_dir=os.path.join(tmp, "log"),
                                    device_postprocess=True):
        raise AssertionError(f"{name} f32: initialize_engine(device post)")
    add(counted_run(torch, "process_single_image device cleanup",
                    lambda: engine.process_single_image(
                        paths[3], size, size, outs["single_device"]),
                    global_engine, per_fwd, device_post=True))
    engine.cleanup_resources()
    compare_dirs(outs["single"], outs["single_device"],
                 sorted(os.listdir(outs["single"])))

    pipeline.study_engine(params, cfg, dev, False).compile(batch)
    add(counted_run(torch, "run_study", lambda: pipeline.run_study(
        params, cfg, paths, size, size, batch_size=batch,
        host_preprocess=True, artifacts="full", out_dir=outs["study"],
        device=dev), lambda: [pipeline.study_engine(params, cfg, dev, False)],
        per_fwd))
    names = sorted(os.listdir(outs["batch"]))
    if sorted(os.listdir(outs["study"])) != names:
        raise AssertionError(f"{name} f32: run_study wrote other artifacts")
    compare_dirs(outs["batch"], outs["study"], names)

    svc = service.SegmentationService(port=0, device=str(dev))
    addr = svc.start()
    try:
        def ask(req):
            resp = service.request(addr, req, timeout=600)
            if not resp.get("ok"):
                raise AssertionError(f"{name} f32 service {req['cmd']}: "
                                     f"{resp}")
            return resp
        ask({"cmd": "init", "cache": ckpt})
        add(counted_run(torch, "service", lambda: ask(
            {"cmd": "process", "path": paths[5], "width": size,
             "height": size, "output_dir": outs["svc"]}), global_engine,
            per_fwd))
        ask({"cmd": "shutdown"})
    finally:
        svc.stop()
    compare_dirs(outs["batch"], outs["svc"], sorted(os.listdir(outs["svc"])))

    # The REPL builds and drops its own engine: its launches are whole
    # forwards (warm-up and the slice) of K8 alone.
    script = io.StringIO(f"init {ckpt}\nprocess {paths[6]} {size} {size} "
                         f"{outs['repl']}\nexit\n")
    reset_all_launches()
    cli.repl(script, device=str(dev))
    torch.cuda.synchronize()
    launches = all_launches()
    n_k8 = per_fwd["conv3x3_bias_act_f32"]
    log({"phase": "f32_entry_point", "what": "repl", "launches": launches})
    if launches["conv3x3_bias_act_f32"] < 2 * n_k8 or \
            launches["conv3x3_bias_act_f32"] % n_k8 or sum(
                launches.values()) != launches["conv3x3_bias_act_f32"]:
        raise AssertionError(f"{name} f32 REPL: launches {launches}")
    add(launches)
    got = sorted(os.listdir(outs["repl"]))
    if [f for f in names if f.startswith("slice_006")] != got:
        raise AssertionError(f"{name} f32 REPL wrote {got}")
    compare_dirs(outs["batch"], outs["repl"], got)

    # Logits and masks on two slices against the CPU path.
    u8 = torch.from_numpy(np.stack([native.preprocess_u8(np.asarray(
        raw_io.read_raw(p, size, size)), cfg.image_size)
        for p in (paths * (batch // n + 1))[:batch]]))
    eng = engine.InferenceEngine(params, cfg, dev)
    x2 = preprocess.model_input_from_u8(u8[:2])[..., None]
    cpu_model = registry.build(params, cfg, device="cpu")
    with torch.inference_mode():
        got_lg = eng.model(x2.to(dev)).cpu()
        want_lg = cpu_model(x2)
    scale = max(1.0, float(want_lg.abs().max()))
    lg_err = float((got_lg - want_lg).abs().max())
    top2 = want_lg.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = got_lg.argmax(-1) != want_lg.argmax(-1)
    ties_ok = bool((gap[differ] <= F32_TIE * scale).all())
    del cpu_model

    # ms per batch beside bf16's, in turns; the device time by kernel.
    bparams, bcfg = checkpoint.load(bf16_ckpt)
    beng = engine.InferenceEngine(bparams, bcfg, dev)
    u8_d = u8.to(dev)
    times = {"float32": [], "bfloat16": []}
    for label, e in (("float32", eng), ("bfloat16", beng), ("bfloat16", beng),
                     ("float32", eng)):
        times[label].append(time_ms(torch, lambda: e._pipeline(u8_d), 3, 1))
    prof = profile_pipeline(torch, lambda: eng._pipeline(u8_d), iters=2,
                            top=8)
    del prof["ops"]
    log({"phase": "f32_model", "model": name, "batch": batch,
         "logit_max_abs_err": lg_err, "logit_scale": scale,
         "mask_differing_pixels": int(differ.sum()),
         "differing_within_tie": ties_ok,
         "ms_per_batch": times, "slices_per_s": {
             k: [batch / t * 1e3 for t in v] for k, v in times.items()},
         "profile": prof, "tf32": [torch.backends.cudnn.allow_tf32,
                                   torch.backends.cuda.matmul.allow_tf32],
         **card})
    if not (got_lg.shape == want_lg.shape and torch.isfinite(got_lg).all()
            and lg_err <= F32_LOGIT_TOL * scale and ties_ok):
        raise AssertionError(f"{name} f32: logits {lg_err} off (scale "
                             f"{scale}), masks differ beyond ties at "
                             f"{int(differ.sum())} pixels")
    del eng, beng, u8_d
    torch.cuda.empty_cache()
    return total


def f32_phase(torch, np, F, dev, card):
    """Phase 22: K8 against its plain version and float64 on every served
    shape and the tiling's edges; its times; the float32 flagship and slim4
    through every entry point; the cascade; UNet++ and Attention U-Net in
    float32 through process_batch.  Returns (K8's record for the kernels
    line, the counted runs' launches)."""
    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import raw as raw_io
    from unetseg_tpu_torch.ops import conv

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: the float32 path and its "
                             "yardsticks must run in full float32")
    err = check_k8(torch, conv, dev, F32_SERVED_CONVS, F32_PARITY_BATCH, 800)
    err = max(err, check_k8(torch, conv, dev, F32_EDGE_CONVS, EDGE_BATCH,
                            900))
    err = max(err, check_k8(torch, conv, dev, F32_EDGE_CONVS[:3], EDGE_BATCH,
                            950, relu=False))
    slim4_sum = k8_times(torch, F, conv, dev, SLIM4_CONVS, 128, card,
                         "slim4")
    k8_times(torch, F, conv, dev, FLAGSHIP_CONVS, FLAGSHIP_BATCH, card,
             "flagship")
    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        bf16_flag, paths = flagship_checkpoint(torch, np, tmp, dev)
        ckpts = {"flagship": f32_checkpoint(
            torch, np, bf16_flag, os.path.join(tmp, "models", "flag32.ckpt"),
            dev, paths[:4]),
            "slim4": f32_checkpoint(torch, np, CKPT, os.path.join(
                tmp, "models", "slim32.ckpt"), dev)}
        bf16 = {"flagship": bf16_flag, "slim4": CKPT}
        h, w = TILED_RAW
        tiled = os.path.join(tmp, "tiled.raw")
        raw_io.write_raw(tiled, synth_slice(np.random.default_rng(41),
                                            max(h, w))[0][:h, :w])
        more = study_raws(np, os.path.join(tmp, "in_f32"),
                          max(n for _, n in F32_MODELS.values()), 768)
        for name, (batch, n) in F32_MODELS.items():
            t0 = time.perf_counter()
            launches = f32_model(torch, np, name, ckpts[name], bf16[name],
                                 more[:n], tiled, batch, tmp, dev, card)
            log({"phase": "f32_seconds", "model": name,
                 "seconds": time.perf_counter() - t0})
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v

        # The cascade: the float32 slim4 student, the float32 flagship its
        # fallback, process_batch: one student and one fallback pass.
        # (margin router, a threshold every slice is below: all route)
        if not engine.initialize_engine(
                ckpts["slim4"], log_dir=os.path.join(tmp, "log"),
                cascade_ckpt=ckpts["flagship"], cascade_threshold=1e9):
            raise AssertionError("f32 cascade: initialize_engine failed")
        eng = engine.get_engine()
        reset_all_launches()
        ok, failed = engine.process_batch(
            more[:FLAGSHIP_BATCH], 768, 768,
            [os.path.join(tmp, "cascade")] * FLAGSHIP_BATCH,
            batch_size=FLAGSHIP_BATCH)
        torch.cuda.synchronize()
        launches = all_launches()
        engine.cleanup_resources()
        log({"phase": "f32_cascade", "processed": ok, "failed": failed,
             "forwards": eng.forwards, "launches": launches})
        k8_fwd = sum(4 * checkpoint.load(ckpts[m])[1].depth + 2
                     for m in ("slim4", "flagship"))  # one pass of each
        if (ok, failed) != (FLAGSHIP_BATCH, 0) or \
                launches["conv3x3_bias_act_f32"] != k8_fwd or \
                launches["conv3x3_bias_act"] or \
                launches["conv3x3_bias_act_small_c"] or launches["dec1_fused"]:
            raise AssertionError(f"f32 cascade: {ok} ok, {failed} failed, "
                                 f"launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

        # The zoo in float32 through process_batch.
        for arch in ("unetpp", "attention_unet"):
            ckpt = os.path.join(tmp, "models", f"{arch}32.ckpt")
            checkpoint.create(ckpt, ModelConfig(arch=arch,
                                                compute_dtype="float32",
                                                **F32_ZOO_KW), seed=0)
            if not engine.initialize_engine(ckpt, log_dir=os.path.join(
                    tmp, "log")):
                raise AssertionError(f"{arch} f32: initialize_engine failed")
            per_fwd = convs_per_forward(engine.get_engine().model)
            out = os.path.join(tmp, f"{arch}_f32")
            t0 = time.perf_counter()
            add = counted_run(
                torch, f"{arch} process_batch", lambda: engine.process_batch(
                    more[:N_F32_ZOO], 768, 768, [out] * N_F32_ZOO,
                    batch_size=ZOO_BATCH), lambda: [engine.get_engine()],
                per_fwd)
            log({"phase": "f32_zoo", "model": arch, "slices": N_F32_ZOO,
                 "batch": ZOO_BATCH, "wall_s": time.perf_counter() - t0,
                 "artifacts": len(os.listdir(out)), **card})
            engine.cleanup_resources()
            if len(os.listdir(out)) < 3 * N_F32_ZOO:
                raise AssertionError(f"{arch} f32: artifacts missing")
            for k, v in add.items():
                total[k] = total.get(k, 0) + v
    k8 = {"name": "conv3x3_bias_act_f32", "route": "cuda",
          "source": F32_SOURCE, "replaces": REPLACES["conv3x3_bias_act"],
          "launches": total.get("conv3x3_bias_act_f32", 0),
          "max_abs_err": err, "ms": slim4_sum["ms"],
          "plain_ms": slim4_sum["plain_ms"],
          "bound_ms": slim4_sum["bound_ms"],
          "bound_by": ("operations" if slim4_sum["flop_ms"] >=
                       slim4_sum["byte_ms"] else "bytes"),
          "library_ms": slim4_sum["library_ms"]}
    total.pop("conv3x3_bias_act_f32", None)
    return k8, total


def grad_parity(torch, conv, dev, shapes, batch, dtype, seed0):
    """``Conv3x3Function``'s output, dx, dw and db against autograd through
    the plain version, per shape, with ReLU; the worst error relative to
    max |value|.  The reference and its ReLU mask are the plain version's
    own.  Where the plain output lies within the tolerance of 0, the
    kernel's rounding may put it on the other side of the ReLU, so the
    cotangent is zeroed there on both sides: those pixels drop out of
    every gradient, and the output check still holds them to the
    tolerance."""
    worst = {"dx": 0.0, "dw": 0.0, "db": 0.0, "y": 0.0}
    tol = GRAD_TOL[str(dtype).split(".")[-1]]
    for i, shape in enumerate(shapes):
        x, w, b = (t.to(dtype) for t in f32_inputs(torch, shape, batch, dev,
                                                   seed0 + i))
        r = torch.randn((batch, *shape[:2], shape[3]), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(i))
        ins = [[t.clone().requires_grad_(True) for t in (x, w, b)]
               for _ in range(2)]
        y_ref = conv.conv3x3_bias_act_plain(*ins[1], relu=True)
        with torch.no_grad():
            lin = conv.conv3x3_bias_act_plain(x, w, b, relu=False).float()
            r = torch.where(lin.abs() <= tol * lin.abs().max(), 0, r)
        (y_ref.float() * r).sum().backward()
        y = conv.conv3x3_bias_act_train(*ins[0])
        (y.float() * r).sum().backward()
        pairs = {"y": (y, y_ref)}
        pairs.update({k: (a.grad, e.grad) for k, a, e in
                      zip(("dx", "dw", "db"), ins[0], ins[1])})
        for k, (a, e) in pairs.items():
            a, e = a.detach().float(), e.detach().float()
            rel = float((a - e).abs().max()) / max(float(e.abs().max()),
                                                   1e-30)
            worst[k] = max(worst[k], rel)
        if max(worst.values()) > tol:
            raise AssertionError(f"conv Function {dtype} {[batch, *shape]}: "
                                 f"errors {worst} (tol {tol})")
        del x, w, b, r, ins, y, y_ref, lin, pairs
    log({"phase": "grad_parity", "dtype": str(dtype), "shapes": len(shapes),
         "batch": batch, "worst_relative_err": worst, "tol": tol})
    torch.cuda.empty_cache()


def train_phase(torch, np, F, dev, card):
    """Phase 23: the conv under autograd against autograd through the plain
    version; train-to-serve at tests/test_train_to_serve.py's size and
    asserts, served on the card against the CPU engine; a save/load resume
    against an uninterrupted run; the dp step against the one-device step.
    Returns the counted runs' launches and data-gradient launches."""
    from unetseg_tpu_torch import checkpoint, engine, train
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.data import synth_slice, training_batch
    from unetseg_tpu_torch.io import raw as raw_io
    from unetseg_tpu_torch.ops import conv
    from unetseg_tpu_torch.parallel import mesh as pmesh

    shapes = F32_SERVED_CONVS
    for dtype in (torch.float32, torch.bfloat16):
        grad_parity(torch, conv, dev, shapes, F32_PARITY_BATCH, dtype, 1000)
        grad_parity(torch, conv, dev, F32_EDGE_CONVS, EDGE_BATCH, dtype, 1100)

    cfg = ModelConfig(**T2S_KW)
    convs = 4 * cfg.depth + 2
    tx = train.make_optimizer(lr=1e-2, total_steps=T2S_STEPS)
    rng = np.random.default_rng(0)
    state = train.init_state(0, cfg, tx, device=dev)
    reset_all_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(T2S_STEPS):
        state, loss = train.train_step(state, training_batch(rng, 8, 64),
                                       cfg, tx)
        losses.append(float(loss))
    t2s_s = time.perf_counter() - t0
    imgs, labels = training_batch(rng, 8, 64)
    pred = train.predict_masks(state.params, cfg, imgs)
    torch.cuda.synchronize()
    launches, dgrad = all_launches(), dict(conv.DGRAD_LAUNCHES)
    inter = np.logical_and(pred == 2, labels == 2).sum()
    iou = inter / max(np.logical_or(pred == 2, labels == 2).sum(), 1)
    want_k8 = T2S_STEPS * (2 * convs - 1) + convs
    log({"phase": "train_to_serve", "steps": T2S_STEPS, "seconds": t2s_s,
         "ms_per_step": t2s_s / T2S_STEPS * 1e3, "loss_first": losses[0],
         "loss_last": losses[-1], "losses_every_25": losses[::25],
         "held_out_iou": float(iou), "launches": launches,
         "dgrad_launches": dgrad, **card})
    if not losses[-1] < 0.3 * losses[0] or not iou > 0.75:
        raise AssertionError(f"train-to-serve: loss {losses[0]} -> "
                             f"{losses[-1]}, held-out IoU {iou}")
    if launches["conv3x3_bias_act_f32"] != want_k8 or \
            dgrad["conv3x3_bias_act_f32"] != T2S_STEPS * (convs - 1) or \
            launches["conv3x3_bias_act"] or \
            launches["conv3x3_bias_act_small_c"]:
        raise AssertionError(f"train-to-serve launches {launches}, dgrad "
                             f"{dgrad}: want {want_k8} K8, "
                             f"{T2S_STEPS * (convs - 1)} of them dgrad")
    total = dict(launches)
    dgrad_total = dict(dgrad)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "eng", "trained.ckpt")
        os.makedirs(os.path.dirname(ckpt))
        checkpoint.save(ckpt, checkpoint.params_to_jax(state.params), cfg)
        paths = []
        for i in range(T2S_SERVED):
            paths.append(os.path.join(tmp, "in", f"case_{i:02d}.raw"))
            os.makedirs(os.path.dirname(paths[-1]), exist_ok=True)
            raw_io.write_raw(paths[-1], synth_slice(rng, 64)[0])
        dirs = {}
        for where in ("cuda", "cpu"):
            dirs[where] = os.path.join(tmp, where)
            if not engine.initialize_engine(
                    ckpt, log_dir=os.path.join(tmp, "log"),
                    device=str(dev) if where == "cuda" else "cpu"):
                raise AssertionError(f"trained model: initialize on {where}")
            ok, failed = engine.process_batch(paths, 64, 64,
                                              [dirs[where]] * len(paths))
            engine.cleanup_resources()
            if (ok, failed) != (len(paths), 0):
                raise AssertionError(f"trained model on {where}: {ok} ok")
        from unetseg_tpu_torch.io import png

        same = 0
        for p in paths:
            base = os.path.basename(p)[:-len(".raw")]
            masks = [png.read_png_gray(os.path.join(dirs[d], base +
                                                    "_mask.png"))
                     for d in ("cuda", "cpu")]
            if np.array_equal(*masks):
                same += 1
                names = sorted(f for f in os.listdir(dirs["cpu"])
                               if f.startswith(base))
                if names != sorted(f for f in os.listdir(dirs["cuda"])
                                   if f.startswith(base)):
                    raise AssertionError(f"{base}: artifact sets differ")
                compare_dirs(dirs["cuda"], dirs["cpu"],
                             [f for f in names if f.endswith(".json")])
        log({"phase": "train_to_serve_served", "slices": len(paths),
             "masks_equal_card_cpu": same})
        if same < len(paths) - 1:
            raise AssertionError(f"trained model: card and CPU masks equal "
                                 f"on {same} of {len(paths)} slices")

        # save_state / load_state against an uninterrupted run
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            batches = [training_batch(np.random.default_rng(70 + i), 8, 64)
                       for i in range(4)]
            straight = train.init_state(3, cfg, tx, device=dev)
            part = straight
            for b in batches:
                straight, _ = train.train_step(straight, b, cfg, tx,
                                               boundary_boost=2.0)
            for b in batches[:2]:
                part, _ = train.train_step(part, b, cfg, tx,
                                           boundary_boost=2.0)
            path = os.path.join(tmp, "mid.state")
            train.save_state(path, part, cfg)
            resumed, rcfg = train.load_state(path, tx, device=dev)
            for b in batches[2:]:
                resumed, _ = train.train_step(resumed, b, rcfg, tx,
                                              boundary_boost=2.0)
        finally:
            torch.backends.cudnn.deterministic = saved
        equal = all(torch.equal(resumed.params[k], straight.params[k])
                    for k in straight.params)
        log({"phase": "train_resume", "steps": 4, "bit_equal": equal})
        if not equal or resumed.step != straight.step:
            raise AssertionError("resume from save_state/load_state differs "
                                 "from the uninterrupted run")

    # the dp step over two positions of the card against the one-device
    # step: the gradients and the losses of three steps.  (The parameters
    # are logged, not held: Adam divides by sqrt(nu), so where a gradient
    # is near 0 its last bits, summed in another order, move that
    # element's update by up to the learning rate.)
    batch = training_batch(np.random.default_rng(80), 8, 64)
    kw = dict(boundary_boost=2.0)
    s1 = s2 = train.init_state(4, cfg, tx, device=dev)
    g1 = train.loss_and_grads(s1.params, batch, cfg, devices=[dev], **kw)[1]
    g2 = train.loss_and_grads(s1.params, batch, cfg, devices=[dev, dev], **kw)[1]
    g_err = max(float((g2[k] - g1[k]).abs().max()) /
                max(float(g1[k].abs().max()), 1e-30) for k in g1)
    one = train.make_sharded_train_step(
        cfg, pmesh.make_mesh(devices=[dev]), tx, **kw)
    two = train.make_sharded_train_step(
        cfg, pmesh.make_mesh(devices=[dev, dev]), tx, **kw)
    losses = []
    for _ in range(3):  # the first update's learning rate is 0
        s1, l1 = one(s1, batch)
        s2, l2 = two(s2, batch)
        losses.append([float(l1), float(l2)])
    diff = torch.cat([(s2.params[k] - s1.params[k]).abs().flatten()
                      for k in s1.params])
    far = float((diff > 1e-6).float().mean())
    log({"phase": "train_dp", "devices": [str(dev)] * 2, "losses": losses,
         "grad_max_rel_err": g_err, "max_param_diff": float(diff.max()),
         "share_of_params_off_by_1e-6": far})
    if any(abs(a - b) > 1e-5 * abs(a) for a, b in losses) or g_err > 1e-4:
        raise AssertionError(f"dp step: losses {losses}, gradients {g_err} "
                             f"off")
    return total, dgrad_total


def step_kernel_times(torch, conv, dev, cfg, batch, card):
    """Per flagship training step, by CUDA events on random inputs at the
    step's shapes: the forward convs, their data gradients (K1/K2) and
    their weight gradients (``conv2d_weight``, cuDNN)."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    shapes = FLAGSHIP_CONVS + TRAIN_LAST_CONVS
    acc = {"forward_ms": 0.0, "dgrad_ms": 0.0, "wgrad_ms": 0.0}
    for i, shape in enumerate(shapes):
        x, w, b = (t.to(dtype) for t in f32_inputs(torch, shape, batch, dev,
                                                   1200 + i))
        g = torch.randn((batch, *shape[:2], shape[3]), device=dev).to(dtype)
        acc["forward_ms"] += time_ms(
            torch, lambda: conv.conv3x3_bias_act(x, w, b), 3, 1)
        if i:  # the first conv reads data: no data gradient
            acc["dgrad_ms"] += time_ms(torch,
                                       lambda: conv.conv3x3_dgrad(g, w), 3, 1)
        acc["wgrad_ms"] += time_ms(torch, lambda: conv.conv3x3_wgrad(x, g),
                                   3, 1)
        del x, w, b, g
    torch.cuda.empty_cache()
    log({"phase": "train_step_convs", "dtype": cfg.compute_dtype,
         "batch": batch, "convs": len(shapes), **acc, **card})
    return acc


def train_flagship_phase(torch, np, F, dev, card):
    """Phase 24: the flagship recipe (``benchmarks/train_flagship.py``:
    bf16, remat, batch 8, lr 3e-4) at full width for TRAIN_STEPS steps,
    the counters set to 0 just before it: ms per step, slices/s, peak
    memory, the device time by kernel and idle share, the forward, dgrad
    and wgrad times per step; the loss falls.  A few float32 flagship
    steps, and distillation steps (slim4 the student, the seeded
    flagship's logits the teacher).  Returns the counted runs' launches and
    data-gradient launches."""
    import dataclasses

    from unetseg_tpu_torch import checkpoint, train
    from unetseg_tpu_torch.benchmarks import train_flagship
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.data import training_batch
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import conv

    cfg = ModelConfig(remat=True, **FLAGSHIP_KW)
    convs = 4 * cfg.depth + 2
    per_step = 3 * convs - 3  # forward, remat (not the bottleneck), dgrad
    total, dgrad_total = {}, {}

    def add(launches, dgrad):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        for k, v in dgrad.items():
            dgrad_total[k] = dgrad_total.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        res = train_flagship.run(TRAIN_STEPS, os.path.join(tmp, "fs.ckpt"),
                                 batch=TRAIN_BATCH, n_train=TRAIN_POOL,
                                 cfg=cfg, device=str(dev), log=log)
        wall = time.perf_counter() - t0
        launches, dgrad = all_launches(), dict(conv.DGRAD_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        served = checkpoint.load(os.path.join(tmp, "fs.ckpt"))[1]
    losses = res["losses"]
    k12 = launches["conv3x3_bias_act"] + launches["conv3x3_bias_act_small_c"]
    val_fwd = -(-16 // TRAIN_BATCH)
    log({"phase": "train_flagship", "steps": TRAIN_STEPS,
         "batch": TRAIN_BATCH, "ms_per_step": res["ms_per_step"],
         "slices_per_s": TRAIN_BATCH / res["ms_per_step"] * 1e3,
         "wall_s": wall, "peak_memory_bytes": peak,
         "loss_first5": float(np.mean(losses[:5])),
         "loss_last5": float(np.mean(losses[-5:])), "losses": losses,
         "val_fg_iou": res["val_fg_iou"], "launches": launches,
         "dgrad_launches": dgrad, "served_config": dataclasses.asdict(served),
         **card})
    if not np.mean(losses[-5:]) < np.mean(losses[:5]) or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"flagship recipe: the loss did not fall "
                             f"{losses}")
    dg = dgrad["conv3x3_bias_act"] + dgrad["conv3x3_bias_act_small_c"]
    if k12 != TRAIN_STEPS * per_step + val_fwd * convs or \
            dg != TRAIN_STEPS * (convs - 1) or launches["dec1_fused"] or \
            launches["conv3x3_bias_act_f32"] or served.remat:
        raise AssertionError(f"flagship recipe launches {launches}, dgrad "
                             f"{dgrad}: want {per_step} K1/K2 a step, "
                             f"{convs - 1} of them dgrad")
    add(launches, dgrad)
    state = res.pop("state")
    tx = train.make_optimizer(lr=3e-4, total_steps=TRAIN_STEPS)
    imgs, labels = training_batch(np.random.default_rng(5), TRAIN_BATCH)
    batch = (torch.from_numpy(imgs).to(dev), torch.from_numpy(labels).to(dev))
    prof = profile_pipeline(torch, lambda: train.train_step(
        state, batch, cfg, tx), iters=3, top=15)
    del prof["ops"]
    log({"phase": "train_flagship_profile", **prof, **card})
    step_kernel_times(torch, conv, dev, cfg, TRAIN_BATCH, card)
    del state, prof
    torch.cuda.empty_cache()

    # float32 flagship steps
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    tx = train.make_optimizer(lr=3e-4, total_steps=100)
    st = train.init_state(0, f32, tx, device=dev)
    st, _ = train.train_step(st, batch, f32, tx)  # warm-up
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    f32_losses = []
    for _ in range(F32_TRAIN_STEPS):
        st, loss = train.train_step(st, batch, f32, tx)
        f32_losses.append(float(loss))
    f32_ms = (time.perf_counter() - t0) / F32_TRAIN_STEPS * 1e3
    launches, dgrad = all_launches(), dict(conv.DGRAD_LAUNCHES)
    log({"phase": "train_flagship_f32", "steps": F32_TRAIN_STEPS,
         "batch": TRAIN_BATCH, "ms_per_step": f32_ms,
         "slices_per_s": TRAIN_BATCH / f32_ms * 1e3, "losses": f32_losses,
         "launches": launches, "dgrad_launches": dgrad, **card})
    if launches["conv3x3_bias_act_f32"] != F32_TRAIN_STEPS * per_step or \
            dgrad["conv3x3_bias_act_f32"] != F32_TRAIN_STEPS * (convs - 1) \
            or not all(np.isfinite(f32_losses)):
        raise AssertionError(f"float32 flagship steps: {launches}, {dgrad}, "
                             f"losses {f32_losses}")
    add(launches, dgrad)
    step_kernel_times(torch, conv, dev, f32, TRAIN_BATCH, card)
    del st
    torch.cuda.empty_cache()

    # distillation: slim4 the student, the seeded flagship the teacher
    s_params, s_cfg = checkpoint.load(CKPT)
    s_tx = train.make_optimizer(lr=1e-4, total_steps=100)
    student = train.state_from_params(s_params, s_tx, device=dev)
    t_cfg = ModelConfig(**FLAGSHIP_KW)
    teacher = train.state_from_params(registry.init(
        t_cfg, torch.Generator().manual_seed(0)), s_tx, device=dev).params
    t_logits = train.logits(teacher, t_cfg, batch[0])
    student, _ = train.distill_step(student, (*batch, t_logits), s_cfg, s_tx,
                                    boundary_boost=2.0)  # warm-up
    batches = [tuple(torch.from_numpy(a).to(dev) for a in training_batch(
        np.random.default_rng(90 + i), TRAIN_BATCH))
        for i in range(DISTILL_STEPS)]
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    d_losses = []
    for x, labels in batches:
        t_logits = train.logits(teacher, t_cfg, x)
        student, loss = train.distill_step(
            student, (x, labels, t_logits), s_cfg, s_tx, boundary_boost=2.0)
        d_losses.append(float(loss))
    d_ms = (time.perf_counter() - t0) / DISTILL_STEPS * 1e3
    launches, dgrad = all_launches(), dict(conv.DGRAD_LAUNCHES)
    s_convs = 4 * s_cfg.depth + 2
    want = DISTILL_STEPS * (convs + 2 * s_convs - 1)
    log({"phase": "train_distill", "steps": DISTILL_STEPS,
         "batch": TRAIN_BATCH, "ms_per_step_with_teacher": d_ms,
         "losses": d_losses, "launches": launches, "dgrad_launches": dgrad,
         **card})
    if launches["conv3x3_bias_act"] + launches["conv3x3_bias_act_small_c"] \
            != want or not all(np.isfinite(d_losses)):
        raise AssertionError(f"distill steps: launches {launches}, want "
                             f"{want} K1/K2; losses {d_losses}")
    add(launches, dgrad)
    return total, dgrad_total


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
    from unetseg_tpu_torch.ops import (cc, cc_kernel, conv, conv_s8, dec1,
                                       halo_copy, morphology, postprocess)
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
    with ThreadPoolExecutor(max_workers=8) as pool:
        for fut in [pool.submit(load) for load in (
                conv.load, conv.load_f32, cc_kernel.load, dec1.load,
                halo_copy.load, native.load, dec1_phases.load,
                conv_s8.load)]:
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
    f32_res = conv.resources_f32()
    for r in f32_res:
        log({"phase": "f32_resources", **r})
    if len(f32_res) != 1 or f32_res[0]["spill_bytes"]:
        raise AssertionError(f"K8: want 1 kernel without spills, got "
                             f"{f32_res}")
    s8_res = conv_s8.resources()
    for r in s8_res:
        log({"phase": "s8_resources", **r})
    if len(s8_res) != 1 or s8_res[0]["spill_bytes"]:
        raise AssertionError(f"K7: want 1 kernel without spills, got "
                             f"{s8_res}")

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
        v = conv.variant(shape[2], torch.bfloat16)
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
    for phase in (cascade_phase, per_class_phase):
        torch.cuda.empty_cache()
        for name, n in phase(torch, np, dev, card).items():
            for k in kernels:
                if k["name"] == name:
                    k["launches"] += n
    torch.cuda.empty_cache()
    zoo_launches, zoo_err = zoo_phase(torch, np, dev, card)
    for k in kernels:
        k["launches"] += zoo_launches.get(k["name"], 0)
        k["max_abs_err"] = max(k["max_abs_err"], zoo_err.get(k["name"], 0))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pool_launches = partitions_phase(torch, np, dev, card)
    log({"phase": "partitions_seconds", "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k7, w8a8_launches = w8a8_phase(torch, np, F, dev, card)
    log({"phase": "w8a8_seconds", "seconds": time.perf_counter() - t0})
    for k in kernels:
        k["launches"] += pool_launches.get(k["name"], 0) + \
            w8a8_launches.get(k["name"], 0)
    kernels.append(k7)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k8, f32_launches = f32_phase(torch, np, F, dev, card)
    log({"phase": "f32_phase_seconds", "seconds": time.perf_counter() - t0})
    kernels.insert(2, k8)
    dgrad_launches: dict = {}
    for phase in (train_phase, train_flagship_phase):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches, dgrad = phase(torch, np, F, dev, card)
        log({"phase": f"{phase.__name__}_seconds",
             "seconds": time.perf_counter() - t0})
        for k, v in launches.items():
            f32_launches[k] = f32_launches.get(k, 0) + v
        for k, v in dgrad.items():
            dgrad_launches[k] = dgrad_launches.get(k, 0) + v
    for k in kernels:
        k["launches"] += f32_launches.get(k["name"], 0)
        if k["name"] in dgrad_launches:
            k["dgrad_launches"] = dgrad_launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
