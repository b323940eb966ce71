"""The five BASELINE configs on the card, one JSON report: the port of
``benchmarks/run_all.py``.

    python -m unetseg_tpu_torch.benchmarks.run_all [--slices N] [--out F]
        [--device cuda]

Configs (BASELINE.md), with the keys of the JAX script's report:

  1. one 512² slice -> polygon JSON, p50 latency
     (``parallel.pipeline.measure_p50_latency``);
  2. batch-32 and batch-128 slices through the device preprocess, the model
     and the argmax, the u16 RAWs uploaded once; per-class contours
     (``native.contours_per_class``) of 8 label slices on the host; 2b the
     same with the mask cleanup on the device (``ops/postprocess``: K3 on
     the card);
  3. 1024² images by sliding windows of 512 with overlap 256
     (``parallel.tiles``), one image and a batch of 8;
  4. a study of ``--slices`` RAWs through ``run_study`` at batch 128 with
     the host preprocess, per artifact tier (none, json, mask_json, full);
  5. the 8-fold dihedral TTA (``parallel.tta``): one slice, 16 slices as
     one batch, and the weight-space form on the 16.

The checkpoint is ``checkpoint.load_serving``'s (slim4 in this repo), else
a seeded ``ModelConfig()``.  Every timed config warms up once, queues its
calls and synchronises once after the loop, so each time is the card's
work plus the host's enqueueing.  The inputs are drawn from
``np.random.default_rng(0)`` in the JAX script's order, so both draw the
same arrays.  A watchdog armed before the first CUDA call kills the process
with exit 2 if the card does not answer; nothing falls back to the CPU
unless ``--device cpu`` asks for it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODELS_DIR = os.path.join(REPO, "models")
#: The artifact tiers of config 4, in the JAX script's order (None: none).
STUDY_TIERS = (None, "json", "mask_json", "full")


def config2_programs(eng, size: int) -> Tuple[Callable, Callable]:
    """Config 2's and 2b's device programs on engine ``eng``: (N, h, w)
    uint16 RAWs on its device -> (N, size, size) masks.  Config 2 is the
    device preprocess, the model and the argmax (JAX's ``dev``); 2b adds
    the device mask cleanup (JAX's ``fused_all_device``)."""
    import torch

    from unetseg_tpu_torch.ops import postprocess, preprocess

    def dev(raws):
        with torch.inference_mode():
            u8, x = preprocess.preprocess_batch(raws, size)
            return eng._masks(u8, x)

    def fused_all_device(raws):
        masks = dev(raws)
        with torch.inference_mode():
            return postprocess.postprocess_masks(masks)

    return dev, fused_all_device


def report(slices: int = 300, device: str = "cuda", size: int = 512,
           serving: Optional[tuple] = None, warm_done=None) -> dict:
    """The five configs' report on ``device``.  ``serving`` is (params,
    cfg, name) as ``checkpoint.load_serving`` returns it (default: its
    pick from ``models/``, else a seeded ``ModelConfig()``).  ``size`` is
    the side of the drawn slices (the 1024² images are 2 * size, the
    windows size); ``warm_done.set()`` is called once config 1 ran."""
    import torch

    from unetseg_tpu_torch import checkpoint
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.data import synth_batch, synth_slice
    from unetseg_tpu_torch.io import native, raw as raw_io
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.parallel import pipeline as ppl
    from unetseg_tpu_torch.parallel import tiles, tta

    dev = torch.device(device)
    if serving is None:
        serving = checkpoint.load_serving(MODELS_DIR)
    if serving is None:
        cfg = ModelConfig()
        serving = (registry.init(cfg, torch.Generator().manual_seed(0)), cfg,
                   "random-init")
    params, cfg, ckpt_name = serving
    # one engine (one model) for configs 1, 2 and 4; 3 and 5 take its
    # model.  Without CUDA a "cuda" device raises here.
    eng = ppl.study_engine(params, cfg, device)
    model = eng.model
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else str(dev)),
           "checkpoint": ckpt_name}
    rng = np.random.default_rng(0)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(call: Callable, iters: int) -> float:
        """Seconds per call: one warm-up call, then ``iters`` calls queued
        and one synchronisation after the last."""
        call()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        sync()
        return (time.perf_counter() - t0) / iters

    def put(a: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- config 1: single slice -> polygon JSON p50 latency --------------
    raw, _ = synth_slice(rng, size)
    p50 = ppl.measure_p50_latency(params, cfg, raw, size, size, iters=15,
                                  device=device)
    if warm_done is not None:
        warm_done.set()  # the card answered end to end
    out["c1_p50_slice_to_json_ms"] = p50 * 1000

    # ---- config 2: batch 32 and 128, per-class contours ------------------
    raws, _ = synth_batch(rng, 32, size)
    c2, c2b = config2_programs(eng, cfg.image_size)
    raws_dev = put(raws)  # uploaded once; the batches stay resident
    dt = timed(lambda: c2(raws_dev), 10)
    out["c2_batch32_device_slices_per_sec"] = 32 / dt
    raws128 = put(np.repeat(raws, 4, axis=0))
    dt128 = timed(lambda: c2(raws128), 8)
    out["c2_serving_batch128_slices_per_sec"] = 128 / dt128
    # per-class contours of ground-truth-shaped masks on the host
    _, labels8 = synth_batch(rng, 8, size)
    t0 = time.perf_counter()
    n_contours = sum(len(cs) for k in range(8)
                     for cs in native.contours_per_class(labels8[k]).values())
    out["c2_per_class_contour_ms_per_slice_host"] = \
        (time.perf_counter() - t0) / 8 * 1000
    out["c2_total_contours"] = n_contours

    # ---- config 2b: all-device serving (device mask cleanup) -------------
    dt = timed(lambda: c2b(raws_dev), 5)
    out["c2_all_device_slices_per_sec"] = 32 / dt
    out["c2_all_device_ms_per_batch"] = dt * 1000

    # ---- config 3: 1024² sliding windows ---------------------------------
    big = np.zeros((2 * size, 2 * size), np.uint16)
    big[:size, :size] = synth_slice(rng, size)[0]
    big[size:, size:] = synth_slice(rng, size)[0]
    fn = tiles.make_tiled_pipeline(model, window=size, overlap=size // 2,
                                   device_postprocess=False)
    u8big = put((big >> 8).astype(np.uint8))
    dt = timed(lambda: fn(u8big), 5)
    out["c3_1024_tile_sliding_window_ms"] = dt * 1000
    out["c3_equivalent_512_slices_per_sec"] = 4 / dt
    # 8 images' windows through the model together, each blended alone
    big8 = np.stack([big] * 8)
    big8[1:, :size, size:] = synth_slice(rng, size)[0]
    fnb = tiles.make_tiled_batch_pipeline(model, window=size,
                                          overlap=size // 2,
                                          device_postprocess=False)
    u8big8 = put((big8 >> 8).astype(np.uint8))
    dtb = timed(lambda: fnb(u8big8), 5)
    out["c3_batched8_ms"] = dtb * 1000
    out["c3_batched_equivalent_512_slices_per_sec"] = 8 * 4 / dtb

    # ---- config 4: full study throughput per artifact tier ---------------
    with tempfile.TemporaryDirectory() as td:
        raws_np, _ = synth_batch(rng, min(slices, 32), size)
        paths = []
        for i in range(slices):
            p = os.path.join(td, f"s{i:04d}.raw")
            raw_io.write_raw(p, raws_np[i % raws_np.shape[0]])
            paths.append(p)
        for tier in STUDY_TIERS:
            res = ppl.run_study(
                params, cfg, paths, size, size, batch_size=128,
                host_preprocess=True, artifacts=tier,
                out_dir=None if tier is None else os.path.join(
                    td, f"out_{tier}"), device=device)
            out[f"c4_study_slices_per_sec_{tier or 'e2e'}"] = \
                res.slices_per_sec
    out["c4_study_slices"] = slices
    out["c4_study_wall_s_full"] = res.wall_s  # the last tier's

    # ---- config 5: TTA ensemble ------------------------------------------
    u8 = put((synth_slice(rng, size)[0] >> 8).astype(np.uint8))
    fn = tta.make_tta_pipeline(model, device_postprocess=False)
    out["c5_tta8_ensemble_ms_per_slice"] = timed(lambda: fn(u8), 5) * 1000
    u8_16 = put(np.stack([(synth_slice(rng, size)[0] >> 8).astype(np.uint8)
                          for _ in range(16)]))
    fnb5 = tta.make_tta_batch_pipeline(model, device_postprocess=False)
    out["c5_tta8_batched16_ms_per_slice"] = \
        timed(lambda: fnb5(u8_16), 5) * 1000 / 16
    # the weight-space form (engine.infer_tta's): its 8 models are built
    # here, before the clock
    fnw5 = tta.make_tta_weightspace_pipeline(params, cfg, dev,
                                             device_postprocess=False)
    out["c5_tta8_weightspace16_ms_per_slice"] = \
        timed(lambda: fnw5(u8_16), 5) * 1000 / 16
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slices", type=int, default=300)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from unetseg_tpu_torch.utils.watchdog import arm_backend_watchdog

    warm_done = arm_backend_watchdog(lambda deadline: print(json.dumps({
        "error": (f"device unresponsive within {deadline:.0f}s — no "
                  "configs measured")}), flush=True))
    line = json.dumps(report(args.slices, args.device, warm_done=warm_done),
                      sort_keys=True)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
