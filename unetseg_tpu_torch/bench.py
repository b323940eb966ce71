"""Headline benchmark of the port: 512² slices/s through the device
pipeline on one GPU, with the accuracy and parity gates of the repo's
``bench.py``.

    python -m unetseg_tpu_torch.bench [batch]

Serves the checkpoint ``checkpoint.load_serving`` picks from ``models/``
(slim4 today; seeded random weights if there is none) and prints one JSON
line with ``bench.py``'s keys:

  value              slices/s of u8 -> class masks (``InferenceEngine._masks``)
                     at the serving batch (128), between two
                     ``torch.cuda.synchronize`` calls over 20 iterations
  fg_iou, fg_iou_min foreground IoU of the argmax masks on the seed-991
                     pool of 32 synthetic slices (mean, worst slice);
                     ``hd95_max_px``, ``assd_mean_px``, ``boundary_miss_count``
                     the boundary distances on the same slices
  parity_polygon_iou polygon IoU of the served path (the CUDA kernels, the
                     host C++ cleanup and tracer, ``native.scaled_polygons``)
                     against ``reference_twin.twin_pipeline`` (numpy/scipy)
                     on the same checkpoint, 4 slices at 1024 x 768
  agreement_*        slim-vs-flagship polygon IoU; null while
                     models/flagship_synth.ckpt is absent
  p50_ms             single-slice RAW -> polygon JSON p50
                     (``parallel.pipeline.measure_p50_latency``)
  h2d_gbps           a pinned 64 MB host-to-device copy
  dispatch_rt_ms     a no-op kernel's launch-and-wait round trip
  gate_fg_iou_min    fg_iou_min >= 0.999;  gate_throughput_10x  value >= 5000

``main(device="cpu")`` runs it on the CPU (for tests).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS_DIR = os.path.join(REPO, "models")
#: The trained flagship (the distillation teacher): regenerable, not
#: tracked.  Without it the agreement keys are null.
FLAGSHIP = os.path.join(MODELS_DIR, "flagship_synth.ckpt")
BASELINE = 500.0
METRIC = "512^2 slices/sec/chip (fused normalize+UNet+argmax device pipeline)"


def _parse_batch_arg() -> int:
    """argv[1] as a positive batch size, or exit 2 with usage, before any
    device work."""
    if len(sys.argv) <= 1:
        return 128
    try:
        batch = int(sys.argv[1])
    except ValueError:
        batch = 0
    if batch <= 0:
        print(f"usage: {sys.argv[0]} [batch_size>0]", file=sys.stderr)
        raise SystemExit(2)
    return batch


def _round(x, digits):
    return None if x is None else round(x, digits)


def main(device: str = "cuda") -> int:
    batch = _parse_batch_arg()
    from unetseg_tpu_torch.utils.watchdog import arm_backend_watchdog

    def _report_outage(deadline_s: float) -> None:
        print(json.dumps({
            "metric": METRIC, "value": 0.0, "unit": "slices/sec",
            "vs_baseline": 0.0,
            "error": (f"device unresponsive: setup + first execution did "
                      f"not complete within {deadline_s:.0f}s")}),
            flush=True)

    # Armed before the first CUDA call, disarmed after the first forward.
    warm_done = arm_backend_watchdog(_report_outage)

    import torch

    from unetseg_tpu_torch import checkpoint, data, metrics
    from unetseg_tpu_torch import reference_twin as twin
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.engine import InferenceEngine
    from unetseg_tpu_torch.io import native
    from unetseg_tpu_torch.models import unet
    from unetseg_tpu_torch.ops import decode
    from unetseg_tpu_torch.ops.preprocess import preprocess_oracle_u8
    from unetseg_tpu_torch.parallel import pipeline as study_pipeline

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    found = checkpoint.load_serving(MODELS_DIR)
    if found is not None:
        params, cfg, serving = found
    else:
        cfg = ModelConfig()
        params = unet.init(cfg, torch.Generator().manual_seed(0))
        serving = "random-init"
    # the engine the study runner and measure_p50_latency share
    eng = study_pipeline.study_engine(params, cfg, device)
    size = cfg.image_size

    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, size=(batch, size, size),
                                       dtype=np.uint8)).to(dev)
    eng._masks(u8)  # warm-up (disarms the watchdog)
    sync()
    warm_done.set()
    eng._masks(u8)
    sync()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        eng._masks(u8)
    sync()
    slices_per_sec = batch * iters / (time.perf_counter() - t0)

    # --- host-to-device rate: a pinned 64 MB copy --------------------------
    big = torch.zeros((64, 1024, 1024), dtype=torch.uint8)
    if on_card:
        big = big.pin_memory()
    dst = torch.empty_like(big, device=dev)
    dst.copy_(big, non_blocking=True)
    sync()
    t0 = time.perf_counter()
    dst.copy_(big, non_blocking=True)
    sync()
    h2d_gbps = big.numel() / (time.perf_counter() - t0) / 1e9

    # --- a no-op kernel's launch-and-wait round trip -----------------------
    small = torch.zeros((8, 128), device=dev)
    out = torch.empty_like(small)
    torch.add(small, 1, out=out)
    sync()
    rts = []
    for _ in range(10):
        t0 = time.perf_counter()
        torch.add(small, 1, out=out)
        sync()
        rts.append(time.perf_counter() - t0)
    dispatch_rt_ms = float(np.percentile(rts, 50)) * 1e3

    # --- accuracy + parity on held-out synthetic slices --------------------
    fg_iou = fg_min = parity = agreement = agreement_min = None
    hd95_max = assd_mean = boundary_misses = None
    if serving != "random-init":
        raws, labels = data.synth_batch(np.random.default_rng(991), 32, size)
        u8v = np.stack([preprocess_oracle_u8(r, size) for r in raws])

        def argmax_masks(e: InferenceEngine) -> np.ndarray:
            return e.to_host(e._masks(torch.from_numpy(u8v).to(dev)))()

        pred = argmax_masks(eng)
        ious = [metrics.foreground_iou(pred[i], labels[i])
                for i in range(len(labels))]
        fg_iou = float(np.mean(ious))
        fg_min = float(np.min(ious))
        # informational; a slice with no predicted foreground has no finite
        # boundary distance and is counted apart
        bds = [metrics.boundary_distances(pred[i], labels[i])
               for i in range(len(labels))]
        finite = [d for d in bds if np.isfinite(d["hd95"])]
        boundary_misses = len(bds) - len(finite)
        hd95_max = (float(max(d["hd95"] for d in finite))
                    if finite else None)
        assd_mean = (float(np.mean([d["assd"] for d in finite]))
                     if finite else None)

        # parity with the reference twin, at an original resolution other
        # than the model's so the truncating coordinate scale is exercised
        if cfg.arch == "unet":
            ow, oh = 1024, 768
            vals = []
            for i in range(4):
                mask = native.postprocess_batch(pred[i][None])[0]
                ours = native.scaled_polygons(decode.mask_to_image_np(mask),
                                              ow, oh)
                theirs = twin.twin_pipeline(params, cfg, u8v[i], ow, oh)
                vals.append(metrics.polygon_iou(ours, theirs, ow, oh))
            parity = float(np.mean(vals))

        # student-vs-flagship polygon agreement (the distillation contract)
        if serving in ("slim", "slim4", "slim5") and os.path.exists(FLAGSHIP):
            t_params, t_cfg = checkpoint.load(FLAGSHIP)
            t_pred = argmax_masks(InferenceEngine(t_params, t_cfg, device))
            m_s_all = native.postprocess_batch(pred)
            m_t_all = native.postprocess_batch(t_pred)
            avals = []
            for i in range(len(labels)):
                p_s = native.scaled_polygons(
                    decode.mask_to_image_np(m_s_all[i]), size, size)
                p_t = native.scaled_polygons(
                    decode.mask_to_image_np(m_t_all[i]), size, size)
                avals.append(metrics.polygon_iou(p_s, p_t, size, size))
            agreement = float(np.mean(avals))
            agreement_min = float(np.min(avals))

    # --- p50 single-slice RAW -> polygon-JSON latency -----------------------
    # a realistic slice: noise masks clean to nothing and skip the contour
    # trace and JSON stages this metric is named for
    raw, _ = data.synth_slice(np.random.default_rng(7), size)
    p50_ms = study_pipeline.measure_p50_latency(
        params, cfg, raw, size, size, iters=20, device=device) * 1e3
    # what a synchronous slice call pays at least: one launch-and-wait
    # round trip and the u8 slice's copies in and out
    copies_ms = 2 * size * size / (h2d_gbps * 1e9) * 1e3
    explained_ms = min(p50_ms, dispatch_rt_ms + copies_ms)

    print(json.dumps({
        "metric": METRIC,
        "value": round(slices_per_sec, 2),
        "unit": "slices/sec",
        "vs_baseline": round(slices_per_sec / BASELINE, 3),
        "serving_checkpoint": serving,
        "serving_batch": batch,
        "fg_iou": _round(fg_iou, 4),
        "fg_iou_min": _round(fg_min, 4),
        "parity_polygon_iou": _round(parity, 4),
        "agreement_polygon_iou": _round(agreement, 4),
        "agreement_polygon_iou_min": _round(agreement_min, 4),
        "hd95_max_px": _round(hd95_max, 2),
        "assd_mean_px": _round(assd_mean, 3),
        "boundary_miss_count": boundary_misses,
        "gate_fg_iou_min": None if fg_min is None else bool(fg_min >= 0.999),
        "gate_throughput_10x": bool(slices_per_sec >= 10 * BASELINE),
        "p50_ms": round(p50_ms, 2),
        "h2d_gbps": round(h2d_gbps, 3),
        "dispatch_rt_ms": round(dispatch_rt_ms, 3),
        "p50_ms_note": (
            f"{explained_ms:.3f} ms of this p50 is the floor of any "
            f"synchronous slice call on this device: one launch-and-wait "
            f"round trip ({dispatch_rt_ms:.3f} ms, measured on a no-op "
            f"kernel) and two u8 slice copies at the measured "
            f"{h2d_gbps:.2f} GB/s ({copies_ms:.3f} ms); the rest is host "
            f"preprocess, cleanup, contour trace and JSON"),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
