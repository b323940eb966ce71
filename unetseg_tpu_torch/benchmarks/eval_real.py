"""The one genuine MR slice through every serving mode: the port of
``benchmarks/eval_real.py``.

    python -m unetseg_tpu_torch.benchmarks.eval_real [--out F]
        [--device cuda]

Every other accuracy number of the repo is earned on synthetic phantoms.
This pass runs the served pipeline (RAW file -> ``engine`` -> the five
artifacts) on matplotlib's sample ``s1045.ima.gz``, a real 256x256 uint16
MR head slice, which the package carries (``data.SAMPLE_SLICE``), in the
reference's input format (headerless little-endian u16).  A pool of 13
variants (8 dihedral orientations, 3 window/level remaps, 2 centre crops:
``data.real_mri_pool``) keeps the pixels real while it varies the resample
ratio and the contrast.

A. Each variant through ``engine.process_single_image``: all five
   artifacts; the polygon IoU of the written ``{base}.json`` against the
   reference twin on the same checkpoint (``twin_parity``: the stages hold
   on real anatomy); the foreground IoU of the served mask against an Otsu
   pseudo-label through the same cleanup (``plausibility_iou``: a probe,
   not a gate; the slice has no ground truth); the teacher's polygon
   agreement when ``models/flagship_synth_robust.ckpt`` (or
   ``flagship_synth.ckpt``) is there; the contour count.
B. ``engine.process_batch`` over the 256x256 variants: every artifact byte
   of the serial run, or ``batched_byte_equal`` is false.
C. ``tta=True`` on rot0 against the single pass (polygon IoU).
D. Sliding windows of 256 on the slice at 512² (``data.real_mri_512``, the
   reference's own resample) against the full-frame rot0 polygons.
E. A 2x2 mosaic of the slice: four heads, each below the cleanup's
   6%-of-frame floor, so the cleaned mask is empty and no contour JSON is
   written, as the reference would.

The serving checkpoint is ``checkpoint.load_serving``'s.  It raises when
the slice or the checkpoint is missing, and on any failed stage.  It
writes the report only where ``--out`` says; the artifacts go to a
temporary directory, removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODELS_DIR = os.path.join(REPO, "models")
TEACHERS = ("flagship_synth_robust.ckpt", "flagship_synth.ckpt")
ARTIFACTS = ("_normalized.png", "_original_sizes.json", "_mask.png",
             "_contour_overlay.png", ".json")
#: The variant stages C and D start from.
BASE_VARIANT = "rot0"


def otsu_threshold(u8: np.ndarray) -> int:
    """Otsu's between-class-variance threshold on a u8 image."""
    hist = np.bincount(u8.ravel(), minlength=256).astype(np.float64)
    csum = np.cumsum(hist)
    cmean = np.cumsum(hist * np.arange(256))
    w0 = csum / csum[-1]
    w1 = 1.0 - w0
    m0 = np.where(csum > 0, cmean / np.maximum(csum, 1), 0.0)
    m1 = np.where(csum[-1] - csum > 0,
                  (cmean[-1] - cmean) / np.maximum(csum[-1] - csum, 1), 0.0)
    return int(np.argmax(w0 * w1 * (m0 - m1) ** 2))


def _polygons(path: str):
    with open(path, "rb") as f:
        return [[(int(x), int(y)) for x, y in s["points"]]
                for s in json.load(f)["shapes"]]


def _serve(engine, raw: np.ndarray, d: str, name: str, **kw) -> str:
    """``raw`` written to ``d/name.raw`` and served into ``d``; its path."""
    from unetseg_tpu_torch.io import raw as raw_io

    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.raw")
    raw_io.write_raw(path, raw)
    h, w = raw.shape
    if not engine.process_single_image(path, w, h, d, **kw):
        raise RuntimeError(f"process_single_image failed on {name} {kw}")
    return path


def evaluate(device: str = "cuda", variants: Optional[Sequence[str]] = None,
             workdir: Optional[str] = None, log=print) -> dict:
    """Stages A-E; returns ``{"rows": [...], "summary": {...}}``.
    ``variants`` (default: the whole pool) must hold rot0; ``workdir``
    keeps the artifacts there (default: a temporary directory, removed)."""
    import torch

    from unetseg_tpu_torch import checkpoint, data, engine, metrics
    from unetseg_tpu_torch import reference_twin as twin
    from unetseg_tpu_torch.io import native, png
    from unetseg_tpu_torch.ops import preprocess

    pool = data.real_mri_pool()
    if not pool:
        raise FileNotFoundError(
            f"the real MR slice is missing ({data.SAMPLE_SLICE})")
    if variants is not None:
        pool = [(n, r) for n, r in pool if n in variants]
    if BASE_VARIANT not in [n for n, _ in pool]:
        raise ValueError(f"the variants must hold {BASE_VARIANT}")
    loaded = checkpoint.load_serving(MODELS_DIR)
    if loaded is None:
        raise FileNotFoundError(f"no serving checkpoint in {MODELS_DIR}")
    params, cfg, serving = loaded
    teacher = next((checkpoint.load(os.path.join(MODELS_DIR, c))
                    for c in TEACHERS
                    if os.path.exists(os.path.join(MODELS_DIR, c))), None)

    keep = workdir is not None
    workdir = workdir or tempfile.mkdtemp(prefix="eval_real_")
    ckpt = os.path.join(workdir, "engine", "serving.ckpt")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    checkpoint.save(ckpt, params, cfg)
    if not engine.initialize_engine(ckpt, log_dir=os.path.join(workdir, "log"),
                                    device=device):
        raise RuntimeError(f"initialize_engine failed on {ckpt}")
    rows = []
    try:
        # -- A. every variant through process_single_image ----------------
        for name, raw in pool:
            h, w = raw.shape
            out_dir = os.path.join(workdir, "A", name)
            raw_path = _serve(engine, raw, out_dir, name)
            missing = [name + a for a in ARTIFACTS
                       if not os.path.exists(os.path.join(out_dir, name + a))]
            if missing:
                raise RuntimeError(f"{name}: missing artifacts {missing}")
            ours = _polygons(os.path.join(out_dir, f"{name}.json"))
            u8 = preprocess.preprocess_oracle_u8(raw, cfg.image_size)
            parity = metrics.polygon_iou(
                ours, twin.twin_pipeline(params, cfg, u8, w, h), w, h)
            # the plausibility probe: an Otsu pseudo-label, same cleanup
            proxy = native.postprocess_batch(np.where(
                u8 > otsu_threshold(u8), 2, 0).astype(np.uint8)[None])[0]
            vis = png.read_png_gray(os.path.join(out_dir, f"{name}_mask.png"))
            pred = np.where(vis == 255, 2,
                            np.where(vis == 128, 1, 0)).astype(np.uint8)
            plaus = metrics.foreground_iou(pred, proxy)
            agree = None
            if teacher is not None:
                agree = metrics.polygon_iou(
                    ours, twin.twin_pipeline(*teacher, u8, w, h), w, h)
            rows.append({"variant": name, "w": w, "h": h,
                         "twin_parity": float(parity),
                         "plausibility_iou": float(plaus),
                         "teacher_agreement": agree,
                         "contours": len(ours),
                         "_out_dir": out_dir, "_raw_path": raw_path})
            log(f"{name:18s} parity {parity:.5f}  plaus {plaus:.4f}  agree "
                f"{'-' if agree is None else f'{agree:.4f}'}  contours "
                f"{len(ours)}")

        # -- B. the batched path, byte-equal to the serial artifacts ------
        b_rows = [r for r in rows if (r["w"], r["h"]) == (256, 256)]
        b_dirs = [os.path.join(workdir, "B", r["variant"]) for r in b_rows]
        got = engine.process_batch([r["_raw_path"] for r in b_rows], 256,
                                   256, b_dirs)
        if got != (len(b_rows), 0):
            raise RuntimeError(f"process_batch: (ok, failed) {got}")
        batched_equal = True
        for r, d in zip(b_rows, b_dirs):
            for a in ARTIFACTS:
                f = r["variant"] + a
                with open(os.path.join(r["_out_dir"], f), "rb") as x, \
                        open(os.path.join(d, f), "rb") as y:
                    if x.read() != y.read():
                        batched_equal = False
                        log(f"BATCH MISMATCH {f}")
        log(f"batched-vs-serial byte equality over {len(b_rows)} real "
            f"variants x 5 artifacts: {batched_equal}")

        # -- C. TTA against the single pass --------------------------------
        base = next(r for r in rows if r["variant"] == BASE_VARIANT)
        base_polys = _polygons(os.path.join(base["_out_dir"],
                                            f"{BASE_VARIANT}.json"))
        tta_dir = os.path.join(workdir, "C")
        _serve(engine, dict(pool)[BASE_VARIANT], tta_dir, BASE_VARIANT,
               tta=True)
        tta_vs_base = metrics.polygon_iou(
            _polygons(os.path.join(tta_dir, f"{BASE_VARIANT}.json")),
            base_polys, 256, 256)
        log(f"tta-vs-single polygon IoU on real slice: {tta_vs_base:.4f}")

        # -- D. windows on the slice at 512² against the full frame --------
        win_dir = os.path.join(workdir, "D")
        _serve(engine, data.real_mri_512(), win_dir, "big", window=256)
        win_polys = _polygons(os.path.join(win_dir, "big.json"))
        base512 = [[(2 * x, 2 * y) for x, y in p] for p in base_polys]
        win_vs_serial = metrics.polygon_iou(win_polys, base512, 512, 512)
        log(f"sliding-window (512² real, window=256) vs full-frame polygon "
            f"IoU: {win_vs_serial:.4f}  contours {len(win_polys)}")

        # -- E. the multi-organ mosaic: the cleanup leaves nothing ---------
        mosaic = data.real_mri_mosaic(2)
        mos_dir = os.path.join(workdir, "E")
        _serve(engine, mosaic, mos_dir, "mosaic", window=256)
        mosaic_empty = bool((png.read_png_gray(os.path.join(
            mos_dir, "mosaic_mask.png")) == 0).all())
        mosaic_json = os.path.exists(os.path.join(mos_dir, "mosaic.json"))
        # the model does segment the heads before the cleanup
        eng = engine.get_engine()
        with torch.inference_mode():
            pre = eng.infer_tiled(preprocess.normalize_u8(
                eng._put(mosaic)), 256)
        pre_fg = int((pre > 0).sum())
        log(f"mosaic pre-cleanup fg px {pre_fg} (4 organs), per-organ "
            f"survivor < 6% floor {0.06 * pre.numel():.0f} px -> cleaned "
            f"mask empty: {mosaic_empty}, json emitted: {mosaic_json}")
        if not mosaic_empty or mosaic_json or pre_fg == 0:
            raise RuntimeError("multi-organ cleanup semantics changed")
    finally:
        engine.cleanup_resources()
        if not keep:
            shutil.rmtree(workdir, ignore_errors=True)
    for r in rows:  # bookkeeping, not part of the report
        del r["_out_dir"], r["_raw_path"]

    parities = [r["twin_parity"] for r in rows]
    plaus = [r["plausibility_iou"] for r in rows]
    agrees = [r["teacher_agreement"] for r in rows
              if r["teacher_agreement"] is not None]
    summary = {
        "metric": "real_mri_twin_parity_min",
        "value": float(np.min(parities)),
        "unit": "polygon_iou",
        "serving": serving,
        "device": str(torch.device(device)),
        "variants": len(rows),
        "twin_parity_mean": float(np.mean(parities)),
        "plausibility_iou_mean": float(np.mean(plaus)),
        "plausibility_iou_min": float(np.min(plaus)),
        "teacher_agreement_mean": float(np.mean(agrees)) if agrees else None,
        "teacher_agreement_min": float(np.min(agrees)) if agrees else None,
        "batched_byte_equal": batched_equal,
        "batched_variants": len(b_rows),
        "tta_vs_single_polygon_iou": tta_vs_base,
        "window_vs_serial_polygon_iou": win_vs_serial,
        "window_contours": len(win_polys),
        "mosaic_multiorgan_cleanup_empty": mosaic_empty,
    }
    return {"rows": rows, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = evaluate(args.device, log=lambda s: print(s, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
