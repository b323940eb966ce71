"""Accuracy off the training family: the port of ``benchmarks/eval_shift.py``.

    python -m unetseg_tpu_torch.benchmarks.eval_shift [n_per_kind]
        [candidate.ckpt] [--device cuda]

The models were trained on one family of synthetic slices; this report
draws ``n_per_kind`` (default 24) slices of each of four families they
never saw (``data.synth_slice_shifted``: lobulated organs, crescents,
illumination gradients with streak noise, several organs) and reports, per
family:

* the student's foreground IoU against the labels (mean, min), the worst
  95th-percentile boundary distance and the slices with no foreground
  predicted (``metrics.boundary_distances``);
* the teacher's IoU and the student-teacher agreement, when the teacher
  checkpoint (``flagship_synth_robust.ckpt``, then ``flagship_synth.ckpt``,
  neither tracked) is in ``models/``; None otherwise;
* the full pipeline's polygon IoU against the reference twin on the first
  ``min(4, n)`` slices: the host C++ cleanup and ``native.scaled_polygons``
  against ``reference_twin.twin_pipeline`` on the same checkpoint (~1.0
  whatever the content: it checks the stages, not the model).

The student is ``checkpoint.load_serving(models, include_flagship=False)``
(slim4 in this repo), or the candidate checkpoint given.  Predictions are
u8 / 255 -> model -> argmax, without the cleanup.  The last line is
``{"shift_eval": {...}}`` with the JAX script's field names.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib
from typing import Callable, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODELS_DIR = os.path.join(REPO, "models")
KINDS = ("lobulated", "crescent", "illum", "multiorgan")
TEACHERS = ("flagship_synth_robust.ckpt", "flagship_synth.ckpt")
SIZE = 512
#: Slices of each family held against the reference twin.
PARITY_SLICES = 4


def shifted_slices(kind: str, n: int):
    """(raws, labels, u8) of ``n`` slices of family ``kind`` from its own
    seed (``crc32(kind)``), as the JAX script draws them; u8 through the
    bit-exact host preprocess."""
    from unetseg_tpu_torch import data
    from unetseg_tpu_torch.io import native

    rng = np.random.default_rng(zlib.crc32(kind.encode()) % 2**31)
    raws = np.empty((n, SIZE, SIZE), np.uint16)
    labels = np.empty((n, SIZE, SIZE), np.uint8)
    for i in range(n):
        raws[i], labels[i] = data.synth_slice_shifted(rng, SIZE, kind)
    u8 = np.stack([native.preprocess_u8(r, SIZE) for r in raws])
    return raws, labels, u8


def make_pred(params, cfg, device: str) -> Callable[[np.ndarray], np.ndarray]:
    """(N, S, S) uint8 -> (N, S, S) uint8 class masks of the model on
    ``device``: u8 / 255, the model, the first-max argmax, no cleanup."""
    import torch

    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops.preprocess import model_input_from_u8

    model = registry.build(params, cfg, device)

    @torch.inference_mode()
    def pred(u8: np.ndarray) -> np.ndarray:
        x = model_input_from_u8(torch.from_numpy(u8).to(device))[..., None]
        return model.masks(x).cpu().numpy()

    return pred


def _mean_min(values: Optional[Sequence[float]]):
    if values is None:
        return None, None
    return float(np.mean(values)), float(np.min(values))


def evaluate(n: int = 24, kinds: Sequence[str] = KINDS,
             device: str = "cuda", candidate: Optional[str] = None,
             log=print) -> dict:
    """The report over ``kinds``, ``n`` slices each; ``log`` gets one line
    per family."""
    from unetseg_tpu_torch import checkpoint, metrics
    from unetseg_tpu_torch import reference_twin as twin
    from unetseg_tpu_torch.io import native
    from unetseg_tpu_torch.ops.decode import mask_to_image_np

    if candidate is not None:
        s_params, s_cfg = checkpoint.load(candidate)
        s_name = os.path.basename(candidate)
    else:
        found = checkpoint.load_serving(MODELS_DIR, include_flagship=False)
        if found is None:
            raise FileNotFoundError(f"no serving student in {MODELS_DIR}")
        s_params, s_cfg, s_name = found
    t_name = next((c for c in TEACHERS
                   if os.path.exists(os.path.join(MODELS_DIR, c))), None)
    pred_s = make_pred(s_params, s_cfg, device)
    pred_t = (make_pred(*checkpoint.load(os.path.join(MODELS_DIR, t_name)),
                        device) if t_name is not None else None)
    report = {"student": s_name, "teacher": t_name}

    for kind in kinds:
        _, labels, u8 = shifted_slices(kind, n)
        ps = pred_s(u8)
        s_iou = [metrics.foreground_iou(ps[i], labels[i]) for i in range(n)]
        t_iou = agree = None
        if pred_t is not None:
            pt = pred_t(u8)
            t_iou = [metrics.foreground_iou(pt[i], labels[i])
                     for i in range(n)]
            agree = [metrics.foreground_iou(ps[i], pt[i]) for i in range(n)]

        # the served stages (host cleanup, tracer, scaling) against the
        # twin oracle at 1024 x 768
        parity = []
        for i in range(min(PARITY_SLICES, n)):
            vis = mask_to_image_np(native.postprocess_batch(ps[i][None])[0])
            ours = native.scaled_polygons(vis, 1024, 768)
            theirs = twin.twin_pipeline(s_params, s_cfg, u8[i], 1024, 768)
            parity.append(metrics.polygon_iou(ours, theirs, 1024, 768))

        hd95s = [d["hd95"] for d in (metrics.boundary_distances(
            ps[i], labels[i]) for i in range(n)) if np.isfinite(d["hd95"])]
        s_mean, s_min = _mean_min(s_iou)
        t_mean, t_min = _mean_min(t_iou)
        a_mean, a_min = _mean_min(agree)
        report[kind] = {
            "student_fg_iou": s_mean,
            "student_fg_iou_min": s_min,
            "student_hd95_max_px": float(np.max(hd95s)) if hd95s else None,
            # slices with no predicted foreground (an infinite distance)
            "student_boundary_misses": n - len(hd95s),
            "teacher_fg_iou": t_mean,
            "teacher_fg_iou_min": t_min,
            "student_teacher_agreement": a_mean,
            "agreement_min": a_min,
            "pipeline_twin_parity": float(np.mean(parity)),
        }
        log(kind, json.dumps(report[kind]))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_per_kind", nargs="?", type=int, default=24)
    ap.add_argument("candidate", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = evaluate(args.n_per_kind, device=args.device,
                      candidate=args.candidate,
                      log=lambda *a: print(*a, flush=True))
    print(json.dumps({"shift_eval": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
