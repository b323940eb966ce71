"""Per-slice confidence statistics for cascade serving, the port of
``unetseg_tpu.ops.confidence``.

The serving student's residual failures are boundary-precision failures: the
interior of an organ is never in doubt, so a whole-image confidence mean
washes the signal out.  ``boundary_margin`` scores only the pixels that
decide fg-IoU, the 3x3 boundary band of the predicted mask.  Plain tensor
ops, as the JAX version is plain XLA; the router needs one float32 scalar a
slice back on the host.
"""

from __future__ import annotations

import torch

from unetseg_tpu_torch.ops import morphology
from unetseg_tpu_torch.ops.postprocess import FOREGROUND_VALUE


def margin_map(logits: torch.Tensor) -> torch.Tensor:
    """Top-1 minus top-2 logit per pixel; (..., H, W, C) -> (..., H, W)
    float32: how far the winning class sits above the runner-up.  For the
    reference's 3 classes by pairwise max/min compares (the JAX version's
    form); otherwise ``torch.topk``."""
    if logits.shape[-1] == 3:
        l0, l1, l2 = logits.unbind(-1)
        hi = torch.maximum(l0, l1)
        lo = torch.minimum(l0, l1)
        top = torch.maximum(hi, l2)
        second = torch.maximum(lo, torch.minimum(hi, l2))
        return (top - second).float()
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).float()


def boundary_band(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    """dilate(fg) XOR erode(fg) of the foreground (class 2 only, as the
    reference's cleanup defines it, src/postprocess.cpp:5-7) with a ``size``
    x ``size`` rect window: the rim whose decisions move fg-IoU.
    (..., H, W) -> bool."""
    fg = mask == FOREGROUND_VALUE
    return morphology.dilate(fg, size) ^ morphology.erode(fg, size)


def boundary_margin(logits: torch.Tensor, mask: torch.Tensor,
                    size: int = 3) -> torch.Tensor:
    """Mean decision margin over the predicted boundary band, per slice:
    (N, H, W, C) logits and their (N, H, W) argmax mask -> (N,) float32.  A
    slice with no predicted foreground (an empty band) scores its global
    mean margin, so a confident empty slice is not routed."""
    m = margin_map(logits)
    band = boundary_band(mask, size).float()
    dims = tuple(range(1, m.ndim))
    band_n = band.sum(dims)
    band_sum = (m * band).sum(dims)
    global_mean = m.mean(dims)
    return torch.where(band_n > 0, band_sum / band_n.clamp(min=1.0),
                       global_mean)
