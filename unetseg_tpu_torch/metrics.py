"""Segmentation metrics: the port of ``unetseg_tpu.metrics``.

Per-class IoU and Dice from one confusion matrix (torch, any device), the
binary foreground IoU bench.py gates on, a polygon IoU that rasterises
contour sets back to masks, the boundary distances (numpy) and a Spearman
rank correlation with average ranks for ties.

The card's machine has no OpenCV, so :func:`fill_polygons` is this module's
own rasteriser: a numpy transcription of what ``cv2.fillPoly(img, contours,
1)`` fills for integer vertices inside the image (shift 0, 8-connected
edges), held against cv2 bit for bit by the CPU tests.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

Contour = Sequence[Tuple[int, int]]


def confusion_counts(pred, target, num_classes: int) -> torch.Tensor:
    """(..., H, W) integer masks -> (num_classes, num_classes) float64
    confusion matrix, rows the target class, columns the predicted one.

    Counted per slice in int64 and summed in int64, so no count wraps and
    the float64 result is exact up to 2**53 pixels."""
    p = torch.as_tensor(pred)
    t = torch.as_tensor(target, device=p.device)
    hw = p.shape[-2] * p.shape[-1] if p.ndim >= 2 else p.numel()
    idx = (t.reshape(-1, hw).long() * num_classes
           + p.reshape(-1, hw).long())
    n = idx.shape[0]
    k2 = num_classes * num_classes
    idx = idx + torch.arange(n, device=idx.device)[:, None] * k2
    counts = torch.bincount(idx.reshape(-1), minlength=n * k2)
    return counts.reshape(n, k2).sum(0).reshape(
        num_classes, num_classes).to(torch.float64)


def _iou_from_cm(cm: torch.Tensor) -> torch.Tensor:
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    return torch.where(union > 0, inter / union.clamp(min=1), 1.0)


def _dice_from_cm(cm: torch.Tensor) -> torch.Tensor:
    inter = torch.diagonal(cm)
    denom = cm.sum(0) + cm.sum(1)
    return torch.where(denom > 0, 2.0 * inter / denom.clamp(min=1), 1.0)


def iou_per_class(pred, target, num_classes: int) -> torch.Tensor:
    """Per-class intersection-over-union; classes absent from both sides
    score 1.0 (the conventional 'empty agreement' reading)."""
    return _iou_from_cm(confusion_counts(pred, target, num_classes))


def dice_per_class(pred, target, num_classes: int) -> torch.Tensor:
    return _dice_from_cm(confusion_counts(pred, target, num_classes))


def foreground_iou(pred: np.ndarray, target: np.ndarray,
                   foreground: int = 2) -> float:
    """Binary IoU of the clinically relevant class (reference FG=2); 1.0
    when neither side has any foreground."""
    p = np.asarray(pred) == foreground
    t = np.asarray(target) == foreground
    union = int(np.sum(p | t))
    if union == 0:
        return 1.0
    return int(np.sum(p & t)) / union


# ---------------------------------------------------------------------------
# Polygon rasteriser (cv2.fillPoly, integer vertices, shift 0, LINE_8)
# ---------------------------------------------------------------------------

_XY_SHIFT = 16  # OpenCV's drawing fixed point (drawing.cpp XY_SHIFT)
_XY_ONE = 1 << _XY_SHIFT


def _line_pixels(x0: int, y0: int, x1: int, y1: int):
    """The pixels of OpenCV's 8-connected ``LineIterator`` from (x0, y0) to
    (x1, y1), drawn left to right.  Its error term steps the minor axis
    after i major steps to ceil((2*d_minor*i - d_major) / (2*d_major))."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    i = np.arange(major + 1, dtype=np.int64)
    step = -((major - 2 * minor * i) // (2 * major)) if major else i
    if dy > dx:
        return x0 + step, y0 + sy * i
    return x0 + i, y0 + sy * step


def fill_polygons(contours: Sequence[Contour], height: int,
                  width: int) -> np.ndarray:
    """(height, width) bool mask of what ``cv2.fillPoly(m, contours, 1)``
    sets: every edge drawn as an 8-connected line (OpenCV's
    ``LineIterator``), then the even-odd scanline fill of all contours'
    edges together.  An edge spans rows [y_top, y_bottom); its x is held in
    16-bit fixed point from its upper vertex and stepped by the slope
    truncated toward zero; each pair of crossings fills the pixels from
    ceil(x_left) to floor(x_right).

    Vertices must lie inside the image (contours traced from a mask of this
    size do); OpenCV's clipping of outside edges is not transcribed."""
    m = np.zeros((height, width), bool)
    ys, x0s, dxs, y1s = [], [], [], []
    for c in contours:
        pts = np.asarray(c, np.int64).reshape(-1, 2)
        if len(pts) == 0:
            continue
        if (pts[:, 0].min() < 0 or pts[:, 1].min() < 0
                or pts[:, 0].max() >= width or pts[:, 1].max() >= height):
            raise ValueError("fill_polygons: vertices outside the image")
        prev = pts[-1]
        for cur in pts:
            lx, ly = _line_pixels(int(prev[0]), int(prev[1]),
                                  int(cur[0]), int(cur[1]))
            m[ly, lx] = True
            if prev[1] != cur[1]:
                (xa, ya), (xb, yb) = sorted(
                    ((int(prev[0]), int(prev[1])), (int(cur[0]), int(cur[1]))),
                    key=lambda p: p[1])
                num, den = (xb - xa) << _XY_SHIFT, yb - ya
                # C++ integer division truncates toward zero
                dx = abs(num) // den * (1 if num >= 0 else -1)
                ys.append(ya)
                x0s.append(xa << _XY_SHIFT)
                dxs.append(dx)
                y1s.append(yb)
            prev = cur
    if len(ys) < 2:  # FillEdgeCollection needs two edges
        return m
    y0 = np.asarray(ys, np.int64)
    y1 = np.asarray(y1s, np.int64)
    rows = y1 - y0  # each edge covers rows [y0, y1)
    edge = np.repeat(np.arange(len(ys)), rows)
    k = np.arange(rows.sum()) - np.repeat(np.cumsum(rows) - rows, rows)
    y = y0[edge] + k
    x = np.asarray(x0s, np.int64)[edge] + k * np.asarray(dxs, np.int64)[edge]
    order = np.lexsort((x, y))
    y, x = y[order], x[order]
    # Every row holds an even number of crossings: pair them in x order and
    # fill the pixels between each pair (the edges' own pixels are lines).
    ya = y[0::2]
    xa = np.maximum((x[0::2] + _XY_ONE - 1) >> _XY_SHIFT, 0)
    xb = np.minimum(x[1::2] >> _XY_SHIFT, width - 1)
    keep = xa <= xb
    ya, xa, xb = ya[keep], xa[keep], xb[keep]
    run = np.zeros((height, width + 1), np.int32)
    np.add.at(run, (ya, xa), 1)
    np.add.at(run, (ya, xb + 1), -1)
    return m | (np.cumsum(run, axis=1)[:, :width] > 0)


def polygon_iou(contours_a: Sequence[Contour], contours_b: Sequence[Contour],
                width: int, height: int) -> float:
    """IoU between two polygon sets via rasterisation (the BASELINE
    'polygon IoU vs reference output' metric); 1.0 when both are empty."""
    a = fill_polygons(contours_a, height, width)
    b = fill_polygons(contours_b, height, width)
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(a, b).sum() / union)


# ---------------------------------------------------------------------------
# Boundary distances (numpy)
# ---------------------------------------------------------------------------

def _boundary_points(mask: np.ndarray) -> np.ndarray:
    """(H, W) bool -> (K, 2) float64 (y, x) coords of boundary pixels: a
    foreground pixel with a 4-neighbour outside the region (the image
    border counts as outside)."""
    pad = np.pad(mask, 1, constant_values=False)
    interior = (pad[:-2, 1:-1] & pad[2:, 1:-1]
                & pad[1:-1, :-2] & pad[1:-1, 2:])
    ys, xs = np.nonzero(mask & ~interior)
    return np.stack([ys, xs], axis=1).astype(np.float64)


def _directed_min_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """min_j ||a_i - b_j|| for every boundary point a_i (chunked brute
    force)."""
    out = np.empty(len(a), np.float64)
    for i in range(0, len(a), 512):
        blk = a[i:i + 512]
        d2 = ((blk[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        out[i:i + 512] = np.sqrt(d2.min(axis=1))
    return out


def boundary_distances(pred: np.ndarray, target: np.ndarray,
                       foreground: int = 2) -> Dict[str, float]:
    """Hausdorff, 95th-percentile and average symmetric surface distance
    between the foreground regions, in pixels.  Empty against empty scores
    0.0 everywhere; one side empty scores ``inf``."""
    a = _boundary_points(np.asarray(pred) == foreground)
    b = _boundary_points(np.asarray(target) == foreground)
    if len(a) == 0 and len(b) == 0:
        return {"hausdorff": 0.0, "hd95": 0.0, "assd": 0.0}
    if len(a) == 0 or len(b) == 0:
        inf = float("inf")
        return {"hausdorff": inf, "hd95": inf, "assd": inf}
    d_ab = _directed_min_dists(a, b)
    d_ba = _directed_min_dists(b, a)
    return {
        "hausdorff": float(max(d_ab.max(), d_ba.max())),
        "hd95": float(max(np.percentile(d_ab, 95), np.percentile(d_ba, 95))),
        "assd": float((d_ab.sum() + d_ba.sum()) / (len(a) + len(b))),
    }


def evaluate_masks(pred, target, num_classes: int = 3,
                   foreground: int = 2) -> Dict[str, float]:
    """Per-class IoU and Dice, their mean IoU and the foreground IoU, all
    from one confusion matrix."""
    cm = confusion_counts(pred, target, num_classes)
    iou = _iou_from_cm(cm)
    dice = _dice_from_cm(cm)
    tp = cm[foreground, foreground]
    fg_union = float(cm[foreground, :].sum() + cm[:, foreground].sum() - tp)
    return {
        **{f"iou_class{c}": float(iou[c]) for c in range(num_classes)},
        **{f"dice_class{c}": float(dice[c]) for c in range(num_classes)},
        "mean_iou": float(iou.mean()),
        "foreground_iou": float(tp) / fg_union if fg_union > 0 else 1.0,
    }


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation with average ranks for ties; NaN when
    either input is constant (the correlation is undefined)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)

    def _ranks(x: np.ndarray) -> np.ndarray:
        order = np.argsort(x, kind="stable")
        ranks = np.empty(len(x), np.float64)
        sx = x[order]
        i = 0
        while i < len(x):
            j = i
            while j < len(x) and sx[j] == sx[i]:
                j += 1
            ranks[order[i:j]] = (i + j - 1) / 2.0  # average rank of the tie
            i = j
        return ranks

    ra, rb = _ranks(a), _ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = float(np.sqrt((ra * ra).sum() * (rb * rb).sum()))
    if denom == 0.0:
        return float("nan")
    return float((ra * rb).sum() / denom)
