"""cv::findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) in numpy and scipy:
a frozen copy of ``unetseg_tpu_torch/io/contours_py.py``, kept here so that
the benchmark's reference traces contours without importing the program.

The reference polygonizer thresholds the mask at >127 and runs OpenCV's
Suzuki-Abe border following; the served path traces in ``csrc/contour.cpp``.

Pinned OpenCV conventions (established empirically, tests enforce them):

* points are (x, y); the trace is counter-clockwise on screen starting at the
  component's raster-first pixel and heading down its left edge,
* the neighbor search rotates through direction indices
  0=E,1=NE,2=N,3=NW,4=W,5=SW,6=S,7=SE — increasing = CCW on screen;
  the initial predecessor comes from a *clockwise* search from W,
* Suzuki–Abe stop condition: next == start AND current == first-found
  predecessor,
* RETR_EXTERNAL returns only components whose surrounding background is the
  outer region (4-connected background flood from the frame); components
  nested inside holes are skipped,
* the returned list is in *reverse* raster-discovery order,
* CHAIN_APPROX_SIMPLE keeps exactly the points where the chain direction
  changes (cyclic, so runs merge across the wrap back to the start point).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Point = Tuple[int, int]

# (dx, dy); index 0..7 = E, NE, N, NW, W, SW, S, SE (increasing = CCW on screen)
_DIRS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


def _trace_outer(img: np.ndarray, x0: int, y0: int) -> List[Point]:
    """Suzuki–Abe outer-border following from the raster-first pixel."""
    # Initial clockwise search from W (index 4) for the trace predecessor.
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        nx, ny = x0 + _DIRS[s][0], y0 + _DIRS[s][1]
        if img[ny, nx]:
            break
        if s == s_end:
            return [(x0, y0)]  # isolated pixel
    i1 = (nx, ny)

    pts: List[Point] = []
    i2 = i1
    i3 = (x0, y0)
    while True:
        pts.append(i3)
        # Counter-clockwise search around i3, starting just after i2.
        dx, dy = i2[0] - i3[0], i2[1] - i3[1]
        s = _DIRS.index((dx, dy))
        while True:
            s = (s + 1) & 7
            nx, ny = i3[0] + _DIRS[s][0], i3[1] + _DIRS[s][1]
            if img[ny, nx]:
                break
        i4 = (nx, ny)
        if i4 == (x0, y0) and i3 == i1:
            break
        i2, i3 = i3, i4
    return pts


def _approx_simple(pts: List[Point]) -> List[Point]:
    """Keep only direction-change vertices of the closed chain (cyclic)."""
    n = len(pts)
    if n <= 2:
        return list(pts)

    def d(a: Point, b: Point) -> Point:
        return (b[0] - a[0], b[1] - a[1])

    out: List[Point] = []
    for i in range(n):
        prev_dir = d(pts[i - 1], pts[i])
        next_dir = d(pts[i], pts[(i + 1) % n])
        if prev_dir != next_dir:
            out.append(pts[i])
    return out


def _label_components(fg: np.ndarray, connectivity: int) -> Tuple[np.ndarray, int]:
    from scipy import ndimage

    structure = np.ones((3, 3), bool) if connectivity == 8 else None
    labels, n = ndimage.label(fg, structure=structure)
    return labels, n


def extract_contours(mask: np.ndarray, *, approx_simple: bool = True
                     ) -> List[List[Point]]:
    """findContours(mask>127, RETR_EXTERNAL, SIMPLE/NONE) parity.

    Args:
      mask: (H, W) uint8.
    Returns:
      list of contours, each a list of (x, y) int points.
    """
    binary = np.asarray(mask) > 127
    h, w = binary.shape
    padded = np.zeros((h + 2, w + 2), bool)
    padded[1:-1, 1:-1] = binary

    fg_labels, n_fg = _label_components(padded, 8)
    if n_fg == 0:
        return []
    bg_labels, _ = _label_components(~padded, 4)
    outer_bg = bg_labels[0, 0]

    # Raster-first pixel of each component (scan order = discovery order).
    # np.nonzero already yields C-order (row-major) indices, i.e. sorted by
    # (y, x) — no lexsort needed.
    ys, xs = np.nonzero(padded)
    seen = set()
    contours: List[List[Point]] = []
    for k in range(len(ys)):
        y, x = int(ys[k]), int(xs[k])
        comp = int(fg_labels[y, x])
        if comp in seen:
            continue
        seen.add(comp)
        # External iff the background left of the raster-first pixel is the
        # outer region (components inside holes are skipped).
        if bg_labels[y, x - 1] != outer_bg:
            continue
        pts = _trace_outer(padded, x, y)
        if approx_simple:
            pts = _approx_simple(pts)
        contours.append([(px - 1, py - 1) for (px, py) in pts])

    contours.reverse()  # OpenCV returns reverse discovery order
    return contours


def map_contour_points(contours, scale_x: float, scale_y: float):
    """Truncating coordinate scaling (src/mask2polygon.cpp:41-63)."""
    return [
        [(int(x * scale_x), int(y * scale_y)) for (x, y) in c] for c in contours
    ]
