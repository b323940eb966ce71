"""The share of the traced window in which the device was idle, as
``device_idle_pct.study`` counts it, while a span of one name was open on
the host: the readers of the ``idle_*_pct`` metrics share it."""

from __future__ import annotations

from typing import List, Optional, Tuple

from perfbench.trace import _union


def _overlap_s(xs: List[Tuple[float, float]],
               ys: List[Tuple[float, float]]) -> float:
    """Summed overlap of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_while_pct(ctx: dict, span: str) -> Optional[float]:
    """100 x (the window's time with ``span`` open and nothing on the
    device) / the window; None without a trace or without such a span."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    opened = _union([(max(a, tr.t0), min(b, tr.t1))
                     for name, a, b in tr.host
                     if name == span and min(b, tr.t1) > max(a, tr.t0)])
    if not opened:
        return None
    busy = _union([(a, b) for _, a, b in tr._clipped()])
    open_us = sum(b - a for a, b in opened)
    return 100.0 * (open_us - _overlap_s(opened, busy)) / (tr.t1 - tr.t0)
