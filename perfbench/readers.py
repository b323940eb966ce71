"""Arithmetic the per-layer metrics' readers share: they read the context
a kind leaves (``Run.ctx``) and return None where it holds nothing to read."""

from __future__ import annotations

from typing import Optional

from perfbench import counts, peaks


def idle_pct(ctx: dict) -> Optional[float]:
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def stage_ms_per_slice(ctx: dict, *stages: str) -> Optional[float]:
    slices = ctx.get("slices_untraced") or 0
    st = ctx.get("stages") or {}
    if not slices or not any(s in st for s in stages):
        return None
    return 1e3 * sum(st.get(s, 0.0) for s in stages) / slices


def roofline_pct(ctx: dict, marker: str, per_forward: int,
                 bound_s: float) -> Optional[float]:
    """The summed bound of the launches over their summed time, where the
    trace holds exactly ``per_forward`` launches a forward the program
    counted (another count means other shapes ran: nothing to read)."""
    tr, fw = ctx.get("trace"), ctx.get("traced_forwards") or 0
    if tr is None or not fw or not per_forward:
        return None
    n, secs = tr.kernels(lambda name: marker in name)
    if n != fw * per_forward or secs <= 0:
        return None
    return 100.0 * fw * bound_s / secs


def mfu_pct(ctx: dict) -> Optional[float]:
    tr, slices = ctx.get("trace"), ctx.get("traced_slices") or 0
    if tr is None or not slices:
        return None
    flops = counts.model_flops_per_slice(ctx["cfg"]) * slices
    return 100.0 * flops / tr.window_s / peaks.BF16_FLOPS
