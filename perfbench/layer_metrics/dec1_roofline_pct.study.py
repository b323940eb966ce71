"""The fused last level (K6, ``csrc/dec1_fused.cu``): one launch a
forward; its bound (``counts.dec1_bound_s``) over the summed time of the
``dec1_wgmma`` kernels in the trace."""

from perfbench import counts
from perfbench.readers import roofline_pct


def read(ctx):
    cfg = ctx.get("cfg")
    if cfg is None or not counts.fused_last_level(cfg):
        return None
    return roofline_pct(ctx, "dec1_wgmma", 1,
                        counts.dec1_bound_s(cfg, ctx["batch"]))
