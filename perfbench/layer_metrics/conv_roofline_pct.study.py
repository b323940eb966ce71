"""The conv kernel (K1/K2, ``csrc/conv3x3.cu``): each launch's bound
(``counts.conv_bound_s``: the larger of operations at the bf16 peak and
bytes at the memory peak) summed over the traced forwards, over the summed
time of the ``conv3x3_wgmma`` kernels in the trace."""

from perfbench import counts
from perfbench.readers import roofline_pct


def read(ctx):
    if ctx.get("cfg") is None:
        return None
    cfg = ctx["cfg"]
    return roofline_pct(ctx, "conv3x3_wgmma", len(counts.conv_launches(cfg)),
                        counts.conv_bound_s(cfg, ctx["batch"]))
