"""Attention (the ViT encoder's, ``ops/attention.py``: FlashAttention,
pinned): each forward's attention launches' bound (the configuration's
reference module's ``attention_bound_s``: the larger of 4 L^2 hidden
operations at the bf16 peak and q, k, v and the output's bytes at the
memory peak, a launch a layer) over the summed time of the ``flash_fwd``
kernels in the trace; nothing where the module counts no attention or the
trace holds another number of launches than ``attention_launches`` a
forward."""

from perfbench.readers import roofline_pct


def read(ctx):
    fam, cfg = ctx.get("family"), ctx.get("cfg")
    if fam is None or cfg is None or not hasattr(fam, "attention_launches"):
        return None
    return roofline_pct(ctx, "flash_fwd", fam.attention_launches(cfg),
                        fam.attention_bound_s(cfg, ctx["batch"]))
