"""Rel-pos attention (SAM's encoder, ``ops/attention.attention_relpos``:
the port's ``relpos_bias`` kernel, then the memory-efficient backend,
pinned): each forward's launches' bound (the configuration's reference
module's ``relpos_attention_bound_s``: a launch a block, the larger of 4
L^2 hidden operations a window at the bf16 peak and q, k, v, the output
and the two decomposed terms' bytes at the memory peak) over the summed
time of the kernels whose name holds ``relpos`` and of the backend's
``fmha_cutlassF`` kernels; nothing where the module counts no rel-pos
attention or where the trace holds another number than
``relpos_attention_launches`` ``relpos`` kernels a forward.  Where the
trace holds the bias kernel (``relpos_bias_kernel``), the backend's
kernels must number as many as the ``relpos`` ones; only without it may
they number none (a kernel that fuses the bias into the attention, named
with ``relpos``, is read alone)."""

BIAS = "relpos"
BIAS_KERNEL = "relpos_bias_kernel"
BACKEND = "fmha_cutlassF"


def read(ctx):
    fam, cfg = ctx.get("family"), ctx.get("cfg")
    tr, fw = ctx.get("trace"), ctx.get("traced_forwards") or 0
    if fam is None or cfg is None or tr is None or not fw or \
            not hasattr(fam, "relpos_attention_launches"):
        return None
    per_forward = fam.relpos_attention_launches(cfg)
    n_bias, t_bias = tr.kernels(lambda name: BIAS in name)
    n_attn, t_attn = tr.kernels(lambda name: BACKEND in name)
    separate, _ = tr.kernels(lambda name: BIAS_KERNEL in name)
    attn_counts = (n_bias,) if separate else (0, n_bias)
    if not per_forward or n_bias != fw * per_forward or \
            n_attn not in attn_counts or t_bias + t_attn <= 0:
        return None
    return 100.0 * fw * fam.relpos_attention_bound_s(cfg, ctx["batch"]) \
        / (t_bias + t_attn)
