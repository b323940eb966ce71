"""Multi-head softmax attention, ``softmax(q k^T / sqrt(d) [+ bias]) v``,
for the transformers of ``models/transunet.py`` and ``models/samed.py``.

On a CUDA tensor :func:`attention` runs PyTorch's
``scaled_dot_product_attention`` with the backend pinned to FlashAttention,
so the kernel, and its name in a device trace (``flash_fwd``), do not
change with PyTorch's choice of backend; where FlashAttention cannot take
the inputs, the call raises instead of falling back.  On a CPU tensor it
runs the same call on PyTorch's default CPU backend.

:func:`attention_relpos` is SAM's attention with the decomposed
relative-position bias, which FlashAttention cannot add: the bias expanded
from its two terms (``ops/relpos_bias.py``: on the card the port's
``relpos_bias`` kernel), then ``scaled_dot_product_attention`` with that
bias, on the card pinned to the memory-efficient backend (kernels
``fmha_cutlassF``), which takes an additive bf16 bias at head dim 64 and
reads the kernel's padded rows as they are; where it cannot take the
inputs, the call raises.

``LAUNCHES`` counts calls: ``attention``, one a call of :func:`attention`
(on the card each one FlashAttention launch), and ``relpos``, one a call of
:func:`attention_relpos` (on the card one bias and one attention launch).
It is registered with :func:`graphs.counts_launches`, so a captured
forward's replays count too.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from unetseg_tpu_torch import graphs
from unetseg_tpu_torch.ops import relpos_bias as relpos_bias_ops

#: Calls since the last :func:`reset_launches`: ``attention`` (on the card
#: FlashAttention launches) and ``relpos`` (rel-pos attention calls).
LAUNCHES: Dict[str, int] = graphs.counts_launches({"attention": 0,
                                                   "relpos": 0})


def reset_launches() -> None:
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """(N, heads, L, d) q, k, v -> (N, heads, L, d), in their dtype, scaled
    by 1 / sqrt(d); no mask, no dropout.  The last axis of each must be
    contiguous (a (N, L, heads, d) tensor transposed is)."""
    if q.device.type == "cuda":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            out = F.scaled_dot_product_attention(q, k, v)
    else:
        out = F.scaled_dot_product_attention(q, k, v)
    LAUNCHES["attention"] += 1
    return out


def attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_h: torch.Tensor, rel_w: torch.Tensor) -> torch.Tensor:
    """SAM's attention over a ``grid`` x ``grid`` window of tokens, ``grid
    = rel_h.shape[-1]``: (N, heads, L, d) q, k, v, ``L = grid^2``, and the
    decomposed terms (N, heads, L, grid) ``rel_h`` (of the keys' row) and
    ``rel_w`` (of their column) -> ``softmax(q k^T / sqrt(d) + rel_h[.., j
    // grid] + rel_w[.., j % grid]) v``, (N, heads, L, d) in q's dtype.
    The last axis of q, k and v must be contiguous, the terms contiguous."""
    grid = rel_h.shape[-1]
    if tuple(rel_h.shape) != (*q.shape[:-1], grid) or \
            q.shape[-2] != grid * grid:
        raise ValueError(f"attention_relpos: q {tuple(q.shape)} takes terms "
                         f"(N, heads, L, grid) over a grid x grid window, "
                         f"L = grid^2, got {tuple(rel_h.shape)}")
    bias = relpos_bias_ops.relpos_bias(rel_h, rel_w)
    if q.device.type == "cuda":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    else:
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    LAUNCHES["relpos"] += 1
    return out
