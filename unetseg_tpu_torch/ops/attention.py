"""Multi-head softmax attention, ``softmax(q k^T / sqrt(d)) v``, for the
transformer of ``models/transunet.py``.

On a CUDA tensor :func:`attention` runs PyTorch's
``scaled_dot_product_attention`` with the backend pinned to FlashAttention,
so the kernel, and its name in a device trace (``flash_fwd``), do not
change with PyTorch's choice of backend; where FlashAttention cannot take
the inputs, the call raises instead of falling back.  On a CPU tensor it
runs the same call on PyTorch's default CPU backend.

``LAUNCHES`` counts calls, one a layer of a forward: on the card each is
one FlashAttention launch.  It is registered with
:func:`graphs.counts_launches`, so a captured forward's replays count too.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from unetseg_tpu_torch import graphs

#: Attention calls (on the card: FlashAttention launches) since the last
#: :func:`reset_launches`.
LAUNCHES: Dict[str, int] = graphs.counts_launches({"attention": 0})


def reset_launches() -> None:
    LAUNCHES["attention"] = 0


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
