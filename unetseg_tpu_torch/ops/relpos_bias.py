"""The expanded decomposed relative-position bias of SAM's attention
(``models/samed.py``): ``bias[..., i, j] = rel_h[..., i, j // side] +
rel_w[..., i, j % side]`` over the ``L = side^2`` keys of a window or of
the grid.

On a CUDA tensor :func:`relpos_bias` launches the hand-written kernel of
``unetseg_tpu_torch/csrc/relpos_bias.cu`` (built with nvcc for sm_90a at
first use, bound with ctypes): the sum in float32, rounded to bf16 once,
written into rows :func:`row_stride` elements apart, a multiple of
``ALIGN``, so that the memory-efficient attention backend reads the bias as
it is, without a padded copy of its own.  It takes bf16 only: any other
dtype on the card raises, and nothing falls back.  A CPU tensor takes
:func:`relpos_bias_plain`, the same arithmetic in torch ops, and counts
nothing.

``LAUNCHES`` counts the kernel's launches; registered with
:func:`graphs.counts_launches`, so a captured forward's replays count too.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict

import torch

from unetseg_tpu_torch import graphs
from unetseg_tpu_torch._build import Library, check, cuda

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "relpos_bias.cu")
#: The bias's row stride is a multiple of this many elements: the
#: memory-efficient backend pads a bias whose strides are not (a copy of the
#: whole tensor) before it reads it.
ALIGN = 16
#: ``MAX_SIDE`` of the source: the largest window or grid side it takes.
MAX_SIDE = 64

LIBRARY = Library("librelpos_bias", cuda("-Xptxas", "-v"), [SOURCE],
                  functions={"utrelpos_bias_bf16": (
                      ctypes.c_int, [ctypes.c_void_p] * 3
                      + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])})

#: Kernel launches since the last ``graphs.reset_launches``.
LAUNCHES: Dict[str, int] = graphs.counts_launches({"relpos_bias": 0})


def row_stride(keys: int) -> int:
    """The bias's row stride for ``keys`` keys: rounded up to ``ALIGN``."""
    return -(-keys // ALIGN) * ALIGN


def relpos_bias_plain(rel_h: torch.Tensor, rel_w: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version: ``rel_h[..., :, None] + rel_w[..., None, :]`` in
    float32, flattened over the keys and rounded to the terms' dtype:
    (..., L, side) -> (..., L, side^2), contiguous."""
    bias = rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
    return bias.flatten(-2).to(rel_h.dtype)


def _check(rel_h: torch.Tensor, rel_w: torch.Tensor) -> int:
    if rel_h.dim() < 2 or rel_h.shape != rel_w.shape or \
            rel_h.shape[-2] != rel_h.shape[-1] ** 2 or \
            rel_h.dtype != rel_w.dtype or rel_h.device != rel_w.device:
        raise ValueError(
            f"relpos_bias: rel_h {tuple(rel_h.shape)} and rel_w "
            f"{tuple(rel_w.shape)} must be one (..., side^2, side) shape, "
            f"dtype and device")
    return rel_h.shape[-1]


def relpos_bias(rel_h: torch.Tensor, rel_w: torch.Tensor) -> torch.Tensor:
    """The bias of the decomposed terms ``rel_h`` and ``rel_w`` (..., L,
    side), ``L = side^2`` queries: (..., L, L) in their dtype.

    A CUDA tensor goes to the kernel, which needs both terms bf16 and
    contiguous and ``side`` at most ``MAX_SIDE``, and returns a view whose
    rows lie :func:`row_stride` elements apart (the columns beyond L are
    zeros); anything else raises.  A CPU tensor takes
    :func:`relpos_bias_plain`."""
    side = _check(rel_h, rel_w)
    if rel_h.device.type == "cpu":
        return relpos_bias_plain(rel_h, rel_w)
    if rel_h.device.type != "cuda":
        raise ValueError(f"relpos_bias: unsupported device {rel_h.device}")
    if rel_h.dtype != torch.bfloat16:
        raise TypeError(f"relpos_bias kernel takes bf16 only, got "
                        f"{rel_h.dtype}")
    if not (rel_h.is_contiguous() and rel_w.is_contiguous()):
        raise ValueError("relpos_bias kernel needs contiguous terms")
    if side > MAX_SIDE:
        raise ValueError(f"relpos_bias kernel: side {side} above "
                         f"{MAX_SIDE}")
    keys = side * side
    ld = row_stride(keys)
    rows = rel_h.numel() // side
    out = torch.empty((*rel_h.shape[:-1], ld), dtype=rel_h.dtype,
                      device=rel_h.device)
    with torch.cuda.device(rel_h.device):  # the launch goes to the terms' card
        err = LIBRARY.load().utrelpos_bias_bf16(
            rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(), rows, side,
            ld, torch.cuda.current_stream(rel_h.device).cuda_stream)
    check(err, "relpos_bias")
    LAUNCHES["relpos_bias"] += 1
    return out[..., :keys]
