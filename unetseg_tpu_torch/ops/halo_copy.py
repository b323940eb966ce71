"""Halo-band copy ``x[:, o:o+H, :W2, :]``: the K4 and K5 kernels.

The port's counterpart of the two Pallas copy kernels of the JAX bandwidth
probe ``benchmarks/exp_bw.py``: ``copy_elem`` (row offset 1, a halo row
band through Element blocks) and ``copy_blocked`` (row offset 0, Blocked
tiles).  On a CUDA tensor :func:`halo_copy` launches the hand-written
kernel in ``unetseg_tpu_torch/csrc/halo_copy.cu`` (built with nvcc for
sm_90a at first use, bound with ctypes) or raises; it never falls back.  On
a CPU tensor it runs :func:`halo_copy_plain`, the slice made contiguous,
which the tests and ``chip_smoke.py`` hold the kernel against bit for bit.

``LAUNCHES`` counts kernel launches by the TPU kernel each row offset
stands for.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict

import torch

from unetseg_tpu_torch import graphs
from unetseg_tpu_torch._build import Library, check, cuda

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "halo_copy.cu")
#: Row offset -> the JAX kernel it ports.
NAMES = {1: "copy_elem", 0: "copy_blocked"}

LIBRARY = Library("libhalo_copy", cuda(), [SOURCE], functions={
    "uthalo_copy_bf16": (ctypes.c_int, [ctypes.c_void_p] * 2
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])})

#: Kernel launches per JAX kernel since the last ``graphs.reset_launches``.
LAUNCHES: Dict[str, int] = graphs.counts_launches(
    {name: 0 for name in NAMES.values()})


def halo_copy_plain(x: torch.Tensor, h: int, w2: int, row_offset: int
                    ) -> torch.Tensor:
    """Plain version: the slice, made contiguous."""
    return x[:, row_offset:row_offset + h, :w2, :].contiguous()


def halo_copy(x: torch.Tensor, h: int, w2: int, row_offset: int
              ) -> torch.Tensor:
    """(B, Hin, Win, K) -> ``x[:, row_offset:row_offset+h, :w2, :]``,
    contiguous.  ``row_offset`` 1 is K4 (``copy_elem``), 0 is K5
    (``copy_blocked``).

    CUDA tensors must be bf16, contiguous and 16-byte aligned, with K a
    multiple of 8; anything else raises.
    """
    if x.dim() != 4 or row_offset not in NAMES or h < 0 or w2 < 0 \
            or row_offset + h > x.shape[1] or w2 > x.shape[2]:
        raise ValueError(f"halo_copy: x {tuple(x.shape)}, h {h}, w2 {w2}, "
                         f"row_offset {row_offset} (0 or 1)")
    if x.device.type == "cpu":
        return halo_copy_plain(x, h, w2, row_offset)
    if x.device.type != "cuda":
        raise ValueError(f"halo_copy: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"halo_copy kernel takes bf16 only, got {x.dtype}")
    b, hin, win, k = x.shape
    if k % 8 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("halo_copy kernel needs a contiguous, 16-byte "
                         f"aligned x with K a multiple of 8, got K={k}")
    out = torch.empty((b, h, w2, k), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to x's card
        err = LIBRARY.load().uthalo_copy_bf16(
            x.data_ptr(), out.data_ptr(), b, h, w2, hin, win, k, row_offset,
            torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "halo_copy")
    LAUNCHES[NAMES[row_offset]] += 1
    return out
