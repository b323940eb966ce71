"""8-connected CCL and region-min propagation: the K3 kernel.

The port's counterpart of ``unetseg_tpu/ops/cc_pallas.py`` (the Pallas
kernel ``_propagate_min`` with its entries ``cc_label_pallas`` and
``propagate_min_pallas``).  On a CUDA tensor :func:`cc_label` and
:func:`propagate_min` launch the hand-written union-find kernel in
``unetseg_tpu_torch/csrc/cc_label.cu`` (built with nvcc for sm_90a at first
use, bound with ctypes) or raise; they never fall back.  On a CPU tensor
they run the plain versions, :func:`cc.cc_label` and
:func:`propagate_min_plain`, which the tests and ``chip_smoke.py`` hold the
kernel against bit for bit.

Union-find is exact, so unlike ``propagate_min_pallas`` there is no
``max_passes``: only a pass-capped JAX call can differ.  ``LAUNCHES`` counts
wrapper calls that launched the kernel (each runs three or four
``__global__`` passes).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict

import torch

from unetseg_tpu_torch._build import NVCC_FLAGS, build_shared, nvcc
from unetseg_tpu_torch.ops import cc

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "cc_label.cu")

#: Kernel launches per entry since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"cc_label": 0, "propagate_min": 0}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared(
                "libcc_label", [nvcc(), *NVCC_FLAGS], [SOURCE]))
            lib.utcc_label.restype = ctypes.c_int
            lib.utcc_label.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            lib.utcc_propagate_min.restype = ctypes.c_int
            lib.utcc_propagate_min.argtypes = (
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            _lib = lib
        return _lib


def propagate_min_plain(init: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Plain version of :func:`propagate_min`: label the non-sentinel cells,
    scatter-min each seed into its root's slot, gather it back."""
    region = init != sentinel
    lbl = cc.cc_label(region).long()
    size = init.shape[-2] * init.shape[-1]
    flat_lbl = lbl.reshape(-1, size)
    seeds = init.reshape(-1, size)
    roots = torch.cat([seeds, torch.full_like(seeds[:, :1], sentinel)], 1)
    roots.scatter_reduce_(1, flat_lbl, seeds, "amin")
    return torch.where(region, roots.gather(1, flat_lbl).reshape(init.shape),
                       init)


def _batch(x: torch.Tensor, what: str, dtype: torch.dtype) -> torch.Tensor:
    """Validate a (H, W) or (B, H, W) input; returns it as (B, H, W)."""
    if x.dim() not in (2, 3) or x.dtype != dtype:
        raise ValueError(f"{what} takes (H, W) or (B, H, W) {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.numel() >= 2 ** 31:  # the kernel indexes pixels in int
        raise ValueError(f"{what}: more than 2**31 pixels")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x[None] if x.dim() == 2 else x


def _launch(fn, x: torch.Tensor, *args) -> None:
    b, h, w = x.shape
    with torch.cuda.device(x.device):  # the launch goes to x's card
        err = fn(*args, b, h, w, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def cc_label(fg: torch.Tensor) -> torch.Tensor:
    """(H, W) or (B, H, W) bool -> int32 labels: each foreground pixel gets
    the minimum flat index within its image of its 8-connected component,
    background the sentinel ``H*W`` (``cc_label_pallas``'s contract)."""
    x = _batch(fg, "cc_label", torch.bool)
    if x.device.type == "cpu":
        return cc.cc_label(fg)
    x = x.contiguous()
    lbl = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    _launch(load().utcc_label, x, x.data_ptr(), lbl.data_ptr())
    LAUNCHES["cc_label"] += 1
    return lbl.reshape(fg.shape)


def propagate_min(init: torch.Tensor, sentinel: int) -> torch.Tensor:
    """(H, W) or (B, H, W) int32 seeds -> for each 8-connected region of
    non-sentinel cells, the minimum seed over the region; sentinel cells stay
    (``propagate_min_pallas``'s contract, without ``max_passes``).  Seeds are
    taken below the sentinel, as in every JAX caller."""
    x = _batch(init, "propagate_min", torch.int32)
    if x.device.type == "cpu":
        return propagate_min_plain(init, sentinel)
    x = x.contiguous()
    lbl = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    out = torch.empty_like(lbl)
    _launch(load().utcc_propagate_min, x, x.data_ptr(), int(sentinel),
            lbl.data_ptr(), out.data_ptr())
    LAUNCHES["propagate_min"] += 1
    return out.reshape(init.shape)
