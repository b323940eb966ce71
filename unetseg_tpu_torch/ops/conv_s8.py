"""The w8a8 3x3 conv: int8 NHWC x int8 weights -> int32 -> f32 dequantize +
bias (+ ReLU).

K7 of the port, a kernel with no Pallas counterpart: the JAX package runs
this conv in ``lax.conv_general_dilated(..., preferred_element_type=int32)``
(``unetseg_tpu/quantize.py::_conv_w8a8``), and PyTorch has no int8
convolution on CUDA.  On a CUDA tensor :func:`conv3x3_s8` launches the
hand-written kernel in ``unetseg_tpu_torch/csrc/conv3x3_s8.cu`` (built with
nvcc for sm_90a at first use and bound with ctypes) or raises; it never
falls back.  On a CPU tensor it runs :func:`conv3x3_s8_plain`, the exact
plain version the tests and ``chip_smoke.py`` hold the kernel against.

The weights are K-major, ``(3, 3, D, C)``: the JAX tree's HWIO ``(3, 3, C,
D)`` with the last two axes swapped, made once when the quantized model is
built (``checkpoint.params_from_jax``).  ``scale`` is ``act_scale * w_scale`` (one f32
product per channel, as JAX computes it), so the output is, per channel d,
``float(acc) * scale[d] + bias[d]``, each step rounded once in that order.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch
import torch.nn.functional as F

from unetseg_tpu_torch._build import NVCC_FLAGS, build_shared, nvcc, read_log
from unetseg_tpu_torch.ops.conv import parse_ptxas

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "conv3x3_s8.cu")

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES = {"conv3x3_s8": 0}

_lock = threading.Lock()
_lib = None
_lib_path = None


def reset_launches() -> None:
    LAUNCHES["conv3x3_s8"] = 0


def load() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises if it cannot be."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            path = build_shared("libconv3x3_s8",
                                [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v"],
                                [SOURCE])
            lib = ctypes.CDLL(path)
            lib.utconv3x3_s8.restype = ctypes.c_int
            lib.utconv3x3_s8.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            _lib, _lib_path = lib, path
        return _lib


def resources() -> list:
    """What ``nvcc -Xptxas -v`` reported for the kernel when the library was
    built: a list of dicts with ``registers``, ``spill_bytes`` and
    ``smem_static``."""
    load()
    return [{"kernel": name, **info}
            for name, info in parse_ptxas(read_log(_lib_path)).items()
            if "conv3x3_s8_kernel" in name]


def quant_act(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """f32 activations -> int8, as JAX's ``_quant_act``:
    ``clip(round(x / s), -127, 127)``, rounding half to even.  A division,
    not a product with the reciprocal: one ulp at a .5 boundary changes an
    int8 value."""
    return torch.clamp(torch.round(x / act_scale), -127, 127).to(torch.int8)


def dequant(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            relu: bool) -> torch.Tensor:
    """int32 sums -> f32: ``float(acc) * scale + bias`` (+ ReLU), the order
    and roundings of JAX's ``_conv_w8a8`` and of K7's epilogue."""
    y = acc.float() * scale + bias
    return torch.relu(y) if relu else y


def conv3x3_s8_acc_plain(x_q: torch.Tensor, w_k: torch.Tensor
                         ) -> torch.Tensor:
    """The exact int32 sums of the SAME 3x3 conv of int8 ``x_q`` (B,H,W,C)
    with K-major int8 ``w_k`` (3,3,D,C).

    A float64 conv: every product and partial sum is an integer below 2^53,
    so the CPU's direct conv is exact, and the rounding to the nearest
    integer absorbs the error of any algorithm cuDNN may pick on the card.
    """
    y = F.conv2d(x_q.permute(0, 3, 1, 2).double(),
                 w_k.permute(2, 3, 0, 1).double(), padding=1)
    return torch.round(y).permute(0, 2, 3, 1).contiguous().to(torch.int32)


def conv3x3_s8_plain(x_q: torch.Tensor, w_k: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """Plain version of :func:`conv3x3_s8`: the exact sums, then
    :func:`dequant`.  Same arguments."""
    return dequant(conv3x3_s8_acc_plain(x_q, w_k), scale, bias, relu)


def _check(x_q, w_k, scale, bias) -> None:
    if x_q.dim() != 4 or w_k.dim() != 4 or \
            tuple(w_k.shape[:2]) != (3, 3) or w_k.shape[3] != x_q.shape[3] \
            or tuple(scale.shape) != (w_k.shape[2],) \
            or tuple(bias.shape) != (w_k.shape[2],):
        raise ValueError(f"conv3x3_s8: x {tuple(x_q.shape)} (NHWC), w "
                         f"{tuple(w_k.shape)} (3, 3, D, C), scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)}")
    if x_q.dtype != torch.int8 or w_k.dtype != torch.int8 or \
            scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"conv3x3_s8 takes int8 x and w, f32 scale and bias; "
                        f"got {x_q.dtype}, {w_k.dtype}, {scale.dtype}, "
                        f"{bias.dtype}")
    if not (x_q.device == w_k.device == scale.device == bias.device):
        raise ValueError("conv3x3_s8: x, w, scale and bias must be on one "
                         "device")


def conv3x3_s8(x_q: torch.Tensor, w_k: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """3x3 stride-1 SAME conv of int8 ``x_q`` (B,H,W,C) with K-major int8
    ``w_k`` (3,3,D,C), int32 sums, then ``float(acc) * scale + bias``
    (+ ReLU) -> f32 (B,H,W,D).

    On CUDA, C and D that are not multiples of 16 are zero-padded for the
    kernel (exact: the added channels meet zero weights) and the output is
    sliced back to D.  x and w must be contiguous and 16-byte aligned."""
    _check(x_q, w_k, scale, bias)
    if x_q.device.type == "cpu":
        return conv3x3_s8_plain(x_q, w_k, scale, bias, relu)
    if x_q.device.type != "cuda":
        raise ValueError(f"conv3x3_s8: unsupported device {x_q.device}")
    d_out = w_k.shape[2]
    extra_c, extra_d = -x_q.shape[3] % 16, -d_out % 16
    if extra_c:
        x_q = F.pad(x_q, (0, extra_c))
        w_k = F.pad(w_k, (0, extra_c))
    if extra_d:
        w_k = F.pad(w_k, (0, 0, 0, extra_d))
        scale, bias = F.pad(scale, (0, extra_d)), F.pad(bias, (0, extra_d))
    B, H, W, C = x_q.shape
    D = w_k.shape[2]
    if not (x_q.is_contiguous() and w_k.is_contiguous()
            and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("conv3x3_s8 kernel needs contiguous operands")
    if x_q.data_ptr() % 16 or w_k.data_ptr() % 16:
        raise ValueError("conv3x3_s8 kernel needs 16-byte aligned x and w")
    lib = load()
    out = torch.empty((B, H, W, D), dtype=torch.float32, device=x_q.device)
    with torch.cuda.device(x_q.device):  # the launch goes to x's card
        err = lib.utconv3x3_s8(
            x_q.data_ptr(), w_k.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, W, C, D, int(relu),
            torch.cuda.current_stream(x_q.device).cuda_stream)
    if err != 0:
        why = "plan refused" if err == -1 else f"CUDA error {err}"
        raise RuntimeError(f"conv3x3_s8 kernel launch failed: {why}")
    LAUNCHES["conv3x3_s8"] += 1
    return out if D == d_out else out[..., :d_out].contiguous()
