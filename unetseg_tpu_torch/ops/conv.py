"""3x3 stride-1 SAME conv + bias (+ ReLU), NHWC x HWIO -> NHWC.

The port's counterpart of ``unetseg_tpu/ops/pallas_conv.py`` (the Pallas
kernels ``conv3x3_bias_act`` and ``_conv3x3_small_c``).  On a CUDA tensor
:func:`conv3x3_bias_act` launches the hand-written Hopper kernel in
``unetseg_tpu_torch/csrc/conv3x3.cu`` (built with nvcc for sm_90a at first
use and bound with ctypes) or raises; it never falls back.  On a CPU tensor
it runs :func:`conv3x3_bias_act_plain`, the plain PyTorch version the tests
and ``chip_smoke.py`` hold the kernel against.

``LAUNCHES`` counts kernel launches by variant, so a run can show that its
forward passes went through the kernel: the C >= 128 variant replaces the
Pallas ``conv3x3_bias_act`` and the C < 128 variant replaces
``_conv3x3_small_c``.  The kernel reads 16-channel chunks, so an input whose
C is not a multiple of 16 (the flagship's C = 1 first conv, a stem-2
model's C = 4) is zero-padded to one first (:func:`pad_input_channels`),
which is exact: the zero channels meet zero weight rows.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict

import torch
import torch.nn.functional as F

from unetseg_tpu_torch._build import NVCC_FLAGS, build_shared, nvcc

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "conv3x3.cu")

#: Kernel launches per variant since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"conv3x3_bias_act": 0,
                            "conv3x3_bias_act_small_c": 0}

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
                "libconv3x3", [nvcc(), *NVCC_FLAGS], [SOURCE]))
            lib.utconv3x3_bf16.restype = ctypes.c_int
            lib.utconv3x3_bf16.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            _lib = lib
        return _lib


def conv3x3_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           relu: bool = True) -> torch.Tensor:
    """Plain version: float32 conv + bias, ReLU, one cast to ``x.dtype``.

    Same arguments as :func:`conv3x3_bias_act`.  Set
    ``torch.backends.cudnn.allow_tf32 = False`` before calling it on the
    card, or cuDNN computes the float32 conv in TF32.
    """
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 b.float(), padding=1)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def pad_input_channels(x: torch.Tensor, w: torch.Tensor, multiple: int = 16
                       ) -> tuple:
    """(x, w) with x's channels and w's input rows zero-padded up to the
    next multiple of ``multiple``; unchanged when C already is one.  The
    conv of the padded pair equals the unpadded conv: each added channel
    meets a zero weight row."""
    c = x.shape[3]
    extra = -c % multiple
    if not extra:
        return x, w
    return F.pad(x, (0, extra)), F.pad(w, (0, 0, 0, extra))


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]) \
            or tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} (NHWC), w "
                         f"{tuple(w.shape)} (HWIO), b {tuple(b.shape)}")
    if not (x.device == w.device == b.device):
        raise ValueError("conv3x3: x, w and b must be on one device")


def conv3x3_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """3x3 stride-1 SAME conv + bias (+ ReLU): (B,H,W,C) x (3,3,C,D) + (D,)
    -> (B,H,W,D) in ``x.dtype``, summed in float32.

    CUDA tensors must be bf16, contiguous, 16-byte aligned, with D a
    multiple of 16; anything else raises.  C may be any size: it is
    zero-padded to a multiple of 16 first (:func:`pad_input_channels`).
    """
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_bias_act_plain(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if not (x.dtype == w.dtype == b.dtype == torch.bfloat16):
        raise TypeError(f"conv3x3 kernel takes bf16 only, got {x.dtype}, "
                        f"{w.dtype}, {b.dtype}")
    x, w = pad_input_channels(x, w)
    B, H, W, C = x.shape
    D = w.shape[3]
    if D % 16:
        raise ValueError(f"conv3x3 kernel needs D a multiple of 16, got "
                         f"D={D}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3x3 kernel needs contiguous x, w, b")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3 kernel needs 16-byte aligned x and w")
    if B * H * W >= 2 ** 31:  # the kernel's grid counts pixel tiles in int
        raise ValueError("conv3x3 kernel: more than 2**31 output pixels")
    lib = load()
    out = torch.empty((B, H, W, D), dtype=x.dtype, device=x.device)
    small_c = C < 128
    with torch.cuda.device(x.device):  # the launch goes to x's card
        err = lib.utconv3x3_bf16(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            B, H, W, C, D, int(relu), int(small_c),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    LAUNCHES["conv3x3_bias_act_small_c" if small_c
             else "conv3x3_bias_act"] += 1
    return out
