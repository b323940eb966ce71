"""The w8a8 3x3 conv: int8 NHWC x int8 weights -> int32 -> f32 dequantize +
bias (+ ReLU), written as f32 or quantized again to int8 for the next site.

K7 of the port, a kernel with no Pallas counterpart: the JAX package runs
this conv in ``lax.conv_general_dilated(..., preferred_element_type=int32)``
(``unetseg_tpu/quantize.py::_conv_w8a8``), and PyTorch has no int8
convolution on CUDA.  On a CUDA tensor :func:`conv3x3_s8` (f32 out) and
:func:`conv3x3_s8_q` (int8 out, one tensor per scale) launch the
hand-written TMA + ``wgmma`` kernel in
``unetseg_tpu_torch/csrc/conv3x3_s8.cu`` (built with nvcc for sm_90a at
first use and bound with ctypes) or raise; they never fall back.  On a CPU
tensor they run :func:`conv3x3_s8_plain` and :func:`conv3x3_s8_q_plain`,
the exact plain versions the tests and ``chip_smoke.py`` hold the kernel
against.

The weights are K-major, ``(3, 3, D, C)``: the JAX tree's HWIO ``(3, 3, C,
D)`` with the last two axes swapped, made once when the quantized model is
built (``checkpoint.params_from_jax``); the kernel reads them as they are.
``scale`` is ``act_scale * w_scale`` (one f32 product per channel, as JAX
computes it), so the f32 output is, per channel d, ``float(acc) * scale[d] +
bias[d]``, each step rounded once in that order; the int8 output is
:func:`quant_act` of it with each of ``out_scales``.

The kernel's tiling is decided here (:func:`tile_plan_s8`): K1's image-row
tiles of 128 pixels (``ops/conv._image_row_plan``) with int8 widths.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function_unary

from unetseg_tpu_torch import graphs
from unetseg_tpu_torch._build import Library, check, cuda
from unetseg_tpu_torch.ops.conv import (HEADER, TilePlan, _check_grid,
                                        _check_plan, _image_row_plan)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "conv3x3_s8.cu")

LIBRARY = Library("libconv3x3_s8", cuda("-Xptxas", "-v"), [SOURCE],
                  deps=[HEADER], functions={
                      "utconv3x3_s8": (ctypes.c_int,
                                       [ctypes.c_void_p] * 8
                                       + [ctypes.c_int] * 12
                                       + [ctypes.c_void_p]),
                      "utconv3x3_s8_smem_bytes": (ctypes.c_int,
                                                  [ctypes.c_int] * 4)})

#: Kernel launches since the last ``graphs.reset_launches``, both
#: epilogues.
LAUNCHES = graphs.counts_launches({"conv3x3_s8": 0})

#: The (bkc, bn, fold) plans ``csrc/conv3x3_s8.cu`` instantiates, each in
#: both epilogues (f32 and int8 out): every plan :func:`tile_plan_s8` makes.
S8_INSTANTIATIONS = tuple(
    [(bkc, bn, fold) for fold in (False, True) for bn in (64, 128)
     for bkc in (32, 64, 128)] + [(128, 256, False)])


def tile_plan_s8(B: int, H: int, W: int, C: int, D: int) -> TilePlan:
    """K7's tiling of a (B,H,W,C) x (3,3,D,C) int8 conv: K1's image-row
    tiles of 128 pixels (``rt`` rows by ``wt`` columns of one image) with
    int8 widths.  ``bkc`` is the largest of 128, 64 and 32 int8 channels
    (one 128-, 64- or 32-byte swizzle row) that divides C; ``bn`` is 64
    for D <= 64, 256 for D >= 256 with 128-channel boxes (one block per
    SM), else 128; ``fold`` (one box of wt + 2 columns per (dy, chunk),
    read by the three dx taps) when ``wt >= 64`` and ``bn <= 128``.  C must
    be a multiple of 32 (one k32 slice of wgmma; the wrapper pads it) and D
    of 16 (the 16-byte stores)."""
    _check_plan(B, H, W, C, D)
    if C % 32:
        raise ValueError(f"K7 tile plan: needs C a multiple of 32, got {C}")
    bkc = next(k for k in (128, 64, 32) if C % k == 0)
    bn = 64 if D <= 64 else 256 if D >= 256 and bkc == 128 else 128
    return _image_row_plan(B, H, W, D, bn, bkc, 1)


def resources() -> list:
    """Per kernel instantiation, what ``nvcc -Xptxas -v`` reported when the
    library was built (registers, spills, static shared memory) and its
    dynamic shared memory: a list of dicts with keys ``bkc``, ``bn``,
    ``fold``, ``quant`` (the int8 epilogue), ``registers``,
    ``spill_bytes``, ``smem_static``, ``smem_dynamic``."""
    smem = LIBRARY.load().utconv3x3_s8_smem_bytes
    return sorted(({"bkc": bkc, "bn": bn, "fold": fold, "quant": quant,
                    **info, "smem_dynamic": smem(bkc, bn, fold, quant)}
                   for (bkc, bn, fold, quant), info in
                   LIBRARY.instantiations("conv3x3_s8_wgmma_kernel")),
                  key=lambda r: (r["quant"], r["fold"], r["bkc"], r["bn"]))


def quant_act(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """f32 activations -> int8, as JAX's ``_quant_act``:
    ``clip(round(x / s), -127, 127)``, rounding half to even.  A division,
    not a product with the reciprocal: one ulp at a .5 boundary changes an
    int8 value.  Elementwise: row bands (``parallel.spatial.Bands``) take
    it band by band."""
    if has_torch_function_unary(x):
        return handle_torch_function(quant_act, (x,), x, act_scale)
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


def conv3x3_s8_q_plain(x_q: torch.Tensor, w_k: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       out_scales: Sequence[torch.Tensor],
                       relu: bool = True) -> List[torch.Tensor]:
    """Plain version of :func:`conv3x3_s8_q`: :func:`quant_act` of
    :func:`conv3x3_s8_plain` with each of ``out_scales``."""
    y = conv3x3_s8_plain(x_q, w_k, scale, bias, relu)
    return [quant_act(y, s) for s in out_scales]


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


def _check_scales(x_q, out_scales) -> None:
    if not 1 <= len(out_scales) <= 2:
        raise ValueError(f"conv3x3_s8_q: one or two out_scales, got "
                         f"{len(out_scales)}")
    for s in out_scales:
        if s.dtype != torch.float32 or s.numel() != 1 or \
                s.device != x_q.device:
            raise ValueError(f"conv3x3_s8_q: each out scale a one-element "
                             f"f32 tensor on {x_q.device}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")


def _launch(x_q, w_k, scale, bias, out_scales, relu) -> List[torch.Tensor]:
    """K7 on CUDA tensors: f32 out when ``out_scales`` is empty, else one
    int8 tensor per scale.  C is zero-padded to a multiple of 32 and D to
    one of 16 for the kernel (exact: the added channels meet zero weights)
    and the outputs sliced back to D.  (A 32-channel box half past C = 16,
    zero-filled by TMA itself, took 0.67-0.68 ms for slim4's stem at batch
    128 on an H100 against 0.29 ms on the padded input plus 0.11 for the
    pad.)"""
    if x_q.device.type != "cuda":
        raise ValueError(f"conv3x3_s8: unsupported device {x_q.device}")
    d_out = w_k.shape[2]
    extra_c, extra_d = -x_q.shape[3] % 32, -d_out % 16
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
    if x_q.data_ptr() % 16 or w_k.data_ptr() % 16 or \
            scale.data_ptr() % 8 or bias.data_ptr() % 8:
        raise ValueError("conv3x3_s8 kernel needs 16-byte aligned x and w, "
                         "8-byte aligned scale and bias")
    plan = tile_plan_s8(B, H, W, C, D)
    _check_grid(plan, B, H, W)
    lib = LIBRARY.load()
    nq = len(out_scales)
    outs = [torch.empty((B, H, W, D), dtype=torch.int8 if nq else
                        torch.float32, device=x_q.device)
            for _ in range(max(nq, 1))]
    ptrs = [o.data_ptr() for o in outs] + [None] * (2 - len(outs))
    qs = [s.data_ptr() for s in out_scales] + [None] * (2 - nq)
    with torch.cuda.device(x_q.device):  # the launch goes to x's card
        err = lib.utconv3x3_s8(
            x_q.data_ptr(), w_k.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), *qs, *ptrs, B, H, W, C, D, int(relu), nq,
            plan.wt, plan.rt, plan.bn, plan.bkc, int(plan.fold),
            torch.cuda.current_stream(x_q.device).cuda_stream)
    check(err, "conv3x3_s8")
    LAUNCHES["conv3x3_s8"] += 1
    return [o if D == d_out else o[..., :d_out].contiguous() for o in outs]


def conv3x3_s8(x_q: torch.Tensor, w_k: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """3x3 stride-1 SAME conv of int8 ``x_q`` (B,H,W,C) with K-major int8
    ``w_k`` (3,3,D,C), int32 sums, then ``float(acc) * scale + bias``
    (+ ReLU) -> f32 (B,H,W,D).  x and w must be contiguous and 16-byte
    aligned on CUDA.  Row bands (``parallel.spatial.Bands``) take it with a
    halo exchange."""
    if has_torch_function_unary(x_q):
        return handle_torch_function(conv3x3_s8, (x_q,), x_q, w_k, scale,
                                     bias, relu=relu)
    _check(x_q, w_k, scale, bias)
    if x_q.device.type == "cpu":
        return conv3x3_s8_plain(x_q, w_k, scale, bias, relu)
    return _launch(x_q, w_k, scale, bias, [], relu)[0]


def conv3x3_s8_q(x_q: torch.Tensor, w_k: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, out_scales: Sequence[torch.Tensor],
                 relu: bool = True) -> List[torch.Tensor]:
    """:func:`conv3x3_s8` whose f32 result is quantized in the kernel's
    epilogue for the site(s) that consume it: one int8 (B,H,W,D) tensor per
    scale of ``out_scales`` (one or two one-element f32 tensors on x's
    device, e.g. the next sites' ``act_scale``), each
    ``quant_act(conv3x3_s8(...), s)`` bit for bit.  No host sync: the
    kernel reads the scales on the card.  Row bands
    (``parallel.spatial.Bands``) take it with a halo exchange, one
    :class:`~unetseg_tpu_torch.parallel.spatial.Bands` a scale."""
    if has_torch_function_unary(x_q):
        return handle_torch_function(conv3x3_s8_q, (x_q,), x_q, w_k, scale,
                                     bias, out_scales, relu=relu)
    _check(x_q, w_k, scale, bias)
    _check_scales(x_q, out_scales)
    if x_q.device.type == "cpu":
        return conv3x3_s8_q_plain(x_q, w_k, scale, bias, out_scales, relu)
    return _launch(x_q, w_k, scale, bias, list(out_scales), relu)
