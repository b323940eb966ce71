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
``_conv3x3_small_c``.  The Pallas kernels take any float dtype and sum in
float32, and so does this wrapper: bf16 goes to the kernel of
``csrc/conv3x3.cu`` (K1/K2), float32 to the float32 kernel of
``csrc/conv3x3_f32.cu`` (K8, counted as ``conv3x3_bias_act_f32``); any
other dtype raises.  The bf16 kernel reads channel chunks of 16, 32 or 64, so
an input whose C is not a multiple of 16 (the flagship's C = 1 first conv, a
stem-2 model's C = 4) is zero-padded to one first
(:func:`pad_input_channels`), which is exact: the zero channels meet zero
weight rows.

The kernel's tiling is decided here, in :func:`tile_plan`, and passed to it,
so the CPU tests cover the plan: tiles of 128 output pixels (``rt`` rows x
``wt`` columns of one image) by ``bn`` channels, and K slices of ``bkc``
channels of one tap; with ``fold``, one input box of ``wt + 2`` columns
serves the three dx taps of a row of taps.  K8's tiling is
:func:`tile_plan_f32`, the same image-row tiles with float32 widths.  K8
computes split-TF32 (3xTF32) products on the tensor cores: the weights go
to it K-major, ``(3, 3, D, C)``, split into a TF32-rounded big half and the
rounded rest by its weight stage, one elementwise launch per call
(:func:`split_weights_f32`; plain version :func:`split_tf32` of
:func:`kmajor`); the kernel splits its input boxes itself.

Training runs the same kernels under autograd (:func:`conv3x3_bias_act_train`,
:class:`Conv3x3Function`): the forward is :func:`conv3x3_bias_act`; the data
gradient is a 3x3 SAME conv of the ReLU-masked output gradient with the
weights rotated by 180 degrees and transposed, through the same kernel
(``DGRAD_LAUNCHES`` counts those launches); the weight and bias gradients are
plain PyTorch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function_unary

from unetseg_tpu_torch import graphs
from unetseg_tpu_torch._build import Library, check, cuda

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCE = os.path.join(CSRC, "conv3x3.cu")
#: The float32 kernel (K8).
SOURCE_F32 = os.path.join(CSRC, "conv3x3_f32.cu")
#: The Hopper helpers the kernel sources include (hashed into the build).
HEADER = os.path.join(CSRC, "hopper.cuh")

#: The conv entry points' arguments: x, w, b, out, B, H, W, C, D, relu, the
#: tile plan's wt, rt, bn, bkc, fold, and the stream.
_CONV_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
#: K1/K2's library.
LIBRARY = Library("libconv3x3", cuda("-Xptxas", "-v"), [SOURCE],
                  deps=[HEADER], functions={
                      "utconv3x3_bf16": (ctypes.c_int, _CONV_ARGS),
                      "utconv3x3_smem_bytes": (ctypes.c_int,
                                               [ctypes.c_int] * 3)})
#: K8's library: the conv and its weight stage.
LIBRARY_F32 = Library("libconv3x3_f32", cuda("-Xptxas", "-v"), [SOURCE_F32],
                      deps=[HEADER], functions={
                          "utconv3x3_f32": (ctypes.c_int, _CONV_ARGS),
                          "utconv3x3_f32_split": (
                              ctypes.c_int,
                              [ctypes.c_void_p] + [ctypes.c_longlong] * 4
                              + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2),
                          "utconv3x3_f32_smem_bytes": (ctypes.c_int,
                                                       [ctypes.c_int] * 3)})
load = LIBRARY.load

#: Kernel launches per variant since the last ``graphs.reset_launches``.
LAUNCHES: Dict[str, int] = graphs.counts_launches(
    {"conv3x3_bias_act": 0, "conv3x3_bias_act_small_c": 0,
     "conv3x3_bias_act_f32": 0})
#: Of those, the launches the data gradient made (:class:`Conv3x3Function`).
DGRAD_LAUNCHES: Dict[str, int] = graphs.counts_launches(
    dict.fromkeys(LAUNCHES, 0))

#: Output pixels per tile: the M of two 64-row wgmma warpgroups.
TILE_PIXELS = 128


class TilePlan(NamedTuple):
    """How the kernel cuts one conv: see :func:`tile_plan`."""
    wt: int       # tile columns: min(128, next power of two >= W)
    rt: int       # tile rows: 128 // wt
    bn: int       # output channels per tile: 64, 128 or 256
    bkc: int      # channels per K slice (one TMA box): 64, 32 or 16
    swizzle: int  # swizzle of the A box, bytes: bkc x element bytes
    fold: bool    # one (wt + 2)-column A box per (dy, chunk) for all 3 dx
    tiles_w: int
    tiles_h: int
    tiles_n: int
    grid: int     # blocks: B * tiles_h * tiles_w * tiles_n


def tile_plan(B: int, H: int, W: int, C: int, D: int) -> TilePlan:
    """The kernel's tiling of a (B,H,W,C) x (3,3,C,D) conv.

    A tile is 128 pixels of one image, ``rt`` rows by ``wt`` columns, so a
    ragged H or W leaves a partial tile that the kernel masks; ``bkc`` is the
    largest of 64, 32, 16 that divides C, one 128-, 64- or 32-byte swizzle
    row of the A box, so no K slice is ever partial; ``bn`` is 64 for
    D <= 64, 256 for D >= 256 with 64-channel boxes (fewer bytes from L2
    per product; one block per SM), else 128.  ``fold`` (wt >= 64, so each
    64-pixel warpgroup half lies in one image row, and bn <= 128) loads one
    box of wt + 2 columns per (dy, chunk) and reads the three dx taps as
    views one pixel apart: a third of the input boxes.  C and D must be
    multiples of 16."""
    _check_plan(B, H, W, C, D)
    bkc = next(k for k in (64, 32, 16) if C % k == 0)
    bn = 64 if D <= 64 else 256 if D >= 256 and bkc == 64 else 128
    return _image_row_plan(B, H, W, D, bn, bkc, 2)


def _check_plan(B: int, H: int, W: int, C: int, D: int) -> None:
    if C % 16 or D % 16 or min(B, H, W, C, D) < 1:
        raise ValueError(f"conv3x3 tile plan: needs C and D multiples of 16, "
                         f"got B={B} H={H} W={W} C={C} D={D}")


def _image_row_plan(B: int, H: int, W: int, D: int, bn: int, bkc: int,
                    elem_bytes: int) -> TilePlan:
    """The tiles of 128 pixels, ``rt`` image rows by ``wt`` columns, that K1
    and K8 share, for channel tiles of ``bn`` and K slices of ``bkc``."""
    wt = min(TILE_PIXELS, 1 << (W - 1).bit_length())
    rt = TILE_PIXELS // wt
    tiles_w, tiles_h, tiles_n = -(-W // wt), -(-H // rt), -(-D // bn)
    return TilePlan(wt, rt, bn, bkc, elem_bytes * bkc, wt >= 64 and bn <= 128,
                    tiles_w, tiles_h, tiles_n,
                    B * tiles_h * tiles_w * tiles_n)


#: K8's (bkc, bn, fold) instantiations in ``csrc/conv3x3_f32.cu``: every
#: plan :func:`tile_plan_f32` makes.
F32_INSTANTIATIONS = tuple((bkc, bn, fold) for bkc in (16, 32)
                           for bn in (64, 128) for fold in (False, True))


def tile_plan_f32(B: int, H: int, W: int, C: int, D: int) -> TilePlan:
    """K8's tiling of a (B,H,W,C) x (3,3,C,D) float32 conv: :func:`tile_plan`'s
    image-row tiles of 128 pixels with float32 widths.  ``bkc`` is 32 (one
    128-byte swizzle row of floats) when it divides C, else 16 (64-byte
    rows); ``bn`` is 64 for D <= 64, else 128 (the kernel keeps a partial
    sum beside the accumulator, so 256 does not fit its registers); ``fold``
    whenever ``wt >= 64``.  C and D must be multiples of 16."""
    _check_plan(B, H, W, C, D)
    return _image_row_plan(B, H, W, D, 64 if D <= 64 else 128,
                           32 if C % 32 == 0 else 16, 4)


def split_tf32(t: torch.Tensor) -> torch.Tensor:
    """``(2, *t.shape)``, contiguous: ``big``, float32 ``t`` rounded to TF32
    (10 mantissa bits) to nearest with ties away from zero on its bits (the
    13 low bits become zero, as K8's ``round_tf32`` does), and ``small``,
    ``t - big`` (exact in float32) rounded likewise; so ``big + small`` is
    ``t`` to about 22 significant bits and both halves are exact TF32
    operands.  The plain version of K8's weight stage
    (:func:`split_weights_f32`)."""
    if t.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {t.dtype}")
    out = torch.empty((2, *t.shape), dtype=t.dtype, device=t.device)
    big, small = out[0], out[1]
    torch.add(t.view(torch.int32), 0x1000, out=big.view(torch.int32))
    big.view(torch.int32).bitwise_and_(-0x2000)
    torch.sub(t, big, out=small)
    small.view(torch.int32).add_(0x1000).bitwise_and_(-0x2000)
    return out


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``(3, 3, C, D)`` weights in K8's K-major form ``(3, 3, D, C)``
    (a view; :func:`split_tf32` lays it out).  For the data gradient's
    weights, ``w`` rotated and transposed, that is ``w`` rotated alone."""
    return w.permute(0, 1, 3, 2)


def split_weights_f32(w: torch.Tensor, c: int, d: int) -> torch.Tensor:
    """K8's weight stage: HWIO float32 ``w`` (3, 3, C', D'), any strides,
    zero-padded to (3, 3, c, d), in K8's split K-major form (2, 3, 3, d, c)
    (:func:`split_tf32` of :func:`kmajor`).  On a CUDA tensor one launch of
    ``split_weights_kernel`` (part of each K8 call, which counts it as one
    launch with the conv's); on the CPU the plain version."""
    if w.dtype != torch.float32 or w.dim() != 4 or \
            tuple(w.shape[:2]) != (3, 3) or w.shape[2] > c or w.shape[3] > d:
        raise ValueError(f"split_weights_f32: float32 (3, 3, <= {c}, <= {d})"
                         f" weights wanted, got {w.dtype} {tuple(w.shape)}")
    if w.device.type == "cpu":
        return split_tf32(kmajor(F.pad(w, (0, d - w.shape[3],
                                           0, c - w.shape[2]))))
    with torch.cuda.device(w.device):
        return _split_weights(w, c, d, torch.cuda.current_stream(
            w.device).cuda_stream)


def _split_weights(w: torch.Tensor, c: int, d: int, stream) -> torch.Tensor:
    """K8's weight stage launched on ``stream`` from CUDA ``w``: its split
    K-major weights (2, 3, 3, d, c)."""
    out = torch.empty((2, 3, 3, d, c), dtype=w.dtype, device=w.device)
    check(LIBRARY_F32.load().utconv3x3_f32_split(
        w.data_ptr(), *w.stride(), w.shape[2], w.shape[3], c, d,
        out.data_ptr(), stream), "conv3x3")
    return out


def _padded_weights(w: torch.Tensor, c: int, d: int, stream
                    ) -> torch.Tensor:
    """K1/K2's weights: HWIO ``w`` zero-padded to (3, 3, c, d) (exact, as
    :func:`pad_input_channels` and :func:`pad_output_channels` are),
    contiguous."""
    if tuple(w.shape[2:]) != (c, d):
        w = F.pad(w, (0, d - w.shape[3], 0, c - w.shape[2]))
    return w.contiguous()


def resources() -> list:
    """Per kernel instantiation, what ``nvcc -Xptxas -v`` reported when the
    library was built (registers, spills, static shared memory) and its
    dynamic shared memory: a list of dicts with keys ``bkc``, ``bn``,
    ``fold``, ``registers``, ``spill_bytes``, ``smem_static``,
    ``smem_dynamic``."""
    return _resources(LIBRARY, "conv3x3_wgmma_kernel", "utconv3x3_smem_bytes")


def resources_f32() -> list:
    """K8's instantiations as :func:`resources` lists K1's: registers,
    spills, static and dynamic shared memory per ``(bkc, bn, fold)``."""
    return _resources(LIBRARY_F32, "conv3x3_tf32x3_kernel",
                      "utconv3x3_f32_smem_bytes")


def _resources(library: Library, template: str, smem: str) -> list:
    smem_bytes = getattr(library.load(), smem)
    return sorted(({"bkc": bkc, "bn": bn, "fold": fold, **info,
                    "smem_dynamic": smem_bytes(bkc, bn, fold)}
                   for (bkc, bn, fold), info in
                   library.instantiations(template)),
                  key=lambda r: (r["fold"], r["bkc"], r["bn"]))


def conv3x3_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           relu: bool = True) -> torch.Tensor:
    """Plain version: float32 conv + bias, ReLU, one cast to ``x.dtype``
    (float64 end to end for float64 inputs, which the tests use to check
    the training backward's formula; no kernel takes them).

    Same arguments as :func:`conv3x3_bias_act`.  Set
    ``torch.backends.cudnn.allow_tf32 = False`` before calling it on the
    card, or cuDNN computes the float32 conv in TF32.
    """
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = F.conv2d(x.to(acc).permute(0, 3, 1, 2), w.to(acc).permute(3, 2, 0, 1),
                 b.to(acc), padding=1)
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


def pad_output_channels(w: torch.Tensor, b: torch.Tensor, multiple: int = 16
                        ) -> tuple:
    """(w, b) with w's output columns and b zero-padded up to the next
    multiple of ``multiple``; unchanged when D already is one.  The first D
    output channels of the padded conv are the unpadded conv's, so the
    caller slices them back: exact, as the input-channel padding is."""
    extra = -w.shape[3] % multiple
    if not extra:
        return w, b
    return F.pad(w, (0, extra)), F.pad(b, (0, extra))


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]) \
            or tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} (NHWC), w "
                         f"{tuple(w.shape)} (HWIO), b {tuple(b.shape)}")
    if not (x.device == w.device == b.device):
        raise ValueError("conv3x3: x, w and b must be on one device")


class _Kernel(NamedTuple):
    """What a conv dtype runs on the card."""
    library: Library
    entry: str           # the conv's entry point, arguments _CONV_ARGS
    plan: Callable       # (B, H, W, C, D) -> TilePlan
    weights: Callable    # (w, C, D, stream) -> the weights the kernel reads


_KERNELS = {torch.bfloat16: _Kernel(LIBRARY, "utconv3x3_bf16", tile_plan,
                                    _padded_weights),
            torch.float32: _Kernel(LIBRARY_F32, "utconv3x3_f32",
                                   tile_plan_f32, _split_weights)}


def conv3x3_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """3x3 stride-1 SAME conv + bias (+ ReLU): (B,H,W,C) x (3,3,C,D) + (D,)
    -> (B,H,W,D) in ``x.dtype``, summed in float32.

    CUDA tensors must be all bf16 (K1/K2) or all float32 (K8), x and b
    contiguous and 16-byte aligned (w may have any strides: the kernels
    read a laid-out copy); anything else raises.  C and D may be any size:
    the kernel gets them zero-padded to multiples of 16 and the output is
    sliced back to D; K1/K2 take the weights padded
    (:func:`pad_input_channels`, :func:`pad_output_channels`), K8 from its
    weight stage (:func:`split_weights_f32`).  B, H and W may be any size;
    the kernels run :func:`tile_plan`'s or :func:`tile_plan_f32`'s tiling.
    """
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_bias_act_plain(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    kernel = _KERNELS.get(x.dtype) if x.dtype == w.dtype == b.dtype else None
    if kernel is None:
        raise TypeError(f"conv3x3 kernels take bf16 or float32, all alike; "
                        f"got {x.dtype}, {w.dtype}, {b.dtype}")
    d_out = w.shape[3]
    extra_c, extra_d = -x.shape[3] % 16, -d_out % 16
    if extra_c:
        x = F.pad(x, (0, extra_c))
    if extra_d:
        b = F.pad(b, (0, extra_d))
    B, H, W, C = x.shape
    D = d_out + extra_d
    if not (x.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3x3 kernel needs contiguous x and b")
    plan = kernel.plan(B, H, W, C, D)
    _check_grid(plan, B, H, W)
    out = torch.empty((B, H, W, D), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):  # the launches go to x's card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        wk = kernel.weights(w, C, D, stream)
        if x.data_ptr() % 16 or wk.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError("conv3x3 kernel needs 16-byte aligned x, w and "
                             "b")
        check(getattr(kernel.library.load(), kernel.entry)(
            x.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(),
            B, H, W, C, D, int(relu), plan.wt, plan.rt, plan.bn,
            plan.bkc, int(plan.fold), stream), "conv3x3")
    LAUNCHES[variant(C, x.dtype)] += 1
    return out if D == d_out else out[..., :d_out].contiguous()


def _check_grid(plan: TilePlan, B: int, H: int, W: int) -> None:
    if plan.grid >= 2 ** 31 or max(B, H, W) >= 2 ** 31:
        raise ValueError(f"conv3x3 kernel: {plan.grid} tiles, more than the "
                         f"grid holds")


def variant(c: int, dtype: torch.dtype) -> str:
    """The ``LAUNCHES`` name of the kernel that runs a conv of ``c`` (padded)
    input channels in ``dtype``."""
    if dtype == torch.float32:
        return "conv3x3_bias_act_f32"
    return "conv3x3_bias_act_small_c" if c < 128 else "conv3x3_bias_act"


# ---------------------------------------------------------------------------
# training: the conv under autograd
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _cudnn_full_f32():
    """cuDNN's float32 convs in full float32 (not TF32) inside the block."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The data gradient of a 3x3 SAME conv: (B,H,W,D) output gradient x
    (3,3,C,D) weights -> (B,H,W,C), in ``g.dtype``.  It is the 3x3 SAME
    conv of ``g`` with the weights rotated by 180 degrees and transposed to
    (3,3,D,C), run through :func:`conv3x3_bias_act` (the kernels on CUDA)
    with a zero bias and no ReLU; its launches are also counted in
    ``DGRAD_LAUNCHES``.  The transpose stays a view: K8's weight stage
    reads it through its strides (its K-major form is ``w`` rotated)."""
    zero = torch.zeros((w.shape[2],), dtype=g.dtype, device=g.device)
    before = dict(LAUNCHES)
    dx = conv3x3_bias_act(g.contiguous(), w.flip((0, 1)).transpose(2, 3),
                          zero, relu=False)
    for k, n in LAUNCHES.items():
        DGRAD_LAUNCHES[k] += n - before[k]
    return dx


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of a 3x3 SAME conv: (B,H,W,C) input and
    (B,H,W,D) output gradient -> (3,3,C,D) HWIO, in their dtype, by
    ``torch.nn.grad.conv2d_weight`` (cuDNN on the card, float32 without
    TF32): plain PyTorch, as JAX computes it in XLA."""
    shape = (g.shape[3], x.shape[3], 3, 3)
    with _cudnn_full_f32():
        dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), shape,
                                         g.permute(0, 3, 1, 2), padding=1)
    return dw.permute(2, 3, 1, 0).contiguous()


class Conv3x3Function(torch.autograd.Function):
    """:func:`conv3x3_bias_act` with its gradients.

    Backward, for the output gradient ``gy``: ``g = gy`` where the output
    is positive (the ReLU's mask; all of ``gy`` without ReLU), then
    ``dx = conv3x3_dgrad(g, w)`` (only when x needs a gradient: a model's
    first conv reads data), ``dw = conv3x3_wgrad(x, g)`` and ``db`` the sum
    of ``g`` over (B, H, W), summed in float32.  Every gradient is in its
    input's dtype, so a bf16 dx rounds once, after the kernel's float32
    sum, as JAX's bf16 cotangents do."""

    @staticmethod
    def forward(ctx, x, w, b, relu):
        y = conv3x3_bias_act(x, w, b, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, y = ctx.saved_tensors
        g = torch.where(y > 0, gy, 0) if ctx.relu else gy
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_dgrad(g, w)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, g)
        if ctx.needs_input_grad[2]:
            acc = torch.float64 if g.dtype == torch.float64 else torch.float32
            db = g.to(acc).sum(dim=(0, 1, 2)).to(g.dtype)
        return dx, dw, db, None


def conv3x3_bias_act_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           relu: bool = True) -> torch.Tensor:
    """:func:`conv3x3_bias_act` under autograd (:class:`Conv3x3Function`).
    Row bands (``parallel.spatial.Bands``) take it with a halo exchange."""
    if has_torch_function_unary(x):
        return handle_torch_function(conv3x3_bias_act_train, (x,), x, w, b,
                                     relu=relu)
    return Conv3x3Function.apply(x, w, b, relu)
