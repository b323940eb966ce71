"""GroupNorm over NHWC activations, with an optional residual add and ReLU
fused into its output pass: the K9 kernel, TransUNet's R50 norms.

``F.group_norm``'s CUDA kernel reads NCHW only, and the plain NHWC form
(:func:`group_norm_plain`) costs two float32 reductions, an ``addcmul`` and
a ReLU, each a pass over the tensor, and after a bottleneck's last norm a
residual add and another ReLU.  On a CUDA tensor :func:`group_norm`
launches the hand-written kernels in
``unetseg_tpu_torch/csrc/groupnorm_nhwc.cu`` (built with nvcc for sm_90a
at first use, bound with ctypes): the statistics in one pass (float32,
Welford within a thread, Chan's merge across threads, chunks and
channels), then the output ``relu(x * scale + shift + residual)`` in
float32, rounded to bf16 once.  They take bf16 only: any other dtype on
the card raises, and nothing falls back (a float32 TransUNet cannot run
on the card in any case: its attention is FlashAttention's, which takes
no float32).  A CPU tensor takes :func:`group_norm_plain`, the former
composition of PyTorch ops, bit for bit.

The kernel's chunking is decided here (:func:`plan`) and passed to it.
:func:`oracle_float64` is the float64 GroupNorm that the card tests and
``chip_smoke.py`` hold both paths to, within ``ORACLE_TOL`` and
``ORACLE_STATS_TOL``.

``LAUNCHES`` counts the kernel's calls, one a norm (each a statistics, a
finalize and an output launch); registered with
:func:`graphs.counts_launches`, so a captured forward's replays count too.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, NamedTuple, Optional

import torch

from unetseg_tpu_torch import graphs
from unetseg_tpu_torch._build import Library, check, cuda

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "groupnorm_nhwc.cu")
#: ``THREADS`` and ``UNROLL`` of the source: a block's threads, and the
#: 16-byte loads a thread keeps in flight.
THREADS = 256
UNROLL = 4
#: Channels the kernel takes: one 8-channel column a thread of a block.
MAX_C = THREADS * 8
#: The statistics' chunk, at most 16 loads a thread (64 KB a block), halved
#: down to ``UNROLL`` while the grid has fewer than ``MIN_BLOCKS`` blocks
#: (4 a streaming multiprocessor of the H100).
MAX_ITERS = 16
MIN_BLOCKS = 4 * 132
#: Both paths against :func:`oracle_float64`, elementwise: |y - y64| <=
#: ORACLE_TOL * (|x s| + |shift| + |residual|), the terms' magnitudes.  The
#: kernel rounds once (2^-8 of |y| at most); the plain ops round the scale,
#: the shift, the product-sum and the residual sum each to bf16, up to
#: about 3 x 2^-8 of the terms.  The card read 0.00389 (kernel) and
#: 0.0068-0.0111 (plain ops) over every published shape; 2^-6 holds both.
ORACLE_TOL = 2.0 ** -6
#: The kernel alone: |y - y64| <= 2^-8 |y64| + ORACLE_STATS_TOL * (|x s| +
#: |bias| + |mean s| + |residual|): one rounding to bf16, plus the float32
#: statistics' and arithmetic's error, which scales with the operands the
#: shift is formed from (where bias ~ mean s, the shift cancels).  The card
#: read at most 1.2e-7 on the card tests' inputs over every published
#: shape (batches 32 and 1), and 1.8e-6 on a seeded forward's own
#: activations, whose means lie further from zero against their spread.
ORACLE_STATS_TOL = 1e-5

LIBRARY = Library("libgroupnorm_nhwc", cuda("-Xptxas", "-v"), [SOURCE],
                  functions={"utgroupnorm_nhwc_bf16": (
                      ctypes.c_int, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])})

#: Kernel calls since the last ``graphs.reset_launches`` (each one
#: statistics, finalize and apply launch).
LAUNCHES: Dict[str, int] = graphs.counts_launches({"groupnorm_nhwc": 0})


class Plan(NamedTuple):
    """How the kernels cut one norm: see :func:`plan`."""
    rows: int     # pixels a block reads at once: THREADS // (C / 8)
    pixels: int   # pixels a chunk: rows x loads a thread
    chunks: int   # chunks an image: ceil(HW / pixels)
    scratch: int  # float32 words: scale and shift a channel, partials


def plan(n: int, hw: int, c: int, groups: int) -> Plan:
    """The kernels' chunking of an (n, hw pixels, c) norm of ``groups``.

    A block of the statistics and of the output pass takes ``pixels``
    contiguous pixels of one image, all channels; a thread one 8-channel
    column of ``rows`` pixels at a time.  The chunk is 16 rows a thread
    (64 KB), halved while the grid would have fewer than ``MIN_BLOCKS``
    blocks, down to ``UNROLL`` rows."""
    if c < 8 or c % 8 or c > MAX_C or groups < 1 or c % groups:
        raise ValueError(f"groupnorm plan: needs C a multiple of 8 up to "
                         f"{MAX_C} and groups dividing C, got C={c}, "
                         f"groups={groups}")
    rows = THREADS // (c // 8)
    iters = MAX_ITERS
    while iters > UNROLL and n * -(-hw // (rows * iters)) < MIN_BLOCKS:
        iters //= 2
    pixels = rows * iters
    chunks = -(-hw // pixels)
    return Plan(rows, pixels, chunks, 2 * n * c + 2 * n * chunks * groups)


def resources() -> dict:
    """What ``nvcc -Xptxas -v`` reported for each kernel of the library
    (``_build.parse_ptxas``: registers, spill bytes, static shared
    memory), by mangled name."""
    return LIBRARY.ptxas()


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float,
                     relu: bool = False,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: float32 statistics over each (image, group), the sum
    and the 2-norm in two reductions that read x's dtype, the variance the
    mean square less the squared mean, clamped at 0; one ``addcmul`` of
    each (image, channel)'s scale ``weight / sqrt(var + eps)`` and shift
    ``bias - mean * scale``, both rounded to x's dtype; then ``residual +
    y`` and an in-place ReLU where asked, each in x's dtype."""
    n, h, w, c = x.shape
    g = groups
    xv = x.reshape(n, h * w, g, c // g)
    count = h * w * (c // g)
    mean = xv.sum(dim=(1, 3), keepdim=True, dtype=torch.float32) / count
    norm = torch.linalg.vector_norm(xv, dim=(1, 3), keepdim=True,
                                    dtype=torch.float32)
    var = (norm * norm / count - mean * mean).clamp_min_(0)
    scale = torch.rsqrt(var + eps) * weight.float().view(1, 1, g, c // g)
    shift = bias.float().view(1, 1, g, c // g) - mean * scale
    y = torch.addcmul(shift.to(x.dtype), xv, scale.to(x.dtype)).view(
        n, h, w, c)
    if residual is not None:
        y = residual + y
    if relu:
        y.relu_()
    return y


def oracle_float64(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, groups: int, eps: float,
                   relu: bool = False,
                   residual: Optional[torch.Tensor] = None) -> tuple:
    """``relu(residual + gn(x))`` in float64, with the two magnitudes the
    tolerances scale: (y, the terms' |x s| + |shift| + |residual|, the
    operands' |x s| + |bias| + |mean s| + |residual|), each x's shape."""
    n, h, w, c = x.shape
    xv = x.double().reshape(n, h * w, groups, c // groups)
    var, mean = torch.var_mean(xv, dim=(1, 3), keepdim=True, unbiased=False)
    s = weight.double().view(1, 1, groups, -1) / torch.sqrt(var + eps)
    shift = bias.double().view(1, 1, groups, -1) - mean * s
    y = (xv * s + shift).view(n, h, w, c)
    xs = (xv * s).abs().view(n, h, w, c)
    terms = xs + shift.abs().view(n, 1, 1, c)
    operands = xs + (bias.double().view(1, 1, groups, -1).abs()
                     + (mean * s).abs()).view(n, 1, 1, c)
    if residual is not None:
        y = y + residual.double()
        terms = terms + residual.double().abs()
        operands = operands + residual.double().abs()
    if relu:
        y = y.clamp_min(0)
    return y, terms, operands


def _check(x, weight, bias, groups, relu, residual) -> None:
    if x.dim() != 4 or groups < 1 or x.shape[-1] % groups or \
            tuple(weight.shape) != (x.shape[-1],) or \
            tuple(bias.shape) != (x.shape[-1],) or \
            (residual is not None and residual.shape != x.shape):
        raise ValueError(
            f"group_norm: x {tuple(x.shape)} (N, H, W, C), weight "
            f"{tuple(weight.shape)}, bias {tuple(bias.shape)} (C,), groups "
            f"{groups} dividing C, residual "
            f"{None if residual is None else tuple(residual.shape)} as x")
    if residual is not None and not relu:
        raise ValueError("group_norm: a residual is taken only with relu")
    ops = [x, weight, bias] + ([] if residual is None else [residual])
    if len({t.device for t in ops}) != 1:
        raise ValueError("group_norm: all operands must be on one device")


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float, relu: bool = False,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm of NHWC ``x`` (N, H, W, C) over ``groups`` groups of
    channels, affine by ``weight`` and ``bias`` (C,), then ReLU where asked,
    with ``residual`` (x's shape, only with ``relu``) added before it:
    ``relu(residual + gn(x))``.

    A CUDA ``x`` goes to the kernel, which needs x, residual, weight and
    bias in bf16, x and residual contiguous and 16-byte aligned, C a
    multiple of 8 up to ``MAX_C``; anything else raises.  A CPU ``x`` takes
    :func:`group_norm_plain`.
    """
    _check(x, weight, bias, groups, relu, residual)
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, relu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    ops = [x, weight, bias] + ([] if residual is None else [residual])
    if any(t.dtype != torch.bfloat16 for t in ops):
        raise TypeError(f"group_norm kernel takes bf16 only, got "
                        f"{sorted({str(t.dtype) for t in ops})}")
    n, h, w, c = x.shape
    streams = [x] + ([] if residual is None else [residual])
    if not all(t.is_contiguous() for t in ops) or \
            any(t.data_ptr() % 16 for t in streams):
        raise ValueError("group_norm kernel needs contiguous operands and a "
                         "16-byte aligned x and residual")
    p = plan(n, h * w, c, groups)
    if n * p.chunks >= 2 ** 31:
        raise ValueError(f"group_norm kernel: {n * p.chunks} blocks, more "
                         f"than the grid holds")
    out = torch.empty_like(x)
    scratch = torch.empty(p.scratch, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to x's card
        err = LIBRARY.load().utgroupnorm_nhwc_bf16(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n, h * w, c, groups,
            p.pixels, p.chunks, eps, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "group_norm")
    LAUNCHES["groupnorm_nhwc"] += 1
    return out
