"""The last decoder level, head and argmax of a stem-1 UNet: the K6 kernel.

The port's counterpart of the Pallas kernel of
``benchmarks/exp_dec1_ablate.py::make`` ("full" variant): 2x2 up-conv,
``[skip, up]``, two 3x3 conv+ReLU, the 1x1 head and a first-max argmax in
one pass, so the full-resolution up-conv output, the concat, both conv
outputs and the f32 logits never reach device memory.  On a CUDA tensor
:func:`dec1_fused_masks` launches the hand-written kernel in
``unetseg_tpu_torch/csrc/dec1_fused.cu`` (built with nvcc for sm_90a at
first use, bound with ctypes) or raises; it never falls back.  On a CPU
tensor it runs :func:`dec1_fused_plain`, which the tests and
``chip_smoke.py`` hold the kernel against.

Rounding points (K6's, with the model's biases): up = round(f32(x.Wu) +
bu); c1 = round(relu(f32 conv + b1)); c2 = round(relu(f32 conv + b2));
logits = f32(c2.Wh) + bh in f32; the class is the first max.  ``round``
is to x's dtype, so in float32 nothing rounds and the plain version is the
module's own ``decode_mask(forward(x))``, bit for bit.

``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict

import torch

from unetseg_tpu_torch._build import NVCC_FLAGS, build_shared, nvcc
from unetseg_tpu_torch.ops.conv import conv3x3_bias_act_plain
from unetseg_tpu_torch.ops.decode import decode_mask

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "dec1_fused.cu")
#: Output channels of the level the kernel is built for (shared memory
#: bounds it: 217 KB of the block's 227 KB at C = 96).
KERNEL_CHANNELS = (16, 32, 48, 64, 80, 96)
MAX_CLASSES = 8

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"dec1_fused": 0}

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
                "libdec1_fused", [nvcc(), *NVCC_FLAGS], [SOURCE]))
            lib.utdec1_fused_bf16.restype = ctypes.c_int
            lib.utdec1_fused_bf16.argtypes = (
                [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            _lib = lib
        return _lib


def up_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 transposed conv as one matmul + reshape: (N, H, W, Ci)
    x (Ci, 4*O) laid out (c, a, b, o) + (O,) -> (N, 2H, 2W, O), in the
    inputs' dtype (``models.unet.UpConv``'s arithmetic)."""
    n, h, wd, _ = x.shape
    o = b.shape[0]
    y = (x @ w).reshape(n, h, wd, 2, 2, o)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * wd, o)
    return y + b


def dec1_head_input_plain(x, skip, up_w, up_b, w1, b1, w2, b2
                          ) -> torch.Tensor:
    """c2, the head's input (N, H, W, C) in x's dtype, from the model's own
    ops, rounding at K6's points.  Set ``torch.backends.cudnn.allow_tf32 =
    False`` before calling it on the card, or the f32 convs run in TF32."""
    up = up_conv(x.float(), up_w.float(), up_b.float()).to(x.dtype)
    c1 = conv3x3_bias_act_plain(torch.cat([skip, up], dim=-1), w1, b1)
    return conv3x3_bias_act_plain(c1, w2, b2)


def dec1_fused_plain(x, skip, up_w, up_b, w1, b1, w2, b2, wh, bh
                     ) -> torch.Tensor:
    """Plain version of :func:`dec1_fused_masks`: f32 head logits of
    :func:`dec1_head_input_plain`, first-max argmax.  Set
    ``torch.backends.cuda.matmul.allow_tf32 = False`` too on the card."""
    c2 = dec1_head_input_plain(x, skip, up_w, up_b, w1, b1, w2, b2)
    return decode_mask(c2.float() @ wh.float() + bh.float(), wh.shape[1])


def near_tie(c2: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
             ulps: float = 1.0) -> torch.Tensor:
    """bool (N, H, W): pixels whose class two correct implementations may
    pick differently, the tolerance of every K6 parity check.

    Two implementations that sum in another f32 order may round a conv
    output to the neighbouring bf16 value; such flips move a logit by up to
    a bf16 ulp of the head's absolute sum ``|c2|.|wh| + |bh|``, which
    exceeds the logit itself where its terms cancel.  A pixel is near a tie
    when its top-2 logit margin is within ``ulps`` bf16 ulps of the larger
    of the two classes' absolute sums; with no cancellation and one ulp
    that is one ulp of the larger logit.
    """
    c2, wh, bh = c2.float(), wh.float(), bh.float()
    logits = c2 @ wh + bh
    if logits.shape[-1] < 2:
        return torch.zeros(logits.shape[:-1], dtype=torch.bool,
                           device=logits.device)
    top = logits.topk(2, dim=-1)
    absum = (c2.abs() @ wh.abs() + bh.abs()).gather(-1, top.indices)
    ulp = torch.exp2(torch.floor(torch.log2(
        absum.amax(-1).clamp_min(2.0 ** -126))) - 7)
    return top.values[..., 0] - top.values[..., 1] <= ulps * ulp


def _check(x, skip, up_w, up_b, w1, b1, w2, b2, wh, bh) -> None:
    shapes = [tuple(t.shape) for t in (x, skip, up_w, up_b, w1, b1, w2, b2,
                                       wh, bh)]
    ok = x.dim() == 4 and skip.dim() == 4 and wh.dim() == 2
    if ok:
        n, h, w, c = skip.shape
        k = wh.shape[1]
        ok = shapes == [(n, h // 2, w // 2, 2 * c), (n, h, w, c),
                        (2 * c, 4 * c), (c,), (3, 3, 2 * c, c), (c,),
                        (3, 3, c, c), (c,), (c, k), (k,)] \
            and h % 2 == 0 and w % 2 == 0 and k >= 1
    if not ok:
        raise ValueError(f"dec1_fused: x, skip, up_w, up_b, w1, b1, w2, b2, "
                         f"wh, bh have shapes {shapes}; want (N, H/2, W/2, "
                         f"2C), (N, H, W, C), (2C, 4C), (C,), (3, 3, 2C, C), "
                         f"(C,), (3, 3, C, C), (C,), (C, K), (K,) with H, W "
                         f"even")
    ops = (x, skip, up_w, up_b, w1, b1, w2, b2, wh, bh)
    if len({t.device for t in ops}) != 1:
        raise ValueError("dec1_fused: all operands must be on one device")
    dtypes = {t.dtype for t in ops}
    if len(dtypes) != 1 or not x.dtype.is_floating_point:
        raise TypeError(f"dec1_fused: operands must share one floating "
                        f"dtype, got {sorted(map(str, dtypes))}")


def dec1_fused_masks(x, skip, up_w, up_b, w1, b1, w2, b2, wh, bh
                     ) -> torch.Tensor:
    """The last decoder level + head + first-max argmax -> uint8 (N, H, W).

    x: (N, H/2, W/2, 2C), the level's input; skip: (N, H, W, C); up_w:
    (2C, 4C) in ``UpConv``'s layout (taps already flipped by
    ``checkpoint.up_weight_from_hwio``); w1: (3, 3, 2C, C) HWIO over
    ``[skip, up]``; w2: (3, 3, C, C); wh: (C, K); biases (C,) and (K,).

    CUDA tensors must be bf16, contiguous and 16-byte aligned, with C in
    ``KERNEL_CHANNELS`` and K <= ``MAX_CLASSES``; anything else raises.
    """
    ops = (x, skip, up_w, up_b, w1, b1, w2, b2, wh, bh)
    _check(*ops)
    if x.device.type == "cpu":
        return dec1_fused_plain(*ops)
    if x.device.type != "cuda":
        raise ValueError(f"dec1_fused: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"dec1_fused kernel takes bf16 only, got {x.dtype}")
    n, h, w, c = skip.shape
    k = wh.shape[1]
    if c not in KERNEL_CHANNELS or k > MAX_CLASSES or n >= 2 ** 16:
        raise ValueError(f"dec1_fused kernel needs C in {KERNEL_CHANNELS}, "
                         f"at most {MAX_CLASSES} classes and N < 65536 (its "
                         f"grid's z), got C={c}, K={k}, N={n}")
    if not all(t.is_contiguous() for t in ops) or \
            any(t.data_ptr() % 16 for t in (x, skip, up_w, w1, w2)):
        raise ValueError("dec1_fused kernel needs contiguous operands and "
                         "16-byte aligned x, skip, up_w, w1, w2")
    out = torch.empty((n, h, w), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to x's card
        err = load().utdec1_fused_bf16(
            *(t.data_ptr() for t in ops), out.data_ptr(), n, h, w, c, k,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dec1_fused kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["dec1_fused"] += 1
    return out
