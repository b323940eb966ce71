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

The kernel's tiling is decided here, in :func:`tile_plan`, and passed to
it, so the CPU tests cover the plan: TH x TW output tiles whose [skip, up]
planes are IN_W = TW + 4 pixels wide, the convs computed on that flat grid
(wrap columns dropped), and a ring of weight slots filling the rest of the
block's shared memory.

``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, NamedTuple

import torch
from torch.overrides import handle_torch_function, has_torch_function_unary

from unetseg_tpu_torch import graphs
from unetseg_tpu_torch._build import Library, check, cuda
from unetseg_tpu_torch.ops.conv import HEADER, conv3x3_bias_act_plain
from unetseg_tpu_torch.ops.decode import decode_mask

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "dec1_fused.cu")
#: Output channels of the level the kernel is built for.
KERNEL_CHANNELS = (16, 32, 48, 64, 80, 96)
MAX_CLASSES = 8
#: Shared memory a block may use on the H100, bytes.
SMEM_LIMIT = 232448
MAX_STAGES = 8
#: Tile widths tried (IN_W = TW + 4 = 16, 32 or 64 pixels).
TILE_WIDTHS = (12, 28, 60)
#: Accumulator budget per consumer thread (floats) and the M slices of 64
#: rows that each of the two consumer warpgroups may hold.
ACC_FLOATS = 128
CONSUMERS = 2

#: The kernel's entry points: the launch and its shared-memory layout.
FUNCTIONS = {"utdec1_fused_bf16": (ctypes.c_int, [ctypes.c_void_p] * 11
                                   + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
             "utdec1_smem_bytes": (ctypes.c_int, [ctypes.c_int] * 4)}
LIBRARY = Library("libdec1_fused", cuda("-Xptxas", "-v"), [SOURCE],
                  deps=[HEADER], functions=FUNCTIONS)
load = LIBRARY.load

#: Kernel launches since the last ``graphs.reset_launches``.
LAUNCHES: Dict[str, int] = graphs.counts_launches({"dec1_fused": 0})


class TilePlan(NamedTuple):
    """How the kernel cuts one level: see :func:`tile_plan`."""
    th: int       # output rows per tile (even)
    tw: int       # output columns per tile (even)
    in_w: int     # plane width in pixels: tw + 4 (a 2-pixel halo each side)
    stages: int   # weight ring slots
    smem: int     # dynamic shared memory, bytes
    bkc: int      # channels per swizzle row of the skip, up and c1 planes
    bkx: int      # channels per swizzle row of the x plane
    n_pad: int    # conv output channels: C rounded up to 64 (wgmma M)
    n_x: int      # wgmma N of the up-GEMM: the x pixels under the tile
    n_c1: int     # wgmma N of conv1 per warpgroup: half its grid
    n_c2: int     # wgmma N of conv2 per warpgroup: half its grid
    tiles_h: int
    tiles_w: int
    grid: int     # blocks: B * tiles_h * tiles_w


def _chunk(c: int) -> int:
    return 64 if c % 64 == 0 else 32 if c % 32 == 0 else 16


def _round1024(n: int) -> int:
    return -(-n // 1024) * 1024


def geometry(C: int, th: int, tw: int, stages: int) -> dict:
    """The kernel's grids and shared-memory layout for a tile (``Geo`` in
    ``dec1_fused.cu``).  conv1 runs on the (th + 2) x in_w grid, conv2 on
    th x in_w, each warpgroup on one half; the up-GEMM on all x pixels."""
    bkc, bkx = _chunk(C), _chunk(2 * C)
    n_pad = -(-C // 64) * 64
    in_w, in_h = tw + 4, th + 4
    m1, m2, mx = (th + 2) * in_w, th * in_w, (in_w // 2) * (in_h // 2)
    # A plane is read up to 2 * in_w + 2 rows past a grid row: two rows of
    # slack past the input planes and past c1.
    plane_in = _round1024((in_h * in_w + 2) * 2 * bkc)
    plane_c1 = _round1024((m1 + 2) * 2 * bkc)
    plane_x = _round1024(mx * 2 * bkx)
    slot = max(bkc * n_pad, bkx * 64) * 2
    params = 4 * (C + 2 * n_pad + MAX_CLASSES * n_pad + MAX_CLASSES)
    fixed = (1024 + 2 * (C // bkc) * plane_in
             + max(C // bkc * plane_c1, 2 * C // bkx * plane_x) + params + 16)
    return {"bkc": bkc, "bkx": bkx, "n_pad": n_pad, "in_w": in_w,
            "in_h": in_h, "m1": m1, "m2": m2, "mx": mx, "slot": slot,
            "fixed": fixed, "smem": fixed + stages * (slot + 16)}


def _fits(C: int, g: dict) -> bool:
    """The tile's wgmma N (<= 256, multiples of 8) and each consumer
    thread's accumulators (<= ``ACC_FLOATS``) fit: a warpgroup holds its
    half of a conv grid for every 64 output channels, and the up-GEMM's
    x pixels for every other 64 of its 4C columns."""
    n1, n2, nx = g["m1"] // 2, g["m2"] // 2, g["mx"]
    blocks, pieces = g["n_pad"] // 64, -(-4 * C // 64 // CONSUMERS)
    return (max(n1, n2, nx) <= 256 and n1 % 8 == 0 and n2 % 8 == 0
            and nx % 8 == 0 and blocks * n1 // 2 <= ACC_FLOATS
            and pieces * nx // 2 <= ACC_FLOATS)


@functools.lru_cache(maxsize=None)
def _tile_shape(C: int) -> tuple:
    """(th, tw, stages) for C: of the tiles whose planes, two weight slots
    and accumulators fit, the one that executes the fewest products per
    output pixel (ties: the larger tile).  ``dec1_fused.cu`` holds the
    same table (``TILES``), and its entry point refuses any other."""
    best = None
    for tw in TILE_WIDTHS:
        for th in range(2, 62, 2):
            g = geometry(C, th, tw, 0)
            stages = min(MAX_STAGES, (SMEM_LIMIT - g["fixed"])
                         // (g["slot"] + 16))
            if stages < 2 or th + 4 > 256 or not _fits(C, g):
                continue
            work = (g["mx"] * 8 * C * C + g["m1"] * 18 * C * g["n_pad"]
                    + g["m2"] * 9 * C * g["n_pad"])
            key = (work / (th * tw), -th * tw)
            if best is None or key < best[0]:
                best = (key, (th, tw, stages))
    return best[1]


def tile_plan(B: int, H: int, W: int, C: int) -> TilePlan:
    """The kernel's tiling of a level with skip (B, H, W, C).

    A tile is TH x TW output pixels of one image (12 x 28 at C = 64); its
    planes span the tile with a 2-pixel halo, IN_W = TW + 4 pixels wide,
    and conv1 and conv2 run on that flat grid.  The tile shape depends on
    C only; a ragged last tile, or an image smaller than one tile, is
    masked by the kernel.  Raises on what the kernel does not take: C not
    in ``KERNEL_CHANNELS``, H or W odd, an empty batch, a grid past 2^31."""
    if C not in KERNEL_CHANNELS or min(B, H, W) < 1 or H % 2 or W % 2:
        raise ValueError(f"dec1 tile plan: needs C in {KERNEL_CHANNELS}, "
                         f"H and W even, B >= 1; got B={B} H={H} W={W} C={C}")
    th, tw, stages = _tile_shape(C)
    g = geometry(C, th, tw, stages)
    tiles_h, tiles_w = -(-H // th), -(-W // tw)
    grid = B * tiles_h * tiles_w
    if grid >= 2 ** 31:
        raise ValueError(f"dec1 tile plan: {grid} tiles, more than the grid "
                         f"holds")
    return TilePlan(th, tw, g["in_w"], stages, g["smem"], g["bkc"], g["bkx"],
                    g["n_pad"], g["mx"], g["m1"] // 2, g["m2"] // 2, tiles_h,
                    tiles_w, grid)


def kernel_takes(c: int, k: int) -> bool:
    """Whether the kernel is built for a level of C channels and K classes:
    the route ``models.unet.UNet`` picks once, from the model's config."""
    return c in KERNEL_CHANNELS and 1 <= k <= MAX_CLASSES


def resources() -> list:
    """Per kernel instantiation (one per C), what ``nvcc -Xptxas -v``
    reported when the library was built (registers, spills, static shared
    memory) and the dynamic shared memory of its tile plan: a list of
    dicts with keys ``C``, ``th``, ``tw``, ``stages``, ``registers``,
    ``spill_bytes``, ``smem_static``, ``smem_dynamic``."""
    smem = load().utdec1_smem_bytes
    out = []
    for (c,), info in LIBRARY.instantiations("dec1_wgmma_kernel"):
        th, tw, stages = _tile_shape(c)
        out.append({"C": c, "th": th, "tw": tw, "stages": stages, **info,
                    "smem_dynamic": smem(c, th, tw, stages)})
    return sorted(out, key=lambda r: r["C"])


def up_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 transposed conv as one matmul + reshape: (N, H, W, Ci)
    x (Ci, 4*O) laid out (c, a, b, o) + (O,) -> (N, 2H, 2W, O), in the
    inputs' dtype (``models.unet.UpConv``'s arithmetic).  Row-local: row
    bands (``parallel.spatial.Bands``) take it band by band."""
    if has_torch_function_unary(x):
        return handle_torch_function(up_conv, (x,), x, w, b)
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
    return near_tie_sums(c2 @ wh + bh, c2.abs() @ wh.abs() + bh.abs(), ulps)


def near_tie_sums(logits: torch.Tensor, absum: torch.Tensor,
                  ulps: float = 1.0) -> torch.Tensor:
    """:func:`near_tie` from the logits (..., K) and each class's absolute
    head sum (..., K) directly, for logits that are averages or blends of
    several head outputs (TTA, sliding windows) with their sums averaged or
    blended alike."""
    if logits.shape[-1] < 2:
        return torch.zeros(logits.shape[:-1], dtype=torch.bool,
                           device=logits.device)
    top = logits.topk(2, dim=-1)
    absum = absum.gather(-1, top.indices)
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
    ``KERNEL_CHANNELS`` and K <= ``MAX_CLASSES``; anything else raises.  The
    kernel runs :func:`tile_plan`'s tiling.
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
    if not kernel_takes(c, k):
        raise ValueError(f"dec1_fused kernel needs C in {KERNEL_CHANNELS} "
                         f"and at most {MAX_CLASSES} classes, got C={c}, "
                         f"K={k}")
    if not all(t.is_contiguous() for t in ops) or \
            any(t.data_ptr() % 16 for t in (x, skip, up_w, w1, w2)):
        raise ValueError("dec1_fused kernel needs contiguous operands and "
                         "16-byte aligned x, skip, up_w, w1, w2")
    plan = tile_plan(n, h, w, c)
    lib = load()
    if lib.utdec1_smem_bytes(c, plan.th, plan.tw, plan.stages) != plan.smem:
        raise RuntimeError("dec1_fused: the kernel's shared-memory layout "
                           "differs from tile_plan's")
    out = torch.empty((n, h, w), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to x's card
        err = lib.utdec1_fused_bf16(
            *(t.data_ptr() for t in ops), out.data_ptr(), n, h, w, c, k,
            plan.th, plan.tw, plan.stages,
            torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "dec1_fused")
    LAUNCHES["dec1_fused"] += 1
    return out
