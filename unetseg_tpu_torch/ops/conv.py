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
``_conv3x3_small_c``.  The kernel reads channel chunks of 16, 32 or 64, so
an input whose C is not a multiple of 16 (the flagship's C = 1 first conv, a
stem-2 model's C = 4) is zero-padded to one first
(:func:`pad_input_channels`), which is exact: the zero channels meet zero
weight rows.

The kernel's tiling is decided here, in :func:`tile_plan`, and passed to it,
so the CPU tests cover the plan: tiles of 128 output pixels (``rt`` rows x
``wt`` columns of one image) by ``bn`` channels, and K slices of ``bkc``
channels of one tap; with ``fold``, one input box of ``wt + 2`` columns
serves the three dx taps of a row of taps.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from unetseg_tpu_torch._build import NVCC_FLAGS, build_shared, nvcc, read_log

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCE = os.path.join(CSRC, "conv3x3.cu")
#: The Hopper helpers the kernel sources include (hashed into the build).
HEADER = os.path.join(CSRC, "hopper.cuh")

#: Kernel launches per variant since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"conv3x3_bias_act": 0,
                            "conv3x3_bias_act_small_c": 0}

#: Output pixels per tile: the M of two 64-row wgmma warpgroups.
TILE_PIXELS = 128

_lock = threading.Lock()
_lib = None
_lib_path = None


class TilePlan(NamedTuple):
    """How the kernel cuts one conv: see :func:`tile_plan`."""
    wt: int       # tile columns: min(128, next power of two >= W)
    rt: int       # tile rows: 128 // wt
    bn: int       # output channels per tile: 64, 128 or 256
    bkc: int      # channels per K slice (one TMA box): 64, 32 or 16
    swizzle: int  # shared-memory swizzle of the A box, bytes: bkc * 2
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
    if C % 16 or D % 16 or min(B, H, W, C, D) < 1:
        raise ValueError(f"conv3x3 tile plan: needs C and D multiples of 16, "
                         f"got B={B} H={H} W={W} C={C} D={D}")
    wt = min(TILE_PIXELS, 1 << (W - 1).bit_length())
    rt = TILE_PIXELS // wt
    bkc = next(k for k in (64, 32, 16) if C % k == 0)
    bn = 64 if D <= 64 else 256 if D >= 256 and bkc == 64 else 128
    fold = wt >= 64 and bn <= 128
    tiles_w, tiles_h, tiles_n = -(-W // wt), -(-H // rt), -(-D // bn)
    return TilePlan(wt, rt, bn, bkc, 2 * bkc, fold, tiles_w, tiles_h,
                    tiles_n, B * tiles_h * tiles_w * tiles_n)


# The entry point's own error codes (CUDA's are positive).
_ERRORS = {-1: "tile plan refused", -2: "no cuTensorMapEncodeTiled in the "
           "driver", -3: "tensor map refused"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises if it cannot be."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            path = build_shared("libconv3x3",
                                [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v"],
                                [SOURCE], deps=[HEADER])
            lib = ctypes.CDLL(path)
            lib.utconv3x3_bf16.restype = ctypes.c_int
            lib.utconv3x3_bf16.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                + [ctypes.c_void_p])
            lib.utconv3x3_smem_bytes.restype = ctypes.c_int
            lib.utconv3x3_smem_bytes.argtypes = [ctypes.c_int] * 3
            _lib, _lib_path = lib, path
        return _lib


def resources() -> list:
    """Per kernel instantiation, what ``nvcc -Xptxas -v`` reported when the
    library was built (registers, spills, static shared memory) and its
    dynamic shared memory: a list of dicts with keys ``bkc``, ``bn``,
    ``fold``, ``registers``, ``spill_bytes``, ``smem_static``,
    ``smem_dynamic``."""
    lib = load()
    out = []
    for name, info in parse_ptxas(read_log(_lib_path)).items():
        m = re.search(r"conv3x3_wgmma_kernelILi(\d+)ELi(\d+)ELb([01])E", name)
        if m:
            bkc, bn, fold = (int(g) for g in m.groups())
            out.append({"bkc": bkc, "bn": bn, "fold": bool(fold), **info,
                        "smem_dynamic": lib.utconv3x3_smem_bytes(bkc, bn,
                                                                 fold)})
    return sorted(out, key=lambda r: (r["fold"], r["bkc"], r["bn"]))


def parse_ptxas(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_bytes", "smem_static"}}
    from ``ptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": None, "spill_bytes": 0,
                                  "smem_static": 0})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_static"] = int(m.group(1)) if m else 0
    return out


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


def conv3x3_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """3x3 stride-1 SAME conv + bias (+ ReLU): (B,H,W,C) x (3,3,C,D) + (D,)
    -> (B,H,W,D) in ``x.dtype``, summed in float32.

    CUDA tensors must be bf16, contiguous and 16-byte aligned; anything
    else raises.  C and D may be any size: the kernel gets them zero-padded
    to multiples of 16 (:func:`pad_input_channels`,
    :func:`pad_output_channels`) and the output is sliced back to D.
    B, H and W may be any size; the kernel runs :func:`tile_plan`'s tiling.
    """
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_bias_act_plain(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if not (x.dtype == w.dtype == b.dtype == torch.bfloat16):
        raise TypeError(f"conv3x3 kernel takes bf16 only, got {x.dtype}, "
                        f"{w.dtype}, {b.dtype}")
    d_out = w.shape[3]
    x, w = pad_input_channels(x, w)
    w, b = pad_output_channels(w, b)
    B, H, W, C = x.shape
    D = w.shape[3]
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3x3 kernel needs contiguous x, w, b")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3 kernel needs 16-byte aligned x and w")
    plan = tile_plan(B, H, W, C, D)
    if plan.grid >= 2 ** 31 or max(B, H, W) >= 2 ** 31:
        raise ValueError(f"conv3x3 kernel: {plan.grid} tiles, more than the "
                         f"grid holds")
    lib = load()
    out = torch.empty((B, H, W, D), dtype=x.dtype, device=x.device)
    small_c = C < 128
    with torch.cuda.device(x.device):  # the launch goes to x's card
        err = lib.utconv3x3_bf16(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            B, H, W, C, D, int(relu), plan.wt, plan.rt, plan.bn, plan.bkc,
            int(plan.fold), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    LAUNCHES["conv3x3_bias_act_small_c" if small_c
             else "conv3x3_bias_act"] += 1
    return out if D == d_out else out[..., :d_out].contiguous()
