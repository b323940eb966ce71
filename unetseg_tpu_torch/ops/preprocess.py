"""Preprocess: the reference's min-max + bilinear 512² + quantize
(``src/preprocess.cpp:65-118``), as the bit-exact host oracle and as the
device path, and the model input from the u8 image (the port of
``unetseg_tpu.ops.preprocess``).

The default serving path quantizes on the host with the C++ library
(``io/native.preprocess_u8``) and hands the device only u8; the model input
is then u8/255, the reference's u8 round-trip (``src/process.cpp:36-39``).
Sliding-window mode quantizes on the device at native resolution
(:func:`normalize_u8`).

The device functions keep JAX's float32 ops in JAX's order, one op per
step, so on the CPU and on the card they give the bytes that
``unetseg_tpu.ops.preprocess`` gives when called eagerly.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

OUT_SIZE = 512


def _grid_1d(n_src: int, n_out: int):
    """Truncating bilinear sample positions along one axis (float64)."""
    step = n_src / n_out  # double division, as in preprocess.cpp:82-83
    f = np.arange(n_out, dtype=np.float64) * step
    i0 = f.astype(np.int64)  # static_cast<int> truncation (f >= 0)
    i1 = np.minimum(i0 + 1, n_src - 1)
    return i0, i1, f - i0


def preprocess_oracle_u8(raw: np.ndarray, out_size: int = OUT_SIZE) -> np.ndarray:
    """Bit-exact numpy float64 reimplementation of preprocess_raw's pixel
    math: (h, w) uint16 -> (out_size, out_size) uint8."""
    raw = np.asarray(raw)
    if raw.dtype != np.uint16 or raw.ndim != 2:
        raise ValueError(f"want (h, w) uint16, got {raw.shape} {raw.dtype}")
    h, w = raw.shape
    mn = int(raw.min())
    mx = int(raw.max())
    if mn == mx:
        mx = mn + 1
    scale8 = 255.0 / (mx - mn)

    ix, ix1, dx = _grid_1d(w, out_size)
    iy, iy1, dy = _grid_1d(h, out_size)
    src = raw.astype(np.float64)
    v00 = src[np.ix_(iy, ix)]
    v01 = src[np.ix_(iy, ix1)]
    v10 = src[np.ix_(iy1, ix)]
    v11 = src[np.ix_(iy1, ix1)]
    dxg = dx[None, :]
    dyg = dy[:, None]
    # Exact term/association order of src/preprocess.cpp:112-115.
    v = (((1 - dxg) * (1 - dyg)) * v00 + (dxg * (1 - dyg)) * v01
         + ((1 - dxg) * dyg) * v10 + (dxg * dyg) * v11)
    q = (v - mn) * scale8 + 0.5
    return np.floor(q).astype(np.uint8)  # truncating cast; q >= 0


def model_input_from_u8(u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1] (src/process.cpp:36-39)."""
    return u8.to(torch.float32) / 255.0


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _gather_plan(h: int, w: int, out_size: int):
    """Per-shape gather indices and f32 blend weights (host float64), as
    numpy arrays: (iy, iy1, dy, ix, ix1, dx)."""
    ix, ix1, dx = _grid_1d(w, out_size)
    iy, iy1, dy = _grid_1d(h, out_size)
    return (iy.astype(np.int64), iy1.astype(np.int64), dy.astype(np.float32),
            ix.astype(np.int64), ix1.astype(np.int64), dx.astype(np.float32))


@functools.lru_cache(maxsize=64)
def _gather_plan_on(h: int, w: int, out_size: int, device: str):
    """:func:`_gather_plan` as tensors on ``device``, copied once: a copy
    from pageable host memory waits for the device work queued before it,
    which would stall a pipeline that enqueues batches ahead."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in _gather_plan(h, w, out_size))


def _as_i32(raw: torch.Tensor) -> torch.Tensor:
    """uint16 (or any integer) tensor -> int32.  Few torch ops take
    ``torch.uint16`` (no min or max), so it is read as int16 and masked."""
    if raw.dtype == torch.uint16:
        return raw.view(torch.int16).to(torch.int32) & 0xFFFF
    return raw.to(torch.int32)


def _min_max_scale(as_i32: torch.Tensor):
    """(mn as f32, scale8) of each (h, w) image: ``mx = mn + 1`` when flat
    (preprocess.cpp:92), ``scale8 = 255 / (mx - mn)`` in f32.  Both
    operands of the division are tensors: ``255.0 / t`` is computed as
    ``255 * (1 / t)``, and a Python divisor as a reciprocal product on
    CUDA, each an ulp away at times."""
    mn = as_i32.amin(dim=(-2, -1), keepdim=True)
    mx = as_i32.amax(dim=(-2, -1), keepdim=True)
    mx = torch.where(mx == mn, mn + 1, mx)
    span = (mx - mn).to(torch.float32)
    return mn.to(torch.float32), torch.full_like(span, 255.0) / span


def _bilinear_u16(src: torch.Tensor, h: int, w: int, out_size: int
                  ) -> torch.Tensor:
    """(..., h, w) float32 image -> (..., out, out) float32 bilinear
    (reference semantics: truncating sample positions, clamped
    neighbours); a lerp along y, then along x."""
    iy, iy1, dy, ix, ix1, dx = _gather_plan_on(h, w, out_size,
                                               str(src.device))
    top = src.index_select(-2, iy)
    bot = src.index_select(-2, iy1)
    rows = top + (bot - top) * dy[:, None]
    left = rows.index_select(-1, ix)
    right = rows.index_select(-1, ix1)
    return left + (right - left) * dx


def resize_normalize_u8(raw: torch.Tensor, out_size: int = OUT_SIZE
                        ) -> torch.Tensor:
    """(..., h, w) uint16 -> (..., out, out) uint8 on ``raw``'s device:
    per-image min-max, bilinear resample, quantize."""
    h, w = raw.shape[-2], raw.shape[-1]
    as_i32 = _as_i32(raw)
    mn, scale8 = _min_max_scale(as_i32)
    v = _bilinear_u16(as_i32.to(torch.float32), h, w, out_size)
    q = (v - mn) * scale8 + 0.5
    return torch.floor(q).to(torch.uint8)


def normalize_u8(raw: torch.Tensor) -> torch.Tensor:
    """Min-max quantize at native resolution, no resample: (..., h, w)
    uint16 -> uint8 on ``raw``'s device (sliding-window mode's
    preprocess)."""
    as_i32 = _as_i32(raw)
    mn, scale8 = _min_max_scale(as_i32)
    q = (as_i32.to(torch.float32) - mn) * scale8 + 0.5
    return torch.floor(q).to(torch.uint8)


def model_input_from_u16(u16: torch.Tensor) -> torch.Tensor:
    """uint16 -> float32 / 65535 (src/process.cpp:30-34), a true division
    on every device."""
    x = _as_i32(u16).to(torch.float32)
    return x / x.new_tensor(65535.0)


def preprocess_batch(raws: torch.Tensor, out_size: int = OUT_SIZE
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, h, w) uint16 -> (u8 (N, out, out), model input (N, out, out, 1)
    float32), the input through the u8 round-trip."""
    u8 = resize_normalize_u8(raws, out_size)
    return u8, model_input_from_u8(u8)[..., None]
