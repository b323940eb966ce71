"""Preprocess: the model input from the u8 image, and the bit-exact host
oracle of the reference's min-max + bilinear 512² + quantize
(``src/preprocess.cpp:65-118``; copy of ``unetseg_tpu.ops.preprocess``).

The serving path quantizes on the host with the C++ library
(``io/native.preprocess_u8``) and hands the device only u8; the model input
is then u8/255, the reference's u8 round-trip (``src/process.cpp:36-39``).
"""

from __future__ import annotations

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
