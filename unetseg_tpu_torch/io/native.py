"""ctypes binding to the repo's host C++ library (``csrc/contour.cpp`` and
``csrc/emit.cpp``): bit-exact preprocess, mask cleanup, contour tracing,
JSON bytes and the batched artifact emitter.

The sources are compiled, not edited, with the ``csrc/Makefile`` compiler
line into the port's own build directory (``unetseg_tpu_torch/_build``).
There is no fallback: if the library cannot be built or loaded, every entry
point raises.  All artifacts (PNG and JSON) come from this library, so the
port needs neither cv2 nor PIL.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Sequence, Tuple

import numpy as np

from unetseg_tpu_torch._build import build_shared

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_SOURCES = [os.path.join(_CSRC, "contour.cpp"), os.path.join(_CSRC, "emit.cpp")]
# The compiler line of csrc/Makefile.
_CXX = ["g++", "-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared"]

_lock = threading.Lock()
_lib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)

# Artifact tier bits of csrc/unetseg_host.h (UTPU_EMIT_*).
TIER_SIZE_JSON = 1
TIER_CONTOUR_JSON = 2
TIER_MASK_PNG = 4
TIER_NORM_PNG = 8
TIER_OVERLAY_PNG = 16
TIER_FULL = 31
TIER_MASK_JSON = TIER_SIZE_JSON | TIER_CONTOUR_JSON | TIER_MASK_PNG
TIER_JSON = TIER_SIZE_JSON | TIER_CONTOUR_JSON


def load() -> ctypes.CDLL:
    """The host library, built on first use.  Raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_shared("libunetseg_host", _CXX, _SOURCES))
        lib.utpu_extract_contours.restype = ctypes.c_int
        lib.utpu_extract_contours.argtypes = [
            _u8p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_i32p),
            ctypes.POINTER(_i32p), _i32p]
        lib.utpu_free.restype = None
        lib.utpu_free.argtypes = [ctypes.c_void_p]
        lib.utpu_preprocess.restype = None
        lib.utpu_preprocess.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _u8p]
        lib.utpu_contour_json.restype = ctypes.c_void_p
        lib.utpu_contour_json.argtypes = [
            _i32p, _i32p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.utpu_size_json.restype = ctypes.c_void_p
        lib.utpu_size_json.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)]
        lib.utpu_postprocess_batch.restype = None
        lib.utpu_postprocess_batch.argtypes = [
            _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p]
        lib.utpu_postprocess_packed_batch.restype = None
        lib.utpu_postprocess_packed_batch.argtypes = [
            _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p]
        lib.utpu_emit_batch.restype = ctypes.c_int
        lib.utpu_emit_batch.argtypes = [
            _u8p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _i32p]
        _lib = lib
        return _lib


def _take_bytes(lib, ptr, out_len, what: str) -> bytes:
    if not ptr:
        raise MemoryError(f"{what} failed")
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.utpu_free(ptr)


def preprocess_u8(raw: np.ndarray, out_size: int = 512) -> np.ndarray:
    """Bit-exact reference preprocess: (h, w) uint16 -> (out, out) uint8
    (min-max, truncating bilinear resample, quantize)."""
    lib = load()
    raw = np.ascontiguousarray(raw, dtype=np.uint16)
    if raw.ndim != 2:
        raise ValueError(f"preprocess_u8 wants (h, w), got {raw.shape}")
    h, w = raw.shape
    out = np.empty((out_size, out_size), np.uint8)
    lib.utpu_preprocess(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                        h, w, out_size, out.ctypes.data_as(_u8p))
    return out


def postprocess_batch(masks: np.ndarray) -> np.ndarray:
    """Host mask cleanup with the reference's postprocess.cpp semantics
    (hole fill, 3x3 open, components below 6% dropped): (N, H, W) or (H, W)
    class masks -> same shape in {0, 2}."""
    lib = load()
    squeeze = masks.ndim == 2
    m = np.ascontiguousarray(masks[None] if squeeze else masks, dtype=np.uint8)
    n, h, w = m.shape
    out = np.empty_like(m)
    lib.utpu_postprocess_batch(m.ctypes.data_as(_u8p), n, h, w,
                               out.ctypes.data_as(_u8p))
    return out[0] if squeeze else out


def postprocess_packed_batch(packed: np.ndarray, width: int) -> np.ndarray:
    """:func:`postprocess_batch` of 2-bit-packed class masks (n, h, w/4),
    pixel 0 in the low bits of each byte, with the unpack fused into the
    C++ cleanup -> (n, h, w) in {0, 2}."""
    lib = load()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    n, h, w4 = packed.shape
    if w4 * 4 != width:
        raise ValueError(f"packed width {w4} x 4 is not {width}")
    out = np.empty((n, h, width), np.uint8)
    lib.utpu_postprocess_packed_batch(packed.ctypes.data_as(_u8p), n, h,
                                      width, out.ctypes.data_as(_u8p))
    return out


def extract_contours(mask: np.ndarray) -> List[List[Tuple[int, int]]]:
    """findContours(EXTERNAL, SIMPLE) of a 0/128/255 mask (threshold >127)."""
    lib = load()
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = mask.shape
    points, offsets = _i32p(), _i32p()
    n_points = ctypes.c_int32()
    n = lib.utpu_extract_contours(mask.ctypes.data_as(_u8p), h, w,
                                  ctypes.byref(points), ctypes.byref(offsets),
                                  ctypes.byref(n_points))
    if n < 0:
        raise MemoryError("utpu_extract_contours failed")
    try:
        pts = np.ctypeslib.as_array(points, shape=(max(n_points.value, 1), 2))
        offs = np.ctypeslib.as_array(offsets, shape=(n + 1,))
        return [[(int(x), int(y)) for x, y in pts[offs[c]: offs[c + 1]]]
                for c in range(n)]
    finally:
        lib.utpu_free(points)
        lib.utpu_free(offsets)


def scaled_polygons(mask_vis: np.ndarray, orig_w: int,
                    orig_h: int) -> List[List[Tuple[int, int]]]:
    """The polygons the engine writes into ``{base}.json``: contours of a
    0/128/255 mask scaled to the original resolution with the reference's
    truncating int cast (src/mask2polygon.cpp:41-63)."""
    sy = orig_h / mask_vis.shape[0]
    sx = orig_w / mask_vis.shape[1]
    return [[(int(x * sx), int(y * sy)) for x, y in c]
            for c in extract_contours(mask_vis)]


def contour_json_bytes(contours: List[List[Tuple[int, int]]], base_name: str,
                       orig_w: int, orig_h: int, scale_x: float,
                       scale_y: float) -> bytes:
    """labelme-style contour JSON with the reference's truncating point
    scaling (src/mask2polygon.cpp:41-63)."""
    lib = load()
    flat = [p for c in contours for p in c]
    offsets = np.cumsum([0] + [len(c) for c in contours]).astype(np.int32)
    pts = np.ascontiguousarray(np.asarray(flat, np.int32).reshape(-1, 2))
    out_len = ctypes.c_size_t()
    ptr = lib.utpu_contour_json(
        pts.ctypes.data_as(_i32p), offsets.ctypes.data_as(_i32p),
        len(contours), base_name.encode(), orig_w, orig_h, scale_x, scale_y,
        ctypes.byref(out_len))
    return _take_bytes(lib, ptr, out_len, "utpu_contour_json")


def size_json_bytes(filename: str, orig_w: int, orig_h: int,
                    scaled_w: int = 512, scaled_h: int = 512) -> bytes:
    """``{base}_original_sizes.json`` bytes."""
    lib = load()
    out_len = ctypes.c_size_t()
    ptr = lib.utpu_size_json(filename.encode(), orig_w, orig_h, scaled_w,
                             scaled_h, ctypes.byref(out_len))
    return _take_bytes(lib, ptr, out_len, "utpu_size_json")


def emit_slice_available() -> bool:
    """Whether the artifact emitter can run: the library builds and loads.
    (:func:`load` raises with the compiler's output where it cannot.)"""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


def emit_batch(norm_u8: np.ndarray, clean_masks: np.ndarray,
               out_dirs: Sequence[str], base_names: Sequence[str],
               src_filenames: Sequence[str], orig_w: int, orig_h: int,
               tier: int = TIER_FULL) -> np.ndarray:
    """Write a batch of slices' artifacts in one C call (OpenMP over slices).

    ``norm_u8`` and ``clean_masks`` are (n, h, w) uint8; masks hold class ids
    and the 0/128/255 LUT is applied natively.  Returns each slice's contour
    count, -1 where that slice's I/O failed.
    """
    lib = load()
    norm_u8 = np.ascontiguousarray(norm_u8, dtype=np.uint8)
    clean_masks = np.ascontiguousarray(clean_masks, dtype=np.uint8)
    n, h, w = norm_u8.shape
    if clean_masks.shape != (n, h, w) or not (
            len(out_dirs) == len(base_names) == len(src_filenames) == n):
        raise ValueError("emit_batch: slices, masks and names disagree")

    def as_charpp(strs):
        arr = (ctypes.c_char_p * n)()
        arr[:] = [s.encode() for s in strs]
        return arr

    counts = np.empty(n, np.int32)
    lib.utpu_emit_batch(
        norm_u8.ctypes.data_as(_u8p), clean_masks.ctypes.data_as(_u8p),
        n, h, w, as_charpp(out_dirs), as_charpp(base_names),
        as_charpp(src_filenames), orig_w, orig_h, tier,
        counts.ctypes.data_as(_i32p))
    return counts
