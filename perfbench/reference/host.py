"""The host stages of the served path, written plainly: the preprocess of
the reference service (``csrc/contour.cpp::utpu_preprocess``: global
min-max, truncating bilinear resample, quantize to u8, in float64), the
mask cleanup (hole fill, 3x3 open, 8-connected components below 6% of the
image dropped; OpenCV's semantics on ``scipy.ndimage``, after the port's
``reference_twin.twin_postprocess``), the scaled contour polygons, and
readers for the files the program writes (its checkpoints and contour
JSON), so that the benchmark judges them without the program."""

from __future__ import annotations

import json
import struct
from typing import Any, List, Tuple

import numpy as np

from perfbench.reference import contours


# --------------------------------------------------------------- preprocess

def preprocess_u8(raw: np.ndarray, out_size: int,
                  dtype=np.float64) -> np.ndarray:
    """(h, w) uint16 -> (out, out) uint8, the C++ arithmetic in float64
    (``dtype``: the same formula in another precision, the control)."""
    raw = np.asarray(raw, np.uint16)
    h, w = raw.shape
    mn = int(raw.min())
    mx = int(raw.max())
    if mn == mx:
        mx = mn + 1
    f = np.dtype(dtype).type
    scale8 = f(255.0) / f(mx - mn)
    mn = f(mn)
    r = raw.astype(dtype)
    if h == out_size and w == out_size:
        v = r
    else:
        fy = np.arange(out_size, dtype=np.float64) * (h / out_size)
        fx = np.arange(out_size, dtype=np.float64) * (w / out_size)
        iy = fy.astype(np.int64)
        ix = fx.astype(np.int64)
        iy1 = np.minimum(iy + 1, h - 1)
        ix1 = np.minimum(ix + 1, w - 1)
        dy = (fy - iy).astype(dtype)[:, None]
        dx = (fx - ix).astype(dtype)[None, :]
        one = f(1)
        v00 = r[iy][:, ix]
        v01 = r[iy][:, ix1]
        v10 = r[iy1][:, ix]
        v11 = r[iy1][:, ix1]
        v = ((one - dx) * (one - dy) * v00 + dx * (one - dy) * v01
             + (one - dx) * dy * v10 + dx * dy * v11)
    q = (v - mn) * scale8 + f(0.5)
    return np.clip(q, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ cleanup

def _min_area(w: int, h: int) -> int:
    return int(np.float32(w * h) * np.float32(0.06))


def _components(fg: np.ndarray):
    from scipy import ndimage

    labels, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    areas = np.bincount(labels.ravel(), minlength=n + 1)
    return labels, n, areas, ndimage.find_objects(labels)


def _open3x3(fg: np.ndarray) -> np.ndarray:
    """3x3 rect open with OpenCV's default border (the erosion sees
    foreground outside the image, the dilation background)."""
    from scipy import ndimage

    k = np.ones((3, 3), bool)
    eroded = ndimage.binary_erosion(fg, structure=k, border_value=1)
    return ndimage.binary_dilation(eroded, structure=k, border_value=0)


def cleanup(mask: np.ndarray) -> np.ndarray:
    """A class mask -> the cleaned mask in {0, 2}."""
    m = np.array(mask, np.uint8)
    h, w = m.shape
    min_area = _min_area(w, h)
    labels, n, areas, boxes = _components(m != 2)
    fill = np.zeros(n + 1, bool)
    for i in range(1, n + 1):
        rows, cols = boxes[i - 1]
        fill[i] = (cols.start > 0 and rows.start > 0 and cols.stop - 1 < w - 1
                   and rows.stop - 1 < h - 1 and areas[i] < min_area)
    m[fill[labels]] = 2
    labels, n, areas, _ = _components(_open3x3(m == 2))
    keep = areas >= min_area
    keep[0] = False
    return np.where(keep[labels], 2, 0).astype(np.uint8)


def polygons(clean: np.ndarray, orig_w: int, orig_h: int
             ) -> List[List[Tuple[int, int]]]:
    """The contour JSON's polygons of a cleaned mask: external contours of
    the foreground, scaled to the original size with a truncating cast."""
    vis = np.where(clean == 2, 255, 0).astype(np.uint8)
    h, w = vis.shape
    return contours.map_contour_points(contours.extract_contours(vis),
                                       orig_w / w, orig_h / h)


# ---------------------------------------------------------------- the files

def json_polygons(path: str) -> List[List[Tuple[int, int]]]:
    with open(path, "rb") as f:
        doc = json.loads(f.read())
    return [[(int(x), int(y)) for x, y in s["points"]]
            for s in doc["shapes"]]


# A reader of the msgpack subset of the repository's checkpoints:
# ``UTPUCKPT1\n`` then one map {"config": ..., "params": tree}, arrays as
# ext type 1 holding a packed (shape, dtype name, bytes) tuple.
_MAGIC = b"UTPUCKPT1\n"


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos: self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        if t in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[t]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"),
                 0xC6: (">I", "bin"), 0xC7: (">B", "ext"),
                 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"),
                 0xDB: (">I", "str"), 0xDC: (">H", "array"),
                 0xDD: (">I", "array"), 0xDE: (">H", "map"),
                 0xDF: (">I", "map")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code != 1:
            raise ValueError(f"unsupported msgpack ext type {code}")
        r = _Reader(data)
        shape, dtype_name, raw = r.value()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        return np.frombuffer(raw, np.dtype(dtype_name)).reshape(shape).copy()


def read_checkpoint(path: str) -> Tuple[dict, dict]:
    """(params tree of numpy arrays, config dict) of a checkpoint file."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path} is not a checkpoint")
        data = _Reader(f.read()).value()
    return data["params"], dict(data["config"])
