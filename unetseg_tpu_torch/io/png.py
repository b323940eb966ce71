"""PNG I/O without cv2 or PIL, the port of ``unetseg_tpu.io.png``.

The JAX package writes and reads its PNGs through cv2; the card's machine
has neither cv2 nor PIL, so this module encodes and decodes PNGs itself with
the standard library's ``zlib``:

* ``write_png(..., compression=0)`` writes stored deflate, byte-equal to
  ``png_encode`` of ``csrc/emit.cpp`` (the reference writes its PNGs at
  level 0, src/preprocess.cpp:122, src/process.cpp:236): filter None on
  every row, a ``78 01`` zlib header, stored blocks of at most 65,535
  bytes, adler32 and CRC-32, BGR turned to RGB.  ``compression=None`` is
  zlib level 1, cv2's default (the reference's overlay write,
  src/mask2polygon.cpp:126); levels 1-9 are zlib's.  Those decode to the
  same pixels as cv2's files, not to the same bytes.
* ``read_png_gray`` (8- and 16-bit gray, as IMREAD_ANYDEPTH|GRAYSCALE)
  and ``read_png_bgr`` (as IMREAD_COLOR) decode the colour types and row
  filters cv2 and ``csrc/emit.cpp`` write.
* ``draw_contours_overlay`` is ``cv2.drawContours`` at thickness 1: each
  contour a closed polyline of OpenCV's 8-connected lines, clipped to the
  image with OpenCV's ``clipLine``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from unetseg_tpu_torch.metrics import _line_pixels

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_STORED_BLOCK = 65535
# PNG colour type -> samples per pixel (palette images are not read).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _stored_zlib(raw: bytes) -> bytes:
    """A zlib stream of stored deflate blocks, as ``csrc/emit.cpp`` writes
    it: an empty input still gets its one final (empty) block."""
    out = [b"\x78\x01"]
    off = 0
    while True:
        n = min(len(raw) - off, _STORED_BLOCK)
        last = off + n == len(raw)
        out.append(struct.pack("<BHH", int(last), n, n ^ 0xFFFF))
        out.append(raw[off: off + n])
        off += n
        if last:
            break
    out.append(struct.pack(">I", zlib.adler32(raw)))
    return b"".join(out)


def encode_png(img: np.ndarray, compression: Optional[int] = 0) -> bytes:
    """PNG bytes of a (H, W) gray or (H, W, 3) BGR image, uint8 or uint16
    (16-bit samples are written big-endian, as PNG has them)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        colour = 2
        img = img[..., ::-1]  # BGR -> RGB
    else:
        raise ValueError(f"write_png wants (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    if img.dtype == np.uint8:
        depth = 8
    elif img.dtype == np.uint16:
        depth = 16
        img = img.astype(">u2")
    else:
        raise ValueError(f"write_png wants uint8 or uint16, got {img.dtype}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    if compression == 0:
        idat = _stored_zlib(raw)
    else:
        level = 1 if compression is None else int(compression)
        if not 1 <= level <= 9:
            raise ValueError(f"compression must be None or 0-9, got "
                             f"{compression}")
        idat = zlib.compress(raw, level)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, compression=0) -> None:
    """Write ``img`` (gray, or BGR as cv2 holds it) to ``path``.
    ``compression=0`` is byte-equal to ``csrc/emit.cpp``; ``None`` is
    cv2's default level (1)."""
    data = encode_png(img, compression)
    try:
        with open(path, "wb") as f:
            f.write(data)
    except OSError as e:
        raise RuntimeError(f"imwrite failed: {path}") from e


def _unfilter(data: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth)."""
    stride = rowbytes + 1
    buf = np.frombuffer(data, np.uint8)
    if buf.size < h * stride:
        raise ValueError("PNG image data is truncated")
    out = np.empty((h, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    for y in range(h):
        kind = int(buf[y * stride])
        line = buf[y * stride + 1: (y + 1) * stride]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left one
            c = bytearray(line.tobytes())
            p = prev.tobytes()
            for i in range(rowbytes):
                a = c[i - bpp] if i >= bpp else 0
                b = p[i]
                if kind == 3:
                    c[i] = (c[i] + ((a + b) >> 1)) & 0xFF
                    continue
                d = p[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - d), abs(a - d), abs(a + b - 2 * d)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else d)
                c[i] = (c[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(c), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> Tuple[np.ndarray, int]:
    """(pixels, colour type) of non-interlaced 8- or 16-bit gray, gray +
    alpha, RGB or RGBA PNG bytes; pixels (H, W) or (H, W, channels) in the
    file's order (RGB), uint8 or uint16."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + n]
        crc = data[pos + 8 + n: pos + 12 + n]
        if len(body) != n or len(crc) != 4 or \
                struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} is corrupt")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = ihdr
    if colour not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: colour type {colour}, depth "
                         f"{depth}, interlace {interlace}")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    px = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    px = px.reshape(h, w, channels)
    return (px[..., 0] if channels == 1 else px), colour


def _read(path: str) -> Tuple[np.ndarray, int]:
    try:
        with open(path, "rb") as f:
            return decode_png(f.read())
    except (OSError, ValueError, struct.error, zlib.error) as e:
        raise RuntimeError(f"Failed to read image: {path}") from e


def read_png_gray(path: str) -> np.ndarray:
    """An 8- or 16-bit gray PNG as (H, W) uint8 or uint16 (cv2's
    IMREAD_ANYDEPTH|IMREAD_GRAYSCALE on such a file); the alpha of a gray +
    alpha file is dropped."""
    px, colour = _read(path)
    if colour == 4:
        px = px[..., 0]
    elif colour != 0:
        raise RuntimeError(f"Failed to read image: {path} is not a gray PNG")
    return px


def read_png_bgr(path: str) -> np.ndarray:
    """Any PNG :func:`decode_png` reads as (H, W, 3) uint8 BGR (cv2's
    IMREAD_COLOR): gray replicated, alpha dropped, 16-bit samples cut to
    their high byte."""
    px, colour = _read(path)
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    if colour in (0, 4):
        gray = px if colour == 0 else px[..., 0]
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a w x h image: the clipped end points, or
    None when the line misses the image.  Each end is moved in turn, the
    second from the first's new position, with truncated double products,
    as OpenCV does."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _draw_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
              color) -> None:
    """``cv2.line`` at thickness 1, LINE_8: OpenCV's line iterator, the
    line clipped to the image first."""
    h, w = img.shape[:2]
    if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
        clipped = _clip_line(w, h, x0, y0, x1, y1)
        if clipped is None:
            return
        x0, y0, x1, y1 = clipped
    xs, ys = _line_pixels(x0, y0, x1, y1)
    img[ys, xs] = color


def draw_contours_overlay(img_bgr: np.ndarray,
                          contours: Sequence[Sequence[Tuple[int, int]]],
                          color=(0, 0, 255), thickness: int = 1) -> np.ndarray:
    """Red contour overlay in place, parity with src/mask2polygon.cpp:114-129
    (``cv2.drawContours(img, contours, -1, color, 1)``): each contour a
    closed polyline from its last point; a one-point contour is a dot."""
    if thickness != 1:
        raise ValueError(f"only thickness 1 is drawn, got {thickness}")
    color = np.asarray(color, img_bgr.dtype)
    for c in contours:
        pts = [(int(x), int(y)) for x, y in c]
        if not pts:
            continue
        x0, y0 = pts[-1]
        for x1, y1 in pts:
            _draw_line(img_bgr, x0, y0, x1, y1, color)
            x0, y0 = x1, y1
    return img_bgr
