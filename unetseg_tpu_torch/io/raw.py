"""Headerless 16-bit RAW image I/O, a copy of ``unetseg_tpu.io.raw``.

The reference mmaps the RAW file and reinterprets it as uint16 with no header
parse and no byte-swapping (``src/preprocess.cpp:28-61,86``): platform
(little-endian) order, row-major (h, w).  DICOM/TIFF extensions are only
recognised (``src/main.cpp:18-25``) and then read as raw pixels too.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

# Extensions the reference treats as 16-bit images (src/main.cpp:18-25).
EXTENSIONS = (".raw", ".dcm", ".tif", ".tiff")


def is_16bit_image(path: str) -> bool:
    """Extension filter; parity with src/main.cpp:18-25 (case-insensitive)."""
    _, ext = os.path.splitext(path)
    return ext.lower() in EXTENSIONS


def find_16bit_images(dir_path: str, recursive: bool) -> List[str]:
    """Directory walker; parity with src/main.cpp:28-48 (regular files only,
    filesystem iteration order)."""
    result: List[str] = []
    if recursive:
        for root, _dirs, files in os.walk(dir_path):
            for name in files:
                p = os.path.join(root, name)
                if is_16bit_image(p):
                    result.append(p)
    else:
        try:
            with os.scandir(dir_path) as it:
                for entry in it:
                    if entry.is_file() and is_16bit_image(entry.path):
                        result.append(entry.path)
        except OSError as e:  # parity: reference logs and returns empty
            print(f"Directory error: {e}")
    return result


def read_raw(path: str, width: int, height: int) -> np.ndarray:
    """mmap a headerless RAW as (height, width) uint16, zero-copy.

    Raises if the file is smaller than width*height*2 bytes (the reference
    would fault on access instead).
    """
    nbytes = width * height * 2
    actual = os.path.getsize(path)
    if actual < nbytes:
        raise ValueError(
            f"RAW file too small: {path} has {actual} bytes, need {nbytes} "
            f"for {width}x{height} uint16"
        )
    return np.memmap(path, dtype=np.uint16, mode="r", shape=(height, width))


def read_raw_into(path: str, width: int, height: int,
                  out: np.ndarray) -> None:
    """Read a headerless RAW into ``out``, a C-contiguous (height, width)
    uint16 array: the bytes :func:`read_raw` maps, read by the file system
    straight into place (no mapping, no page faults of a first touch).

    Raises as :func:`read_raw` does if the file is too small."""
    if out.shape != (height, width) or out.dtype != np.uint16 \
            or not out.flags.c_contiguous:
        raise ValueError(f"read_raw_into wants a C-contiguous ({height}, "
                         f"{width}) uint16 array, got {out.dtype} "
                         f"{out.shape}")
    nbytes = width * height * 2
    view = memoryview(out).cast("B")
    with open(path, "rb", buffering=0) as f:
        actual = os.fstat(f.fileno()).st_size
        if actual < nbytes:
            raise ValueError(
                f"RAW file too small: {path} has {actual} bytes, need "
                f"{nbytes} for {width}x{height} uint16")
        done = 0
        while done < nbytes:
            n = f.readinto(view[done:])
            if not n:
                raise EOFError(f"{path} ended after {done} of {nbytes} "
                               "bytes")
            done += n


def write_raw(path: str, img: np.ndarray) -> None:
    """Write a (h, w) uint16 array as headerless RAW."""
    img = np.ascontiguousarray(img, dtype=np.uint16)
    with open(path, "wb") as f:
        f.write(img.tobytes())
