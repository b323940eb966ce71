"""Reference-shaped API surface, the port of ``unetseg_tpu.compat``.

Callers of the C++ reference call these functions (SURVEY §1); each keeps
the reference's signature so a caller can switch without re-plumbing:

  MedicalSeg::initialize_engine / get_engine / get_log_file / get_log_path /
  process_single_image / cleanup_resources          (include/initialize.h,
                                                     process.h, cleanup.h)
  Preprocess::preprocess_raw                        (include/preprocess.h)
  Mask2Polygon::load_size_json / extract_contours / generate_json /
  create_overlay_image / process_single_mask        (include/mask2polygon.h)
  postprocess_mask, mask_to_image                   (src/postprocess.cpp,
                                                     src/process.cpp:178)

The engine functions are the port's (``device="cuda"`` by default); PNGs
are written and read by ``io/png.py``, JSONs by the C++ library
(``io/native.py``) and ``io/jsonfmt.py``.
"""

from __future__ import annotations

import json as _json
import os
from typing import List, Tuple

import numpy as np

from unetseg_tpu_torch.engine import (  # noqa: F401  (re-exported API)
    cleanup_resources,
    get_engine,
    initialize_engine,
    process_single_image,
)
from unetseg_tpu_torch.io import jsonfmt, native, png, raw as raw_io
from unetseg_tpu_torch.ops.decode import mask_to_image_np
from unetseg_tpu_torch.utils.logger import GLOBAL_LOG

Point = Tuple[int, int]


def get_log_file():
    """Parity with MedicalSeg::get_log_file (include/initialize.h:16)."""
    return GLOBAL_LOG


def get_log_path() -> str:
    """Parity with MedicalSeg::get_log_path (include/initialize.h:18)."""
    return GLOBAL_LOG.path or ""


def preprocess_raw(raw_path: str, png_path: str, json_path: str,
                   w: int, h: int) -> bool:
    """RAW -> min/max -> bilinear 512² + u8 -> PNG + size JSON: the
    bit-exact host path, with the artifacts and booleans of
    src/preprocess.cpp:76-141."""
    try:
        raw = raw_io.read_raw(raw_path, w, h)
        u8 = native.preprocess_u8(np.asarray(raw), 512)
        for p in (png_path, json_path):  # the two may live in other dirs
            parent = os.path.dirname(p)
            if parent:
                os.makedirs(parent, exist_ok=True)
        png.write_png(png_path, u8, compression=0)
        with open(json_path, "wb") as f:
            f.write(native.size_json_bytes(
                os.path.basename(raw_path), w, h, 512, 512))
        return True
    except Exception as e:
        print(f"preprocess_raw error: {e}")
        return False


def postprocess_mask(mask: np.ndarray) -> np.ndarray:
    """Hole fill -> 3x3 open -> area filter -> {0, 2} (host C++ path)."""
    return native.postprocess_batch(np.asarray(mask, np.uint8))


def mask_to_image(mask: np.ndarray) -> np.ndarray:
    """LUT 0->0, 1->128, 2->255."""
    return mask_to_image_np(mask)


def load_size_json(json_path: str) -> dict:
    with open(json_path) as f:
        return _json.load(f)


def extract_contours(mask: np.ndarray) -> List[List[Point]]:
    """threshold >127 -> findContours(EXTERNAL, SIMPLE) parity."""
    return native.extract_contours(np.asarray(mask, np.uint8))


def generate_json(contours: List[List[Point]], json_path: str,
                  base_name: str, original_width: int,
                  original_height: int) -> None:
    """labelme-style JSON, nlohmann setw(4) bytes (src/mask2polygon.cpp:68)."""
    with open(json_path, "wb") as f:
        f.write(jsonfmt.contour_json_bytes(
            contours, base_name, original_width, original_height))


def create_overlay_image(contours: List[List[Point]],
                         original_png_path: str, overlay_path: str) -> None:
    img = png.read_png_bgr(original_png_path)
    png.draw_contours_overlay(img, contours)
    png.write_png(overlay_path, img, compression=None)


def process_single_mask(mask_path: str, output_dir: str, json_path: str,
                        original_png: str, base_name: str) -> None:
    """The polygonizer of src/mask2polygon.cpp:134-222: the {base}.raw /
    {base}.tif size-key lookup, the mask-size check, the warning and skip
    on an empty contour set, and every error printed, not raised."""
    try:
        print(f"Processing Mask: {base_name}.png")
        sizes = load_size_json(json_path)
        if base_name + ".raw" in sizes:
            key = base_name + ".raw"
        elif base_name + ".tif" in sizes:
            key = base_name + ".tif"
        else:
            raise RuntimeError(
                f"Cannot Find Size Info in JSON: {base_name}.raw/.tif")
        info = sizes[key]
        ow, oh = info["original_width"], info["original_height"]
        sw, sh = info["scaled_width"], info["scaled_height"]
        print(f"Original Size: {ow}x{oh}")
        print(f"Scaled Size: {sw}x{sh}")

        mask = png.read_png_gray(mask_path)
        if mask.dtype == np.uint16:
            # the reference reads with plain IMREAD_GRAYSCALE
            # (src/mask2polygon.cpp:166): a 16-bit PNG keeps its high byte
            # before the threshold at 127
            mask = (mask >> 8).astype(np.uint8)
        if mask.shape[1] != sw or mask.shape[0] != sh:
            raise RuntimeError(
                f"Mask size mismatch: {mask.shape[1]}x{mask.shape[0]} "
                f"(actual) vs {sw}x{sh} (JSON)")

        contours = extract_contours(mask)
        if not contours:
            print("Warning: No Contours Detected")
            return
        print(f"Extracted {len(contours)} Contours")

        if original_png:
            overlay_path = os.path.join(
                output_dir, base_name + "_contour_overlay.png")
            create_overlay_image(contours, original_png, overlay_path)
            print(f"Overlay Image Saved to: {overlay_path}")
        else:
            print("Warning: Original PNG not provided, skipping overlay "
                  "generation")

        out_json = os.path.join(output_dir, base_name + ".json")
        with open(out_json, "wb") as f:
            f.write(native.contour_json_bytes(
                contours, base_name, ow, oh, ow / sw, oh / sh))
        print(f"JSON Saved to: {out_json}")
    except Exception as e:
        print(f"Processing Failure: {e}")
