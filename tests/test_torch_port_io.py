"""The port's JSON and PNG writers (``io/jsonfmt.py``, ``io/png.py``)
against the JAX package's and cv2 on the CPU.

* ``jsonfmt``: bytes equal to ``unetseg_tpu.io.jsonfmt``'s and to the
  nlohmann goldens in ``tests/golden/``, for empty, one-point and labeled
  shape sets.
* ``png.write_png(compression=0)``: byte-equal to the PNGs the C++ emitter
  (``native.emit_batch``) writes for the same images, gray and BGR.
* cv2 decodes the port's PNGs to the same pixels, and the port decodes
  cv2's, at compression 0, 1 and 9, 8 and 16 bits (level 9 makes libpng
  pick filters per row, so every filter the reader undoes is met).
* ``draw_contours_overlay``: pixel-equal to ``cv2.drawContours`` at
  thickness 1 on hand cases (a point, a line, the border, polygons outside
  the image, self-intersecting shapes), on seeded random polygons that
  cross the border, and on the traced contours of seeded cleaned masks.
"""

import os

import cv2
import numpy as np
import pytest

from unetseg_tpu.io import jsonfmt as jax_jsonfmt
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.io import jsonfmt, native, png
from unetseg_tpu_torch.ops.decode import mask_to_image_np

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LABELED = [(1, 0, [(10, 12), (30, 12), (30, 40)]),
           (2, 1, [(100, 100), (140, 100), (140, 140), (100, 140)]),
           (2, 1, [(5, 5), (6, 5), (6, 6)])]


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


# -- jsonfmt ------------------------------------------------------------------

@pytest.mark.parametrize("name,make", [
    ("size_golden.json",
     lambda m: m.size_json_bytes("img_001.raw", 2048, 1536)),
    ("contour_golden.json",
     lambda m: m.contour_json_bytes([[(12, 34), (56, 78), (90, 11)],
                                     [(1, 2)]], "img_001", 2048, 1536)),
    ("contour_empty_golden.json",
     lambda m: m.contour_json_bytes([], "img_001", 2048, 1536)),
    ("contour_labeled_golden.json",
     lambda m: m.contour_json_bytes_labeled(
         [(lab, idx, [(int(x * 2.0), int(y * 1.5)) for x, y in c])
          for lab, idx, c in LABELED], "ml", 1024, 768)),
])
def test_jsonfmt_matches_goldens_and_jax(name, make):
    got = make(jsonfmt)
    assert got == _golden(name)
    assert got == make(jax_jsonfmt)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jsonfmt_random_shapes_match_jax(seed):
    rng = np.random.default_rng(seed)
    contours = [[tuple(int(v) for v in p)
                 for p in rng.integers(0, 4000, (rng.integers(1, 9), 2))]
                for _ in range(rng.integers(0, 5))]
    contours.append([(7, 9)])  # a one-point shape
    labeled = [(int(rng.integers(1, 3)), int(rng.integers(0, 2)), c)
               for c in contours]
    for args in ((contours, f"s{seed}", 640, 480),
                 ([], "empty", 1, 1)):
        assert jsonfmt.contour_json_bytes(*args) == \
            jax_jsonfmt.contour_json_bytes(*args)
        assert jsonfmt.contour_json_bytes_labeled(
            labeled if args[0] else [], *args[1:]) == \
            jax_jsonfmt.contour_json_bytes_labeled(
                labeled if args[0] else [], *args[1:])
    obj = {"b": [1, None, {"z": "é", "a": []}], "a": {}}
    assert jsonfmt.dumps_compact(obj) == jax_jsonfmt.dumps_compact(obj)
    assert jsonfmt.dumps_pretty(obj) == jax_jsonfmt.dumps_pretty(obj)
    assert jsonfmt.size_json_bytes("x.raw", 90, 70, 33, 44) == \
        jax_jsonfmt.size_json_bytes("x.raw", 90, 70, 33, 44)


def test_native_json_matches_pure_path():
    """The C++ labeled and plain contour JSONs are the pure path's bytes
    of the truncated scaled points."""
    scaled = [(lab, idx, [(int(x * 2.0), int(y * 1.5)) for x, y in c])
              for lab, idx, c in LABELED]
    assert native.contour_json_bytes_labeled(LABELED, "ml", 1024, 768, 2.0,
                                             1.5) == \
        jsonfmt.contour_json_bytes_labeled(scaled, "ml", 1024, 768)
    assert native.contour_json_bytes_labeled([], "e", 64, 64, 1.0, 1.0) == \
        jsonfmt.contour_json_bytes_labeled([], "e", 64, 64)
    plain = [c for _, _, c in LABELED]
    assert native.contour_json_bytes(plain, "p", 1024, 768, 2.0, 1.5) == \
        jsonfmt.contour_json_bytes([c for _, _, c in scaled], "p", 1024, 768)


# -- PNG ------------------------------------------------------------------------

def _image(rng, shape, dtype):
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)


@pytest.mark.parametrize("size", [(64, 64), (37, 53), (300, 260)])
def test_stored_png_equals_cpp_emitter(tmp_path, size):
    """The normalized (gray), mask (gray LUT) and overlay (BGR) PNGs of
    ``native.emit_batch`` are ``write_png(compression=0)`` of the same
    pixels, byte for byte (300 x 260 x 3 spans several stored blocks)."""
    h, w = size
    raw = synth_slice(np.random.default_rng(sum(size)), 512)[0]
    u8 = np.ascontiguousarray(native.preprocess_u8(raw, max(h, w))[:h, :w])
    mask = native.postprocess_batch(np.where(u8 > 120, 2, 0).astype(np.uint8))
    counts = native.emit_batch(u8[None], mask[None], [str(tmp_path)], ["s"],
                               ["s.raw"], 2 * w, 2 * h, native.TIER_FULL)
    assert counts[0] > 0
    vis = mask_to_image_np(mask)
    for name, img in (("s_normalized.png", u8), ("s_mask.png", vis)):
        png.write_png(str(tmp_path / "port.png"), img, compression=0)
        assert (tmp_path / "port.png").read_bytes() == \
            (tmp_path / name).read_bytes(), name
    overlay = png.read_png_bgr(str(tmp_path / "s_normalized.png"))
    png.draw_contours_overlay(overlay, native.extract_contours(vis))
    png.write_png(str(tmp_path / "port.png"), overlay, compression=0)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "s_contour_overlay.png").read_bytes()


@pytest.mark.parametrize("shape,dtype", [
    ((37, 53), np.uint8), ((37, 53, 3), np.uint8), ((20, 31), np.uint16),
    ((20, 31, 3), np.uint16), ((1, 1), np.uint8), ((130, 600), np.uint8)])
@pytest.mark.parametrize("compression", [0, 1, 9, None])
def test_png_round_trips_through_cv2(tmp_path, shape, dtype, compression):
    img = _image(np.random.default_rng(len(shape) + shape[0]), shape, dtype)
    img[: shape[0] // 2] //= 7  # runs and repeats, so filters differ by row
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv2.png")
    png.write_png(ours, img, compression)
    np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(png.read_png_bgr(ours), cv2.imread(ours))
    cv2.imwrite(theirs, img, [] if compression is None else
                [cv2.IMWRITE_PNG_COMPRESSION, compression])
    np.testing.assert_array_equal(png.read_png_bgr(theirs),
                                  cv2.imread(theirs))
    if img.ndim == 2:
        got = png.read_png_gray(theirs)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, cv2.imread(
            theirs, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(png.read_png_gray(ours), img)


def test_png_read_errors(tmp_path):
    with pytest.raises(RuntimeError, match="Failed to read image"):
        png.read_png_gray(str(tmp_path / "missing.png"))
    bad = tmp_path / "bad.png"
    png.write_png(str(bad), np.zeros((4, 4), np.uint8))
    data = bytearray(bad.read_bytes())
    data[40] ^= 0xFF  # inside IDAT: its CRC no longer holds
    bad.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="Failed to read image"):
        png.read_png_bgr(str(bad))
    color = tmp_path / "color.png"
    png.write_png(str(color), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match="not a gray PNG"):
        png.read_png_gray(str(color))
    with pytest.raises(ValueError):
        png.write_png(str(color), np.zeros((4, 4), np.float32))


# -- contour overlay --------------------------------------------------------------

HAND_CASES = {
    "point": [[(5, 7)]],
    "two_points": [[(2, 3), (17, 9)]],
    "steep_line": [[(3, 1), (5, 18)]],
    "border": [[(0, 0), (19, 0), (19, 14), (0, 14)]],
    "corner_points": [[(0, 0)], [(19, 14)], [(19, 0)], [(0, 14)]],
    "outside_left": [[(-10, 3), (-2, 9), (-5, 12)]],
    "outside_crossing": [[(-10, -10), (40, 30), (-5, 25)]],
    "far_outside": [[(-1000, -2000), (3000, 500), (50, 4000)]],
    "through_corners": [[(-5, -5), (25, 19)], [(25, -3), (-4, 30)]],
    "bow_tie": [[(2, 2), (17, 12), (17, 2), (2, 12)]],
    "star": [[(10, 0), (13, 14), (0, 5), (19, 5), (6, 14)]],
    "repeated": [[(4, 4), (4, 4), (9, 4), (9, 4), (4, 4)]],
    "empty_and_one": [[], [(8, 8), (12, 3)]],
}


@pytest.mark.parametrize("name", sorted(HAND_CASES))
def test_overlay_hand_cases_match_cv2(name):
    contours = HAND_CASES[name]
    img = np.random.default_rng(0).integers(0, 256, (15, 20, 3), np.uint8)
    want = img.copy()
    cv2.drawContours(want, [np.asarray(c, np.int32).reshape(-1, 1, 2)
                            for c in contours if c], -1, (0, 0, 255), 1)
    got = png.draw_contours_overlay(img, contours)
    assert got is img
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_overlay_random_polygons_match_cv2(seed):
    """Polygons with vertices up to 60 pixels outside every border, on
    images down to 1 x 1."""
    rng = np.random.default_rng(seed)
    for _ in range(400):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        contours = [rng.integers(-60, 100, (int(rng.integers(1, 7)), 2))
                    for _ in range(int(rng.integers(1, 4)))]
        want = np.zeros((h, w, 3), np.uint8)
        cv2.drawContours(want, [c.reshape(-1, 1, 2).astype(np.int32)
                                for c in contours], -1, (0, 0, 255), 1)
        got = png.draw_contours_overlay(np.zeros((h, w, 3), np.uint8),
                                        [c.tolist() for c in contours])
        np.testing.assert_array_equal(got, want, err_msg=str(
            (h, w, [c.tolist() for c in contours])))


@pytest.mark.parametrize("seed", [1, 2])
def test_overlay_traced_contours_match_cv2(seed):
    """The overlay of the engine's artifacts: contours traced from seeded
    cleaned masks, drawn on the normalized image."""
    raw = synth_slice(np.random.default_rng(seed), 512)[0]
    u8 = native.preprocess_u8(raw, 512)
    mask = native.postprocess_batch(
        np.digitize(u8, [90, 160]).astype(np.uint8))
    contours = native.extract_contours(mask_to_image_np(mask))
    assert contours
    base = np.repeat(u8[..., None], 3, axis=2)
    want = base.copy()
    cv2.drawContours(want, [np.asarray(c, np.int32).reshape(-1, 1, 2)
                            for c in contours], -1, (0, 0, 255), 1)
    np.testing.assert_array_equal(
        png.draw_contours_overlay(base.copy(), contours), want)
