"""The port's reference-shaped API (``unetseg_tpu_torch.compat``) against
``unetseg_tpu.compat`` on the CPU, the cases of ``tests/test_compat.py``.

JSONs must be byte-equal to JAX's; PNGs pixel-equal (JAX writes through
cv2, the port through ``io/png.py``), the stored ones byte-equal to the C++
emitter's.  Printed messages must match JAX's.
"""

import cv2
import numpy as np
import pytest

from test_torch_port_native_ready import jax_native  # noqa: F401 (fixture)
from unetseg_tpu import compat as jax_compat
from unetseg_tpu.io import jsonfmt as jax_jsonfmt
from unetseg_tpu_torch import compat, engine
from unetseg_tpu_torch.io import jsonfmt, native, png, raw as raw_io
from unetseg_tpu_torch.ops.preprocess import preprocess_oracle_u8


@pytest.mark.parametrize("shape", [(60, 90), (70, 90), (512, 512)])
def test_preprocess_raw_matches_jax(tmp_path, jax_native, shape):
    h, w = shape
    img = np.random.default_rng(h).integers(0, 65536, shape, dtype=np.uint16)
    raw_io.write_raw(str(tmp_path / "a.raw"), img)
    outs = {}
    for name, mod in (("jax", jax_compat), ("port", compat)):
        d = tmp_path / name / "sub"
        assert mod.preprocess_raw(str(tmp_path / "a.raw"), str(d / "a.png"),
                                  str(tmp_path / name / "j" / "a.json"), w, h)
        outs[name] = (d / "a.png", tmp_path / name / "j" / "a.json")
    jpng, jjson = outs["jax"]
    ppng, pjson = outs["port"]
    assert pjson.read_bytes() == jjson.read_bytes() == \
        jax_jsonfmt.size_json_bytes("a.raw", w, h, 512, 512)
    got = cv2.imread(str(ppng), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(got, cv2.imread(str(jpng),
                                                  cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(got, preprocess_oracle_u8(img, 512))
    np.testing.assert_array_equal(png.read_png_gray(str(ppng)), got)
    # the stored PNG is the C++ emitter's normalized PNG, byte for byte
    u8 = native.preprocess_u8(img, 512)
    mask = np.zeros_like(u8)
    native.emit_batch(u8[None], mask[None], [str(tmp_path)], ["e"], ["e.raw"],
                      w, h, native.TIER_FULL)
    assert ppng.read_bytes() == (tmp_path / "e_normalized.png").read_bytes()


def test_preprocess_raw_missing_file(tmp_path, capsys):
    args = (str(tmp_path / "nope.raw"), str(tmp_path / "x.png"),
            str(tmp_path / "x.json"), 10, 10)
    assert not compat.preprocess_raw(*args)
    port = capsys.readouterr().out
    assert not jax_compat.preprocess_raw(*args)
    assert port == capsys.readouterr().out
    assert "preprocess_raw error" in port


def _mask_case(tmp_path, tag, sizes_json, mask, norm):
    cv2.imwrite(str(tmp_path / f"{tag}_mask.png"), mask)
    with open(tmp_path / f"{tag}_sizes.json", "wb") as f:
        f.write(sizes_json)
    if norm is not None:
        cv2.imwrite(str(tmp_path / f"{tag}_norm.png"), norm)


@pytest.mark.parametrize("key", [".raw", ".tif"])
@pytest.mark.parametrize("depth", [8, 16])
def test_process_single_mask_full_chain(tmp_path, capsys, jax_native, key,
                                        depth):
    mask = np.zeros((64, 64), np.uint8)
    cv2.circle(mask, (32, 32), 20, 255, -1)
    cv2.rectangle(mask, (2, 2), (10, 60), 255, -1)
    if depth == 16:
        mask = mask.astype(np.uint16) * 257
    norm = np.random.default_rng(0).integers(0, 256, (64, 64), np.uint8)
    _mask_case(tmp_path, "b", jsonfmt.size_json_bytes("b" + key, 128, 256,
                                                      64, 64), mask, norm)
    outs = {}
    for name, mod in (("jax", jax_compat), ("port", compat)):
        d = tmp_path / name
        d.mkdir()
        mod.process_single_mask(str(tmp_path / "b_mask.png"), str(d),
                                str(tmp_path / "b_sizes.json"),
                                str(tmp_path / "b_norm.png"), "b")
        outs[name] = capsys.readouterr().out.replace(str(d), "OUT")
    assert outs["port"] == outs["jax"]
    assert "Extracted 2 Contours" in outs["port"]
    jd, pd = tmp_path / "jax", tmp_path / "port"
    assert (pd / "b.json").read_bytes() == (jd / "b.json").read_bytes()
    np.testing.assert_array_equal(
        cv2.imread(str(pd / "b_contour_overlay.png"), cv2.IMREAD_UNCHANGED),
        cv2.imread(str(jd / "b_contour_overlay.png"), cv2.IMREAD_UNCHANGED))


def test_process_single_mask_messages(tmp_path, capsys, jax_native):
    """The size mismatch, a missing size key, a missing mask, an empty mask
    and a missing original PNG print what JAX prints."""
    _mask_case(tmp_path, "c", jsonfmt.size_json_bytes("c.raw", 100, 100,
                                                      64, 64),
               np.zeros((32, 32), np.uint8), None)
    _mask_case(tmp_path, "e", jsonfmt.size_json_bytes("e.raw", 100, 100,
                                                      32, 32),
               np.zeros((32, 32), np.uint8), None)
    blob = np.zeros((32, 32), np.uint8)
    blob[4:20, 6:28] = 255
    _mask_case(tmp_path, "f", jsonfmt.size_json_bytes("f.raw", 64, 64,
                                                      32, 32), blob, None)
    cases = [("c", "c_mask.png", "c_sizes.json"),   # mismatch
             ("x", "c_mask.png", "c_sizes.json"),   # no size key for x
             ("e", "nope.png", "e_sizes.json"),     # missing mask
             ("e", "e_mask.png", "e_sizes.json"),   # no contours
             ("f", "f_mask.png", "f_sizes.json")]   # no original PNG
    for base, mask, sizes in cases:
        printed = []
        for mod in (jax_compat, compat):
            mod.process_single_mask(str(tmp_path / mask), str(tmp_path),
                                    str(tmp_path / sizes), "", base)
            printed.append(capsys.readouterr().out)
        assert printed[0] == printed[1], (base, mask)
    assert (tmp_path / "f.json").exists()


def test_size_mismatch_message(tmp_path, capsys):
    _mask_case(tmp_path, "c", jsonfmt.size_json_bytes("c.raw", 100, 100,
                                                      64, 64),
               np.zeros((32, 32), np.uint8), None)
    compat.process_single_mask(str(tmp_path / "c_mask.png"), str(tmp_path),
                               str(tmp_path / "c_sizes.json"), "", "c")
    out = capsys.readouterr().out
    assert "Processing Failure: Mask size mismatch: 32x32 (actual) vs " \
           "64x64 (JSON)" in out


def test_postprocess_lut_and_json_helpers(tmp_path, jax_native):
    rng = np.random.default_rng(1)
    mask = rng.integers(0, 3, (64, 64)).astype(np.uint8)
    cv2.circle(mask, (32, 32), 20, 2, -1)
    out = compat.postprocess_mask(mask)
    np.testing.assert_array_equal(out, jax_compat.postprocess_mask(mask))
    assert set(np.unique(out)) <= {0, 2}
    np.testing.assert_array_equal(compat.mask_to_image(mask),
                                  jax_compat.mask_to_image(mask))
    np.testing.assert_array_equal(
        compat.mask_to_image(np.array([[0, 1, 2]], np.uint8)), [[0, 128, 255]])
    vis = compat.mask_to_image(out)
    contours = compat.extract_contours(vis)
    assert contours == jax_compat.extract_contours(vis)
    compat.generate_json(contours, str(tmp_path / "p.json"), "b", 640, 480)
    jax_compat.generate_json(contours, str(tmp_path / "j.json"), "b", 640,
                             480)
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    sizes = tmp_path / "s.json"
    sizes.write_bytes(jsonfmt.size_json_bytes("b.raw", 1, 2, 3, 4))
    assert compat.load_size_json(str(sizes)) == \
        jax_compat.load_size_json(str(sizes))


def test_reexported_engine_api():
    for name in ("initialize_engine", "get_engine", "process_single_image",
                 "cleanup_resources"):
        assert getattr(compat, name) is getattr(engine, name)
    assert compat.get_log_file() is engine.GLOBAL_LOG
    assert compat.get_log_path() == (engine.GLOBAL_LOG.path or "")
