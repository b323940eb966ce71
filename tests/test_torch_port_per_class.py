"""Per-class contour JSON (P6, BASELINE config 2) in the port against the
JAX engine on the CPU, the cases of ``tests/test_per_class.py``.

``{base}_classes.json`` carries every class's contours, traced from the
decoded mask before the cleanup (class 1 exists only there).  A small
float32 checkpoint written by the JAX package serves both engines on the
same RAWs (of a size other than the model's input, so the points are
scaled); the files must be byte-equal to the JAX engine's, and to the pure
path (``io/contours_py`` + ``io/jsonfmt``) of the port's own decoded masks.
"""

import json
import os

import numpy as np
import pytest

from test_torch_port_native_ready import jax_native  # noqa: F401 (fixture)
from unetseg_tpu import checkpoint as jax_ckpt, engine as jax_engine
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.io import native as jax_native_io
from unetseg_tpu_torch import checkpoint, engine, service
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.io import contours_py, jsonfmt, native, raw as raw_io
from unetseg_tpu_torch.parallel import pipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SMALL = JaxModelConfig(base_channels=8, depth=2, image_size=64,
                       compute_dtype="float32")
W, H = 100, 80
LABELED = [(1, 0, [(10, 12), (30, 12), (30, 40)]),
           (2, 1, [(100, 100), (140, 100), (140, 140), (100, 140)]),
           (2, 1, [(5, 5), (6, 5), (6, 6)])]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("per_class") / "engine" / "model.ckpt"
    path.parent.mkdir()
    jax_ckpt.create(str(path), SMALL, seed=2)
    return str(path)


@pytest.fixture()
def both_engines(ckpt, tmp_path, jax_native):
    assert jax_engine.initialize_engine(ckpt, log_dir=str(tmp_path / "jlog"))
    assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "plog"),
                                    device="cpu")
    yield engine.get_engine()
    jax_engine.cleanup_resources()
    engine.cleanup_resources()


def _raws(tmp_path, n, seed=9):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = tmp_path / "in" / f"s{i}.raw"
        p.parent.mkdir(exist_ok=True)
        raw_io.write_raw(str(p), synth_slice(rng, 112)[0][:H, :W])
        paths.append(str(p))
    return paths


def _read(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return f.read()


def _pure(decoded, base, w=W, h=H):
    """The pure path's bytes of ``{base}_classes.json`` for one decoded
    mask."""
    labeled = []
    for idx, cls in enumerate((1, 2)):
        binary = np.where(decoded == cls, 255, 0).astype(np.uint8)
        cs = contours_py.map_contour_points(
            contours_py.extract_contours(binary), w / decoded.shape[1],
            h / decoded.shape[0])
        labeled += [(cls, idx, c) for c in cs]
    return jsonfmt.contour_json_bytes_labeled(labeled, base, w, h)


def _labels(data):
    return {s["label"] for s in json.loads(data)["shapes"]}


def test_labeled_json_matches_golden_and_pure_path():
    with open(os.path.join(GOLDEN, "contour_labeled_golden.json"), "rb") as f:
        golden = f.read()
    assert native.contour_json_bytes_labeled(LABELED, "ml", 1024, 768, 2.0,
                                             1.5) == golden
    scaled = [(lab, idx, [(int(x * 2.0), int(y * 1.5)) for x, y in c])
              for lab, idx, c in LABELED]
    assert jsonfmt.contour_json_bytes_labeled(scaled, "ml", 1024, 768) == \
        golden
    empty = native.contour_json_bytes_labeled([], "e", 64, 64, 1.0, 1.0)
    assert json.loads(empty)["shapes"] == []


def test_contours_per_class_matches_jax(jax_native):
    rng = np.random.default_rng(4)
    mask = rng.integers(0, 3, (40, 50)).astype(np.uint8)
    mask[5:20, 5:30] = 1
    mask[25:35, 10:45] = 2
    got = native.contours_per_class(mask)
    assert got == jax_native_io.contours_per_class(mask)
    assert set(got) == {1, 2} and got[1] and got[2]
    labeled = [(c, i, x) for i, (c, cs) in enumerate(sorted(got.items()))
               for x in cs]
    assert native.contour_json_bytes_labeled(labeled, "m", 80, 60, 1.6,
                                             1.2) == \
        jax_native_io.contour_json_bytes_labeled(labeled, "m", 80, 60, 1.6,
                                                 1.2)


@pytest.mark.parametrize("mode", [{}, {"tta": True}, {"window": 64},
                                  {"window": 48, "overlap": 8}])
def test_single_image_per_class_matches_jax(both_engines, tmp_path, mode):
    eng = both_engines
    raw = _raws(tmp_path, 1)[0]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_engine.process_single_image(raw, W, H, jdir, per_class=True,
                                           **mode)
    assert engine.process_single_image(raw, W, H, pdir, per_class=True,
                                       **mode)
    got = _read(pdir, "s0_classes.json")
    assert got == _read(jdir, "s0_classes.json")
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    # the pure path of the port's own decoded mask
    u8 = native.preprocess_u8(np.asarray(raw_io.read_raw(raw, W, H)), 64)
    if "window" in mode:
        import torch
        from unetseg_tpu_torch.ops import preprocess
        u8_dev = preprocess.normalize_u8(torch.from_numpy(np.array(
            raw_io.read_raw(raw, W, H))))
        decoded = eng.infer_tiled(u8_dev, mode["window"],
                                  mode.get("overlap")).numpy()
    elif mode:
        decoded = eng.infer_tta(u8).numpy()
    else:
        decoded = eng.to_host(eng.infer(u8[None]))()[0]
    assert got == _pure(decoded, "s0")
    doc = json.loads(got)
    assert (doc["imageWidth"], doc["imageHeight"]) == (W, H)
    for shape in doc["shapes"]:
        assert shape["labelIndex"] == {1: 0, 2: 1}[shape["label"]]


def test_batched_per_class_matches_serial_and_jax(both_engines, tmp_path):
    """process_batch(per_class=True): each slice's file byte-equal to the
    serial path's, to the JAX engine's batched files (both emitters) and
    to the pure path; a ragged tail of 1 in batches of 2."""
    eng = both_engines
    paths = _raws(tmp_path, 3)
    serial = str(tmp_path / "serial")
    for p in paths:
        assert engine.process_single_image(p, W, H, serial, per_class=True)
    labels = set()
    for emitter in ("cv2", "native"):
        jdir = str(tmp_path / f"jax_{emitter}")
        pdir = str(tmp_path / f"port_{emitter}")
        assert jax_engine.process_batch(paths, W, H, [jdir] * 3, batch_size=2,
                                        emitter=emitter,
                                        per_class=True) == (3, 0)
        assert engine.process_batch(paths, W, H, [pdir] * 3, batch_size=2,
                                    emitter=emitter, per_class=True) == (3, 0)
        for i, p in enumerate(paths):
            name = f"s{i}_classes.json"
            got = _read(pdir, name)
            assert got == _read(serial, name) == _read(jdir, name), \
                (emitter, i)
            u8 = native.preprocess_u8(np.asarray(raw_io.read_raw(p, W, H)),
                                      64)
            assert got == _pure(eng.to_host(eng.infer(u8[None]))()[0],
                                f"s{i}")
            labels |= _labels(got)
        assert len(os.listdir(pdir)) == len(os.listdir(jdir))
    assert labels == {1, 2}  # both classes occur: the test is not vacuous


def test_per_class_emit_failure_marks_slice(both_engines, tmp_path,
                                            monkeypatch):
    """A per-class emit failure fails that slice only, and its other
    artifacts are still written."""
    paths = _raws(tmp_path, 2)
    real = engine._emit_per_class_json

    def flaky(decoded, out_dir, base, w, h):
        if base == "s1":
            raise OSError("disk full")
        real(decoded, out_dir, base, w, h)

    monkeypatch.setattr(engine, "_emit_per_class_json", flaky)
    out = str(tmp_path / "o")
    assert engine.process_batch(paths, W, H, [out] * 2,
                                per_class=True) == (1, 1)
    names = os.listdir(out)
    assert "s0_classes.json" in names and "s1_classes.json" not in names
    assert "s1_mask.png" in names


def test_per_class_refuses_device_postprocess(ckpt, tmp_path, jax_native):
    raw = _raws(tmp_path, 1)[0]
    try:
        assert jax_engine.initialize_engine(
            ckpt, log_dir=str(tmp_path / "jlog"), device_postprocess=True)
        assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "plog"),
                                        device="cpu", device_postprocess=True)
        assert not engine.process_single_image(raw, W, H, str(tmp_path / "o"),
                                               per_class=True)
        assert not os.path.exists(tmp_path / "o" / "s0_classes.json")
        with pytest.raises(ValueError, match="per_class") as port_err:
            engine.process_batch([raw], W, H, [str(tmp_path / "o")],
                                 per_class=True)
        with pytest.raises(ValueError, match="per_class") as jax_err:
            jax_engine.process_batch([raw], W, H, [str(tmp_path / "o")],
                                     per_class=True)
        assert str(port_err.value) == str(jax_err.value)
        log = open(tmp_path / "plog" / "segmentation_log.txt").read()
        assert str(port_err.value) in log
    finally:
        jax_engine.cleanup_resources()
        engine.cleanup_resources()


def test_service_per_class_field(ckpt, tmp_path):
    paths = _raws(tmp_path, 2)
    svc = service.SegmentationService(port=0, device="cpu")
    addr = svc.start()
    try:
        assert service.request(addr, {"cmd": "init", "cache": ckpt})["ok"]
        for path, out in ((paths[0], "one"), (str(tmp_path / "in"), "dir")):
            r = service.request(addr, {
                "cmd": "process", "path": path, "width": W, "height": H,
                "output_dir": str(tmp_path / out), "per_class": True})
            assert r["ok"], r
        assert "s0_classes.json" in os.listdir(tmp_path / "one")
        assert {"s0_classes.json", "s1_classes.json"} <= set(
            os.listdir(tmp_path / "dir"))
        assert _read(str(tmp_path / "one"), "s0_classes.json") == \
            _read(str(tmp_path / "dir"), "s0_classes.json")
    finally:
        svc.stop()


def test_study_per_class_matches_process_batch(both_engines, ckpt, tmp_path):
    """run_study(per_class=True, artifacts="full") writes the files
    process_batch writes, byte for byte, the per-class ones included (a
    ragged tail of 2 in batches of 3)."""
    paths = _raws(tmp_path, 5, seed=3)
    ref, out = str(tmp_path / "ref"), str(tmp_path / "study")
    assert engine.process_batch(paths, W, H, [ref] * 5, batch_size=3,
                                per_class=True) == (5, 0)
    params, cfg = checkpoint.load(ckpt)
    res = pipeline.run_study(params, cfg, paths, W, H, batch_size=3,
                             host_preprocess=True, artifacts="full",
                             out_dir=out, per_class=True, device="cpu")
    assert res.n_slices == 5
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(out))
    assert sum(n.endswith("_classes.json") for n in names) == 5
    for f in names:
        assert _read(ref, f) == _read(out, f), f
    with pytest.raises(ValueError, match="per_class requires artifacts"):
        pipeline.run_study(params, cfg, paths, W, H, host_preprocess=True,
                           per_class=True, device="cpu")


def test_per_class_under_cascade_matches_jax(ckpt, tmp_path, jax_native):
    """Per-class JSON composes with the cascade: the file comes from the
    decoded masks the cascade serves (route all: the fallback's)."""
    fb = str(tmp_path / "fb.ckpt")
    jax_ckpt.create(fb, JaxModelConfig(base_channels=12, depth=2,
                                       image_size=64, compute_dtype="float32"),
                    seed=1)
    paths = _raws(tmp_path, 2)
    kw = dict(cascade_ckpt=fb, cascade_threshold=np.inf)
    try:
        assert jax_engine.initialize_engine(
            ckpt, log_dir=str(tmp_path / "jlog"), **kw)
        assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "plog"),
                                        device="cpu", **kw)
        jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
        assert jax_engine.process_batch(paths, W, H, [jdir] * 2,
                                        emitter="native",
                                        per_class=True) == (2, 0)
        assert engine.process_batch(paths, W, H, [pdir] * 2,
                                    per_class=True) == (2, 0)
        assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
        for f in os.listdir(jdir):
            assert _read(jdir, f) == _read(pdir, f), f
        params, cfg = checkpoint.load(fb)
        fb_eng = engine.InferenceEngine(params, cfg, "cpu")
        u8 = native.preprocess_u8(np.asarray(raw_io.read_raw(
            paths[0], W, H)), 64)
        assert _read(pdir, "s0_classes.json") == _pure(
            fb_eng.to_host(fb_eng.infer(u8[None]))()[0], "s0")
    finally:
        jax_engine.cleanup_resources()
        engine.cleanup_resources()
