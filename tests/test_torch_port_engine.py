"""The port's engine on the CPU against the JAX engine, artifact for artifact.

A small float32 checkpoint written by the JAX package serves both engines on
the same RAWs (of a size other than the model's input, so the JSON
coordinate scaling is exercised).  ``process_batch`` artifacts must be
byte-equal to the JAX native emitter's; ``process_single_image`` JSONs
byte-equal and PNGs pixel-equal (JAX writes its PNGs through cv2).  The
same holds in the all-device mode (``device_postprocess=True``), whose
cleanup runs in the pipeline on both sides.
"""

import dataclasses
import json
import os

import cv2
import numpy as np
import pytest
import torch

from unetseg_tpu import checkpoint as jax_ckpt, engine as jax_engine
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu_torch import checkpoint, engine
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.io import raw as raw_io

from test_torch_port_native_ready import jax_native  # noqa: F401 (fixture)

SMALL = JaxModelConfig(base_channels=8, depth=2, image_size=64,
                       compute_dtype="float32")
W, H = 100, 80


@pytest.fixture()
def ckpt(tmp_path):
    path = tmp_path / "engine" / "model.ckpt"
    path.parent.mkdir()
    jax_ckpt.create(str(path), SMALL, seed=0)
    return str(path)


def _write_raws(tmp_path, n):
    rng = np.random.default_rng(7)
    paths = []
    for i in range(n):
        p = tmp_path / "in" / f"slice_{i:03d}.raw"
        p.parent.mkdir(exist_ok=True)
        raw_io.write_raw(str(p), synth_slice(rng, 112)[0][:H, :W])
        paths.append(str(p))
    return paths


def _files(d):
    return sorted(os.listdir(d))


@pytest.fixture()
def both_engines(ckpt, tmp_path, jax_native):
    assert jax_engine.initialize_engine(ckpt, log_dir=str(tmp_path / "jlog"))
    assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "plog"),
                                    device="cpu")
    yield
    jax_engine.cleanup_resources()
    engine.cleanup_resources()


def test_process_batch_artifacts_byte_equal(both_engines, tmp_path):
    paths = _write_raws(tmp_path, 3)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_engine.process_batch(paths, W, H, [jdir] * 3,
                                    emitter="native") == (3, 0)
    assert engine.process_batch(paths, W, H, [pdir] * 3) == (3, 0)
    names = _files(jdir)
    assert names == _files(pdir)
    # every slice has all five artifacts: the test is not vacuous
    assert len(names) == 15, names
    for f in names:
        with open(os.path.join(jdir, f), "rb") as a, \
                open(os.path.join(pdir, f), "rb") as b:
            assert a.read() == b.read(), f
    log = open(tmp_path / "plog" / "segmentation_log.txt").read()
    assert "Engine initialized successfully" in log


def test_process_batch_tiers(both_engines, tmp_path):
    paths = _write_raws(tmp_path, 2)
    out = str(tmp_path / "json_tier")
    assert engine.process_batch(paths, W, H, [out] * 2, batch_size=4,
                                tier="json") == (2, 0)
    assert all(f.endswith(".json") for f in _files(out))
    with pytest.raises(ValueError, match="tier"):
        engine.process_batch(paths, W, H, [out] * 2, tier="nope")


def test_process_single_image_matches_jax(both_engines, tmp_path):
    raw = _write_raws(tmp_path, 1)[0]
    jdir, pdir = str(tmp_path / "jax1"), str(tmp_path / "port1")
    assert jax_engine.process_single_image(raw, W, H, jdir)
    assert engine.process_single_image(raw, W, H, pdir)
    names = _files(jdir)
    assert names == _files(pdir) and len(names) == 5, names
    for f in names:
        a, b = os.path.join(jdir, f), os.path.join(pdir, f)
        if f.endswith(".json"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
        else:
            np.testing.assert_array_equal(
                cv2.imread(b, cv2.IMREAD_UNCHANGED),
                cv2.imread(a, cv2.IMREAD_UNCHANGED), err_msg=f)


def test_entry_points_default_to_cuda_and_fail_without_it(ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device would work")
    assert not engine.initialize_engine(ckpt, log_dir=str(tmp_path / "log"))
    assert engine.get_engine() is None
    log = open(tmp_path / "log" / "segmentation_log.txt").read()
    assert "Initialization error" in log and "CUDA" in log
    params, cfg = checkpoint.load(ckpt)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.InferenceEngine(params, cfg)
    raw = _write_raws(tmp_path, 1)[0]
    assert not engine.process_single_image(raw, W, H, str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="not initialized"):
        engine.process_batch([raw], W, H, [str(tmp_path / "o")])
    engine.cleanup_resources()


def test_unported_modes_raise(ckpt, tmp_path):
    """Only float32 on CUDA still raises with its ROADMAP item (P13); the
    quantized arch (P11, whose convs are int8, so P13 is not its), the
    other archs (P10), the cascade (P8), per-class JSON (P6), TTA and
    sliding windows now serve."""
    from unetseg_tpu_torch import quantize
    from unetseg_tpu_torch.data import training_batch

    params, cfg = checkpoint.load(ckpt)
    with pytest.raises(NotImplementedError, match="P13"):
        engine.InferenceEngine(params, cfg, device="cuda")
    q_ckpt = str(tmp_path / "w8a8.ckpt")
    quantize.quantize_checkpoint(
        ckpt, q_ckpt, [training_batch(np.random.default_rng(3), 2, 64)[0]],
        device="cpu")
    if not torch.cuda.is_available():  # past P13, to the CUDA check
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.InferenceEngine(*checkpoint.load(q_ckpt), device="cuda")
    raw = _write_raws(tmp_path, 1)[0]
    for arch in ("unet", "unet_w8a8", "unetpp", "attention_unet"):
        if arch == "unet":
            eng = engine.InferenceEngine(params, cfg, device="cpu")
        elif arch == "unet_w8a8":
            eng = engine.InferenceEngine(*checkpoint.load(q_ckpt),
                                         device="cpu")
            assert eng.cfg.arch == arch
        else:
            zoo_cfg = dataclasses.replace(cfg, arch=arch)
            zoo_ckpt = str(tmp_path / f"{arch}.ckpt")
            checkpoint.create(zoo_ckpt, zoo_cfg, seed=0)
            eng = engine.InferenceEngine(*checkpoint.load(zoo_ckpt),
                                         device="cpu")
            assert eng.cfg.arch == arch
        for i, kw in enumerate(({}, {"tta": True}, {"window": 256},
                                {"per_class": True})):
            out = str(tmp_path / f"{arch}_mode{i}")
            assert engine.process_single_image(raw, W, H, out, eng=eng, **kw)
            # three artifacts at least; the seeded heads of the new
            # families may leave no contour to draw
            assert len(_files(out)) >= 3 + ("per_class" in kw), kw
            if arch in ("unet", "unet_w8a8"):
                assert len(_files(out)) == 5 + ("per_class" in kw), kw
    out = str(tmp_path / "batch")
    assert engine.process_batch([raw], W, H, [out], eng=eng,
                                per_class=True) == (1, 0)
    assert "slice_000_classes.json" in _files(out)
    try:
        assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "log"),
                                        device="cpu", cascade_ckpt=ckpt)
        assert engine.get_engine().cascade_attached
        assert engine.process_single_image(raw, W, H, str(tmp_path / "c"))
    finally:
        engine.cleanup_resources()


@pytest.fixture()
def both_device_post(ckpt, tmp_path, jax_native):
    assert jax_engine.initialize_engine(ckpt, log_dir=str(tmp_path / "jlog"),
                                        device_postprocess=True)
    assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "plog"),
                                    device="cpu", device_postprocess=True)
    yield engine.get_engine()
    jax_engine.cleanup_resources()
    engine.cleanup_resources()


def _assert_same_files(a_dir, b_dir, n_files):
    names = _files(a_dir)
    assert names == _files(b_dir) and len(names) == n_files, names
    for f in names:
        with open(os.path.join(a_dir, f), "rb") as a, \
                open(os.path.join(b_dir, f), "rb") as b:
            assert a.read() == b.read(), f


def test_device_postprocess_matches_jax(both_device_post, tmp_path):
    eng = both_device_post
    assert eng.device_postprocess
    paths = _write_raws(tmp_path, 3)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_engine.process_batch(paths, W, H, [jdir] * 3,
                                    emitter="native") == (3, 0)
    assert engine.process_batch(paths, W, H, [pdir] * 3) == (3, 0)
    _assert_same_files(jdir, pdir, 15)

    # The pipeline returns cleaned masks and the host cleanup is identity.
    u8 = np.stack([np.full((64, 64), 40 * i, np.uint8) for i in range(2)])
    masks = eng.to_host(eng.infer(u8))()
    assert set(np.unique(masks)) <= {0, 2}
    np.testing.assert_array_equal(eng.cleanup_masks(masks), masks)

    raw = paths[0]
    j1, p1 = str(tmp_path / "jax1"), str(tmp_path / "port1")
    assert jax_engine.process_single_image(raw, W, H, j1)
    assert engine.process_single_image(raw, W, H, p1)
    names = _files(j1)
    assert names == _files(p1) and len(names) == 5, names
    for f in names:
        a, b = os.path.join(j1, f), os.path.join(p1, f)
        if f.endswith(".json"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
        else:
            np.testing.assert_array_equal(
                cv2.imread(b, cv2.IMREAD_UNCHANGED),
                cv2.imread(a, cv2.IMREAD_UNCHANGED), err_msg=f)


def test_device_and_host_cleanup_write_the_same_bytes(ckpt, tmp_path):
    paths = _write_raws(tmp_path, 3)
    outs = []
    for dev_post in (False, True):
        assert engine.initialize_engine(
            ckpt, log_dir=str(tmp_path / "log"), device="cpu",
            device_postprocess=dev_post)
        outs.append(str(tmp_path / f"out_{dev_post}"))
        assert engine.process_batch(paths, W, H, [outs[-1]] * 3) == (3, 0)
        engine.cleanup_resources()
    _assert_same_files(*outs, 15)


def test_eng_emitter_and_overlap_parameters(ckpt, tmp_path):
    """``eng=`` serves without a global engine; both emitters write the same
    bytes; ``overlap`` without ``window`` is ignored, as in JAX."""
    params, cfg = checkpoint.load(ckpt)
    eng = engine.InferenceEngine(params, cfg, device="cpu")
    assert engine.get_engine() is None
    paths = _write_raws(tmp_path, 2)
    outs = {}
    for emitter in engine.EMITTERS:
        outs[emitter] = str(tmp_path / emitter)
        assert engine.process_batch(paths, W, H, [outs[emitter]] * 2,
                                    eng=eng, emitter=emitter) == (2, 0)
    _assert_same_files(outs["cv2"], outs["native"], 10)
    with pytest.raises(ValueError, match="emitter"):
        engine.process_batch(paths, W, H, [outs["cv2"]] * 2, eng=eng,
                             emitter="pil")
    single = str(tmp_path / "single")
    assert engine.process_single_image(paths[0], W, H, single, overlap=32,
                                       eng=eng)
    for f in _files(single):
        with open(os.path.join(single, f), "rb") as a, \
                open(os.path.join(outs["cv2"], f), "rb") as b:
            assert a.read() == b.read(), f
    assert engine.get_engine() is None


# (kwargs, W, H, model passes): TTA, 8 passes; windows on the default
# (regular) grid, 2 x 3 windows in one pass; overlap 16, an irregular 2 x 2
# grid; a 3-row image, below the UNet's alignment (4 = stem * 2**depth),
# edge-padded to one row of 44 4 x 4 windows (two passes of 32) and cropped
# back.
MODES = {"tta": ({"tta": True}, W, H, 8),
         "window": ({"window": 64}, W, H, 1),
         "window_overlap16": ({"window": 64, "overlap": 16}, W, H, 1),
         "window_padded": ({"window": 64}, 90, 3, 2)}


@pytest.mark.parametrize("device_post", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("mode", list(MODES))
def test_tta_and_window_modes_match_jax(ckpt, tmp_path, mode, device_post,
                                       jax_native):
    """``process_single_image(tta=True)`` and ``(window=..., overlap=...)``
    against the JAX engine, with host and with device cleanup: the same
    masks, so JSONs byte-equal and PNGs pixel-equal; window mode writes at
    the image's own size."""
    kw, w, h, passes = MODES[mode]
    rng = np.random.default_rng(3)
    raw = str(tmp_path / "img.raw")
    raw_io.write_raw(raw, synth_slice(rng, 112)[0][:h, :w])
    assert jax_engine.initialize_engine(ckpt, log_dir=str(tmp_path / "jlog"),
                                        device_postprocess=device_post)
    assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "plog"),
                                    device="cpu",
                                    device_postprocess=device_post)
    try:
        jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
        assert jax_engine.process_single_image(raw, w, h, jdir, **kw)
        assert engine.process_single_image(raw, w, h, pdir, **kw)
        eng = engine.get_engine()
        assert eng.forwards == passes + 1  # and the warm-up
    finally:
        jax_engine.cleanup_resources()
        engine.cleanup_resources()
    names = _files(jdir)
    assert names == _files(pdir) and len(names) in (3, 5), names
    for f in names:
        a, b = os.path.join(jdir, f), os.path.join(pdir, f)
        if f.endswith(".json"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
        else:
            np.testing.assert_array_equal(
                cv2.imread(b, cv2.IMREAD_UNCHANGED),
                cv2.imread(a, cv2.IMREAD_UNCHANGED), err_msg=f)
    sizes = json.load(open(os.path.join(pdir, "img_original_sizes.json")))
    scaled = (w, h) if "window" in kw else (64, 64)
    assert (sizes["img.raw"]["scaled_width"],
            sizes["img.raw"]["scaled_height"]) == scaled
    mask = cv2.imread(os.path.join(pdir, "img_mask.png"), cv2.IMREAD_UNCHANGED)
    assert mask.shape == scaled[::-1]
