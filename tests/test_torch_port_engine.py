"""The port's engine on the CPU against the JAX engine, artifact for artifact.

A small float32 checkpoint written by the JAX package serves both engines on
the same RAWs (of a size other than the model's input, so the JSON
coordinate scaling is exercised).  ``process_batch`` artifacts must be
byte-equal to the JAX native emitter's; ``process_single_image`` JSONs
byte-equal and PNGs pixel-equal (JAX writes its PNGs through cv2).
"""

import dataclasses
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
def both_engines(ckpt, tmp_path):
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.initialize_engine(ckpt, device="cpu", device_postprocess=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.initialize_engine(ckpt, device="cpu", cascade_ckpt=ckpt)
    for kw in ({"tta": True}, {"window": 256}, {"per_class": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            engine.process_single_image("x.raw", W, H, str(tmp_path), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.process_batch([], W, H, [], per_class=True)
    params, cfg = checkpoint.load(ckpt)
    with pytest.raises(NotImplementedError, match="P10"):
        engine.InferenceEngine(params, dataclasses.replace(cfg, arch="unetpp"),
                               device="cpu")
