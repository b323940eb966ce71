"""UNet++ and Attention U-Net through the port's engine on the CPU, against
the JAX engine, artifact for artifact.

Small float32 checkpoints written by the JAX package (base 8, depth 2,
64²; UNet++ with and without deep supervision), their head bias centred
on the RAWs' logits so every class and contour occurs.  ``process_batch``
with host and device cleanup, and with per-class JSON: every file
byte-equal to the JAX native emitter's.  ``process_single_image`` plain,
``per_class``, ``tta`` and ``window``: JSONs byte-equal, PNGs pixel-equal
(JAX writes its PNGs through cv2).
"""

import dataclasses
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_port_native_ready import jax_native  # noqa: F401 (fixture)
from unetseg_tpu import checkpoint as jax_ckpt, engine as jax_engine
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.io import native as jax_native_io
from unetseg_tpu.models import registry as jax_registry
from unetseg_tpu_torch import engine
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.io import raw as raw_io

W, H = 100, 80
ARCHS = {"unetpp": dict(arch="unetpp"),
         "unetpp_ds": dict(arch="unetpp", deep_supervision=True),
         "attention_unet": dict(arch="attention_unet")}


def write_raws(d, n, seed=7, w=W, h=H):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(d, f"slice_{i:03d}.raw")
        raw_io.write_raw(p, synth_slice(rng, 112)[0][:h, :w])
        paths.append(p)
    return paths


def centred_checkpoint(path, arch_kw, raw_paths, seed=0):
    """A JAX-written float32 checkpoint (base 8, depth 2, 64²) with its head
    bias centred on ``raw_paths``' logits, the foreground leading on half
    of their pixels."""
    jcfg = JaxModelConfig(base_channels=8, depth=2, image_size=64,
                          compute_dtype="float32", **arch_kw)
    params = jax.device_get(jax_registry.init(jax.random.key(seed), jcfg))
    u8 = np.stack([jax_native_io.preprocess_u8(
        np.asarray(raw_io.read_raw(p, W, H)), 64) for p in raw_paths])
    x = jnp.asarray((u8.astype(np.float32) / 255.0)[..., None])
    logits = np.asarray(jax_registry.apply(params, x, jcfg)).reshape(-1, 3)
    shift = np.median(logits, axis=0)
    # then the foreground (class 2) leads on half of the pixels
    c = logits - shift
    shift[2] += np.median(c[:, 2] - c[:, :2].max(1))
    for site in params["heads"] if "heads" in params else [params["head"]]:
        site["b"] = (site["b"] - shift).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    jax_ckpt.save(path, params, jcfg)
    return path


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """{arch name: checkpoint path}, and the RAWs their heads are centred
    on."""
    d = tmp_path_factory.mktemp("zoo")
    raws = write_raws(str(d / "in"), 3)
    ckpts = {name: centred_checkpoint(str(d / "engine" / f"{name}.ckpt"), kw,
                                      raws, seed=i)
             for i, (name, kw) in enumerate(ARCHS.items())}
    return ckpts, raws


def _files(d):
    return sorted(os.listdir(d))


def assert_same_bytes(a_dir, b_dir, n_files=None):
    names = _files(a_dir)
    assert names == _files(b_dir), (names, _files(b_dir))
    if n_files is not None:
        assert len(names) == n_files, names
    for f in names:
        with open(os.path.join(a_dir, f), "rb") as a, \
                open(os.path.join(b_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    return names


def assert_same_artifacts(jdir, pdir):
    """JSONs byte-equal, PNGs pixel-equal."""
    names = _files(jdir)
    assert names == _files(pdir) and names, (names, _files(pdir))
    for f in names:
        a, b = os.path.join(jdir, f), os.path.join(pdir, f)
        if f.endswith(".json"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
        else:
            np.testing.assert_array_equal(
                cv2.imread(b, cv2.IMREAD_UNCHANGED),
                cv2.imread(a, cv2.IMREAD_UNCHANGED), err_msg=f)
    return names


@pytest.fixture()
def both(zoo, tmp_path, jax_native):
    """init(arch, **kw): the JAX and the port engine on that checkpoint."""
    def init(arch, **kw):
        ckpt = zoo[0][arch]
        assert jax_engine.initialize_engine(
            ckpt, log_dir=str(tmp_path / "jlog"), **kw)
        assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "plog"),
                                        device="cpu", **kw)
        eng = engine.get_engine()
        assert eng.model.route == "unfused"
        assert dataclasses.asdict(eng.cfg)["arch"] == ARCHS[arch]["arch"]
        return eng
    yield init
    jax_engine.cleanup_resources()
    engine.cleanup_resources()


@pytest.mark.parametrize("device_post", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_process_batch_matches_jax(both, zoo, tmp_path, arch, device_post):
    both(arch, device_postprocess=device_post)
    paths = zoo[1]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_engine.process_batch(paths, W, H, [jdir] * 3,
                                    emitter="native") == (3, 0)
    assert engine.process_batch(paths, W, H, [pdir] * 3) == (3, 0)
    # all five artifacts of every slice: the masks hold contours
    assert_same_bytes(jdir, pdir, 15)
    if not device_post:  # per-class JSON refuses the device cleanup
        jdir, pdir = str(tmp_path / "jax_pc"), str(tmp_path / "port_pc")
        assert jax_engine.process_batch(paths, W, H, [jdir] * 3,
                                        emitter="native",
                                        per_class=True) == (3, 0)
        assert engine.process_batch(paths, W, H, [pdir] * 3,
                                    per_class=True) == (3, 0)
        names = assert_same_bytes(jdir, pdir, 18)
        assert sum(n.endswith("_classes.json") for n in names) == 3


# (kwargs, model passes): one forward; TTA's 8; windows of 64 with the
# default overlap on 100 x 80 (2 x 3 windows in one pass)
MODES = {"plain": ({}, 1), "per_class": ({"per_class": True}, 1),
         "tta": ({"tta": True}, 8), "window": ({"window": 64}, 1)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_process_single_image_modes_match_jax(both, zoo, tmp_path, arch,
                                              mode):
    kw, passes = MODES[mode]
    eng = both(arch)
    raw = zoo[1][1]
    before = eng.forwards
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_engine.process_single_image(raw, W, H, jdir, **kw)
    assert engine.process_single_image(raw, W, H, pdir, **kw)
    assert eng.forwards - before == passes
    names = assert_same_artifacts(jdir, pdir)
    assert len(names) == 5 + (mode == "per_class"), names
