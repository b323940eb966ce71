"""The flagship path of the port on the CPU: stem-1 models (``ModelConfig()``
is depth 4, base 64, stem 1) through the conv's channel padding, the port's
own checkpoint writer, ``UNet.masks`` with the fused last level (K6's plain
version here) and the engine, against the JAX package."""

import dataclasses
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from unetseg_tpu import checkpoint as jax_ckpt, engine as jax_engine
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu_torch import checkpoint, engine
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.io import native, raw as raw_io
from unetseg_tpu_torch.models import registry, unet
from unetseg_tpu_torch.ops import conv, preprocess

from test_torch_port_checkpoint import _assert_same_tree
from test_torch_port_engine import H, W, _write_raws

MODELS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models")
SMALL = dict(base_channels=8, depth=2, image_size=64)
ARTIFACTS = ("_normalized.png", "_original_sizes.json", "_mask.png",
             "_contour_overlay.png", ".json")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 4])
def test_conv_channel_padding_is_exact(c, dtype):
    """The flagship's first conv (C = 1) and a stem-2 model's (C = 4) reach
    the kernel zero-padded to 16 channels; the padded conv equals the
    unpadded one."""
    g = torch.Generator().manual_seed(c)
    x = torch.rand((2, 12, 10, c), generator=g).to(dtype)
    w = (torch.randn((3, 3, c, 16), generator=g) / 3).to(dtype)
    b = (torch.randn(16, generator=g) * 0.1).to(dtype)
    xp, wp = conv.pad_input_channels(x, w)
    assert xp.shape == (2, 12, 10, 16) and wp.shape == (3, 3, 16, 16)
    assert torch.equal(xp[..., :c], x) and not xp[..., c:].any()
    assert torch.equal(wp[:, :, :c], w) and not wp[:, :, c:].any()
    torch.testing.assert_close(conv.conv3x3_bias_act_plain(xp, wp, b),
                               conv.conv3x3_bias_act_plain(x, w, b),
                               rtol=1e-6, atol=1e-6)
    x16 = torch.zeros((1, 4, 4, 16), dtype=dtype)
    w16 = torch.zeros((3, 3, 16, 16), dtype=dtype)
    assert conv.pad_input_channels(x16, w16) == (x16, w16)


def test_init_matches_jax_tree_at_flagship_size():
    """``models.unet.init(ModelConfig())``: JAX's tree, shapes and dtypes,
    He-normal scale, zero biases."""
    cfg = ModelConfig()
    params = unet.init(cfg, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda k: jax_unet.init(k, JaxModelConfig()),
                          jax.random.key(0))
    got_leaves, got_tree = jax.tree_util.tree_flatten(params)
    want_leaves, want_tree = jax.tree_util.tree_flatten(want)
    assert got_tree == want_tree
    for a, b in zip(got_leaves, want_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    w = params["bottleneck"]["conv2"]["w"]
    assert abs(w.std() - np.sqrt(2 / (9 * 1024))) < 1e-3
    assert not params["decoder"][3]["up"]["b"].any()
    again = unet.init(cfg, torch.Generator().manual_seed(0))
    assert np.array_equal(again["head"]["w"], params["head"]["w"])


@pytest.mark.parametrize("stem,dtype", [(1, "float32"), (1, "bfloat16"),
                                        (2, "float32")])
def test_port_save_loads_in_jax(tmp_path, stem, dtype):
    cfg = ModelConfig(**SMALL, stem=stem, compute_dtype=dtype)
    params = unet.init(cfg, torch.Generator().manual_seed(3))
    params["encoder"][0]["conv1"]["w"] = \
        params["encoder"][0]["conv1"]["w"].astype(np.float16)
    path = str(tmp_path / "port.ckpt")
    checkpoint.save(path, params, cfg)
    assert not os.path.exists(path + ".tmp")
    jax_ckpt.save(str(tmp_path / "jax.ckpt"), params, cfg)
    with open(path, "rb") as a, open(tmp_path / "jax.ckpt", "rb") as b:
        assert a.read() == b.read()  # byte-identical to flax's writer
    got, got_cfg = jax_ckpt.load(path)
    _assert_same_tree(got, params)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    port, port_cfg = checkpoint.load(path)
    _assert_same_tree(port, params)
    assert port_cfg == cfg


def test_jax_create_loads_in_port(tmp_path):
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.create(path, JaxModelConfig(**SMALL), seed=1)
    got, cfg = checkpoint.load(path)
    want, want_cfg = jax_ckpt.load(path)
    _assert_same_tree(got, want)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)


def test_packb_matches_msgpack_on_flax_payloads():
    import msgpack
    from flax import serialization

    tree = {"config": dataclasses.asdict(ModelConfig()), "params": {
        "a": [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.zeros((0,), np.float16)],
        "b": {"w": np.ones((1, 1, 1, 1), np.float32),
              "big": np.ones((70, 1000), np.float32)}}}
    assert checkpoint.packb(tree) == serialization.msgpack_serialize(tree)
    for v in (None, True, 0, 127, 128, 65535, 2 ** 40, -1, -33, -40000,
              -2 ** 40, 1.5, "", "x" * 40, "y" * 300, b"ab", b"c" * 70000,
              [1, [2]], {"a": {"b": [None]}, "c": 1}):
        assert checkpoint.packb(v) == msgpack.packb(v, use_bin_type=True), v
    with pytest.raises(TypeError):
        checkpoint.packb({1j})


def _centre_head_bias(path, raw_paths):
    """Rewrite the head bias of the checkpoint at ``path`` to minus the
    median logit of each class on ``raw_paths``, so that a random model
    paints every class and its masks have contours."""
    params, cfg = checkpoint.load(path)
    u8 = np.stack([native.preprocess_u8(np.asarray(raw_io.read_raw(p, W, H)),
                                        cfg.image_size) for p in raw_paths])
    model = registry.build(params, cfg, device="cpu")
    with torch.inference_mode():
        logits = model(preprocess.model_input_from_u8(
            torch.from_numpy(u8))[..., None])
    params["head"]["b"] = -logits.reshape(-1, cfg.num_classes).median(
        0).values.numpy()
    checkpoint.save(path, params, cfg)


def test_port_create_serves_the_flagship_on_cpu(tmp_path):
    """``create(ModelConfig())`` -> ``initialize_engine(device="cpu")`` ->
    ``process_batch`` and ``process_single_image``: all five artifacts."""
    path = str(tmp_path / "m" / "model.ckpt")
    os.makedirs(os.path.dirname(path))
    checkpoint.create(path, ModelConfig(), seed=0)
    paths = _write_raws(tmp_path, 3)
    _centre_head_bias(path, paths[:1])
    assert engine.initialize_engine(path, log_dir=str(tmp_path / "log"),
                                    device="cpu")
    try:
        assert engine.get_engine().cfg == ModelConfig()
        out = str(tmp_path / "out")
        assert engine.process_batch(paths, W, H, [out] * 3,
                                    batch_size=2) == (3, 0)
        one = str(tmp_path / "one")
        assert engine.process_single_image(paths[1], W, H, one)
        for d, base in ((out, "slice_000"), (out, "slice_002"),
                        (one, "slice_001")):
            for s in ARTIFACTS:
                assert os.path.getsize(os.path.join(d, base + s)) > 0, s
        for s in ARTIFACTS:
            with open(os.path.join(one, "slice_001" + s), "rb") as a, \
                    open(os.path.join(out, "slice_001" + s), "rb") as b:
                assert a.read() == b.read(), s
    finally:
        engine.cleanup_resources()


def _flip_prone_ckpt(tmp_path):
    """A small bf16 stem-1 checkpoint from JAX whose masks have contours:
    the head's class-2 bias is lifted so the random model paints some
    foreground."""
    jcfg = JaxModelConfig(**SMALL, compute_dtype="bfloat16")
    params = jax.device_get(jax_unet.init(jax.random.key(0), jcfg))
    params["head"]["b"] = np.array([0.0, 0.0, 0.05], np.float32)
    path = str(tmp_path / "engine" / "model.ckpt")
    os.makedirs(os.path.dirname(path))
    jax_ckpt.save(path, params, jcfg)
    return path


def test_bf16_engines_write_equal_artifacts_where_masks_agree(tmp_path):
    path = _flip_prone_ckpt(tmp_path)
    paths = _write_raws(tmp_path, 4)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_engine.initialize_engine(path, log_dir=str(tmp_path / "jl"))
    try:
        assert jax_engine.process_batch(paths, W, H, [jdir] * 4,
                                        emitter="native") == (4, 0)
    finally:
        jax_engine.cleanup_resources()
    assert engine.initialize_engine(path, log_dir=str(tmp_path / "pl"),
                                    device="cpu")
    try:
        assert engine.process_batch(paths, W, H, [pdir] * 4) == (4, 0)
    finally:
        engine.cleanup_resources()
    same, with_contours = 0, 0
    for p in paths:
        base = os.path.splitext(os.path.basename(p))[0]
        jm = cv2.imread(os.path.join(jdir, base + "_mask.png"),
                        cv2.IMREAD_UNCHANGED)
        pm = cv2.imread(os.path.join(pdir, base + "_mask.png"),
                        cv2.IMREAD_UNCHANGED)
        assert (jm != pm).mean() <= 0.01
        if not np.array_equal(jm, pm):
            continue
        same += 1
        names = sorted(f for f in os.listdir(jdir) if f.startswith(base))
        assert names == sorted(f for f in os.listdir(pdir)
                               if f.startswith(base))
        with_contours += (base + ".json") in names
        for f in names:
            with open(os.path.join(jdir, f), "rb") as a, \
                    open(os.path.join(pdir, f), "rb") as b:
                assert a.read() == b.read(), f
    assert same >= 2 and with_contours >= 1, (same, with_contours)


@pytest.mark.parametrize("ckpt,calls", [("stem1", 1), ("slim4", 0)])
def test_masks_fuse_the_last_level_for_stem_1_only(tmp_path, monkeypatch,
                                                   ckpt, calls):
    if ckpt == "slim4":
        params, cfg = checkpoint.load(os.path.join(MODELS,
                                                   "flagship_slim4.ckpt"))
    else:  # base 16: a width K6 is built for (base 8 takes the unfused route)
        cfg = ModelConfig(**{**SMALL, "base_channels": 16},
                          compute_dtype="bfloat16")
        params = unet.init(cfg, torch.Generator().manual_seed(2))
    model = registry.build(params, cfg, device="cpu")
    seen = []

    def counting(*ops):
        seen.append(ops[1].shape)
        return fused(*ops)
    fused = unet.dec1_fused_masks
    monkeypatch.setattr(unet, "dec1_fused_masks", counting)
    x = torch.rand((2, 64, 64, 1), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got = model.masks(x)
        want = torch.argmax(model(x), -1).to(torch.uint8)
    assert got.shape == (2, 64, 64) and got.dtype == torch.uint8
    assert len(seen) == calls
    if calls:
        assert seen[0] == (2, 64, 64, cfg.base_channels)
        assert (got != want).float().mean() < 0.01
    else:
        assert torch.equal(got, want)
