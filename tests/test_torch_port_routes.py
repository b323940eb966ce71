"""Configs the card used to refuse, on the CPU: each fault, then its repair.

1. A stem-1 model whose last level K6 is not built for (C outside
   ``dec1.KERNEL_CHANNELS`` or more than ``dec1.MAX_CLASSES`` classes) takes
   the unfused route, chosen from the config when the model is built; its
   masks equal JAX ``unet.apply``'s argmax in float32.
2. A conv with D not a multiple of 16 reaches the kernel with its weight's
   output columns and bias zero-padded, and is sliced back: exact.
3. ``compute_dtype="float32"`` on CUDA was refused by ``registry.build``
   (P13); the card now serves it through K8, so on a host without CUDA it
   passes the dtype check and fails only the CUDA check, which
   ``initialize_engine`` logs; float32 models take the unfused route (K6 is
   bf16 only).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu import checkpoint as jax_ckpt
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu_torch import checkpoint, engine
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import registry, unet
from unetseg_tpu_torch.ops import conv, dec1
from unetseg_tpu_torch.ops.decode import decode_mask

SLIM4 = ModelConfig(stem=4, depth=2)
#: (config, route): the flagship, slim4, a wide flagship, the 12-class
#: stem-1 config of benchmarks/exp_slim_arch.py, and a narrow one.
ROUTES = [(ModelConfig(), "fused"), (SLIM4, "unfused"),
          (ModelConfig(base_channels=128), "unfused"),
          (ModelConfig(in_channels=4, num_classes=12), "unfused"),
          (ModelConfig(base_channels=8), "unfused"),
          (ModelConfig(base_channels=16, num_classes=8), "fused")]


@pytest.mark.parametrize("cfg,route", ROUTES)
def test_route_is_chosen_from_the_config(cfg, route):
    assert unet.last_level_route(cfg) == route
    takes = dec1.kernel_takes(cfg.base_channels, cfg.num_classes)
    assert takes == (cfg.base_channels in dec1.KERNEL_CHANNELS
                     and cfg.num_classes <= dec1.MAX_CLASSES)
    if cfg.stem == 1 and not takes:
        # The fault: K6's plan refuses the width, or the wrapper the classes.
        if cfg.base_channels not in dec1.KERNEL_CHANNELS:
            with pytest.raises(ValueError, match="dec1 tile plan"):
                dec1.tile_plan(1, 64, 64, cfg.base_channels)
        assert not dec1.kernel_takes(cfg.base_channels, cfg.num_classes)


def _numpy_params(jcfg, seed):
    """A JAX-layout parameter tree filled from a seeded numpy generator:
    He-scaled weights, small random biases."""
    shapes = jax.eval_shape(lambda k: jax_unet.init(k, jcfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "b":
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape)
                * np.sqrt(2.0 / fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


# (base, depth, classes, in_channels): a width K6 is not built for (8,
# 128), and more classes than K6 takes (12, with 4 input channels).
UNFUSED = [(8, 2, 3, 1), (128, 1, 3, 1), (16, 2, 12, 4), (8, 1, 12, 1)]


@pytest.mark.parametrize("base,depth,classes,cin", UNFUSED)
def test_unfused_route_masks_match_jax_apply(monkeypatch, base, depth,
                                             classes, cin):
    jcfg = JaxModelConfig(base_channels=base, depth=depth, image_size=64,
                          num_classes=classes, in_channels=cin,
                          compute_dtype="float32")
    params = _numpy_params(jcfg, seed=base + classes)
    x = np.random.default_rng(depth).random((2, 64, 64, cin)).astype(
        np.float32)
    logits = np.asarray(jax_unet.apply(params, jnp.asarray(x), jcfg))
    model = registry.build(params, ModelConfig(**dataclasses.asdict(jcfg)),
                           device="cpu")
    assert model.route == "unfused"

    def refuse(*ops):
        raise AssertionError("K6 called on the unfused route")
    monkeypatch.setattr(unet, "dec1_fused_masks", refuse)
    with torch.inference_mode():
        got = model.masks(torch.from_numpy(x))
        assert torch.equal(got, decode_mask(model(torch.from_numpy(x)),
                                            classes))
    assert got.shape == (2, 64, 64) and got.dtype == torch.uint8
    want = logits.argmax(-1)
    # float32 logits agree to 1e-4 (test_torch_port_unet.py): the masks
    # agree wherever JAX's top-2 margin exceeds that.
    top2 = np.sort(logits, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    assert clear.mean() > 0.99
    assert len(np.unique(want)) > 1


@pytest.mark.parametrize("d", [8, 20, 16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_output_channel_padding_is_exact(d, dtype):
    g = torch.Generator().manual_seed(d)
    x = torch.rand((2, 9, 11, 16), generator=g).to(dtype)
    w = (torch.randn((3, 3, 16, d), generator=g) / 12).to(dtype)
    b = (torch.randn(d, generator=g) * 0.1).to(dtype)
    wp, bp = conv.pad_output_channels(w, b)
    assert wp.shape[3] == bp.shape[0] == d + -d % 16
    if d % 16 == 0:
        assert wp is w and bp is b
        return
    # The fault: the kernel's plan refuses D; the padded D it takes.
    with pytest.raises(ValueError, match="multiples of 16"):
        conv.tile_plan(2, 9, 11, 16, d)
    conv.tile_plan(2, 9, 11, 16, wp.shape[3])
    assert torch.equal(wp[..., :d], w) and not wp[..., d:].any()
    assert torch.equal(bp[:d], b) and not bp[d:].any()
    got = conv.conv3x3_bias_act_plain(x, wp, bp)[..., :d]
    assert torch.equal(got, conv.conv3x3_bias_act_plain(x, w, b))


def _f32_ckpt(tmp_path):
    jcfg = JaxModelConfig(base_channels=8, depth=1, image_size=32,
                          compute_dtype="float32")
    path = str(tmp_path / "m" / "model.ckpt")
    os.makedirs(os.path.dirname(path))
    jax_ckpt.save(path, _numpy_params(jcfg, 0), jcfg)
    return path


def test_f32_on_cuda_is_refused_with_the_reason(tmp_path, monkeypatch):
    path = _f32_ckpt(tmp_path)
    params, cfg = checkpoint.load(path)
    model = registry.build(params, cfg, device="cpu")
    assert model.head_weight.dtype == torch.float32
    assert model.route == "unfused"  # K6 is bf16 only
    assert unet.last_level_route(dataclasses.replace(
        cfg, base_channels=64, compute_dtype="bfloat16")) == "fused"
    assert unet.last_level_route(dataclasses.replace(
        cfg, base_channels=64)) == "unfused"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.build(params, cfg, device="cuda")
    log_dir = str(tmp_path / "log")
    assert not engine.initialize_engine(path, log_dir=log_dir)
    try:
        assert engine.get_engine() is None
    finally:
        engine.cleanup_resources()
    text = "".join(open(f).read() for f in glob.glob(
        os.path.join(log_dir, "*.txt")))
    assert "Initialization error" in text and "CUDA" in text
    assert "ROADMAP.md" not in text
