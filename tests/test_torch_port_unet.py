"""The port's UNet (models/unet.py) against JAX ``unet.apply``.

float32: logits allclose at 1e-4.  bf16 with the real slim4 weights: argmax
masks agree on >= 99.9% of pixels per slice, against JAX running its Pallas
conv (interpret mode).  bf16 logits are no allclose target: the two sides
round at other places, and JAX's own two conv paths already differ by up to
4.0 in logits at 100% mask agreement.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu import checkpoint as jax_ckpt
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu.ops import pallas_conv
from unetseg_tpu_torch import checkpoint
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.models import registry, unet
from unetseg_tpu_torch.ops import conv
from unetseg_tpu_torch.ops.preprocess import preprocess_oracle_u8

MODELS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models")


def _random_params(jcfg, seed):
    """JAX init, with random biases (init zeroes them) so every bias add
    is exercised."""
    params = jax.device_get(jax_unet.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)

    def fill(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k == "b":
                    tree[k] = rng.standard_normal(v.shape).astype(np.float32) * 0.1
                else:
                    fill(v)
        elif isinstance(tree, list):
            for v in tree:
                fill(v)
    fill(params)
    return params


def _port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("stem,base,size", [(1, 4, 32), (4, 8, 64)])
def test_float32_logits_match_jax(stem, base, size):
    jcfg = JaxModelConfig(base_channels=base, depth=2, stem=stem,
                          image_size=size, compute_dtype="float32")
    params = _random_params(jcfg, seed=stem)
    x = np.random.default_rng(5).random((2, size, size, 1)).astype(np.float32)
    want = np.asarray(jax_unet.apply(params, jnp.asarray(x), jcfg))
    model = registry.build(params, _port_cfg(jcfg), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_slim4_bf16_masks_match_jax_pallas(monkeypatch):
    params, jcfg = jax_ckpt.load(os.path.join(MODELS, "flagship_slim4.ckpt"))
    jcfg = dataclasses.replace(jcfg, conv_impl="experimental_pallas")
    monkeypatch.setattr(pallas_conv, "conv3x3_bias_act", functools.partial(
        pallas_conv.conv3x3_bias_act, interpret=True))
    rng = np.random.default_rng(11)
    u8 = np.stack([preprocess_oracle_u8(synth_slice(rng, 128)[0], 128)
                   for _ in range(4)])
    x = (u8.astype(np.float32) / 255.0)[..., None]
    want = np.asarray(jnp.argmax(jax_unet.apply(params, jnp.asarray(x), jcfg),
                                 axis=-1))

    cfg = checkpoint.load(os.path.join(MODELS, "flagship_slim4.ckpt"))[1]
    model = registry.build(params, cfg, device="cpu")
    assert model.head_weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = torch.argmax(model(torch.from_numpy(x)), dim=-1).numpy()
    agree = (got == want).reshape(4, -1).mean(axis=1)
    assert agree.min() >= 0.999, agree
    assert (want == 2).any()  # the slices do hold foreground


def test_up_conv_matches_lax_conv_transpose():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 5, 6)).astype(np.float32)
    w = rng.standard_normal((2, 2, 6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jax_unet._conv_transpose(
        jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        dtype=jnp.float32))
    up = unet.UpConv(6, 4)
    up.weight.data = torch.from_numpy(checkpoint.up_weight_from_hwio(w).copy())
    up.bias.data = torch.from_numpy(b)
    got = up(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 6, 10, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # torch's own transposed conv does NOT flip: the flip is what pins it
    plain = torch.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                   torch.from_numpy(w).permute(2, 3, 0, 1),
                                   stride=2).permute(0, 2, 3, 1).numpy() + b
    assert not np.allclose(plain, want, atol=1e-3)


def test_depth_to_space_head_order_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 48)).astype(np.float32)
    want = np.asarray(jax_unet._depth_to_space(jnp.asarray(x), 4))
    got = unet.depth_to_space(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        unet.space_to_depth(got, 4).numpy(),
        np.asarray(jax_unet._space_to_depth(jnp.asarray(want), 4)))
    # pixel_shuffle orders channels (c, dy, dx) and disagrees on 48 channels
    ps = torch.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 4)
    assert not np.array_equal(ps.permute(0, 2, 3, 1).numpy(), want)


def test_max_pool_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 6, 8, 5)).astype(np.float32)
    want = np.asarray(jax_unet._max_pool_2x2(jnp.asarray(x)))
    np.testing.assert_array_equal(unet.max_pool_2x2(torch.from_numpy(x)).numpy(),
                                  want)


def test_f16_weights_round_once_to_bf16_as_astype():
    bits = np.arange(0, 1 << 16, dtype=np.uint16)
    f16 = bits.view(np.float16)
    f16 = f16[np.isfinite(f16)]
    want = np.asarray(jnp.asarray(f16).astype(jnp.bfloat16)).view(np.uint16)
    # the module's path: f16 copied into a float32 parameter, then .to(bf16)
    p = torch.nn.Parameter(torch.zeros(f16.size), requires_grad=False)
    p.data.copy_(torch.from_numpy(f16))
    got = p.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_slim4_forward_runs_ten_convs(monkeypatch):
    params, cfg = checkpoint.load(os.path.join(MODELS, "flagship_slim4.ckpt"))
    model = registry.build(params, cfg, device="cpu")
    convs = [m for m in model.modules() if isinstance(m, unet.Conv3x3)]
    assert [m.weight.shape[2] for m in convs] == [
        16, 64, 64, 128, 128, 256, 256, 128, 128, 64]
    calls = []
    orig = conv.conv3x3_bias_act_plain

    def spy(x, w, b, relu=True):
        calls.append(tuple(x.shape))
        return orig(x, w, b, relu)

    monkeypatch.setattr(conv, "conv3x3_bias_act_plain", spy)
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 32, 1))
    assert len(calls) == 10 and out.shape == (1, 32, 32, 3)
