"""The port's sliding windows (``unetseg_tpu_torch.parallel.tiles``) and
device preprocess (``ops.preprocess``) against the JAX package on the CPU.

Grids, weights and the preprocess are equal to JAX's; the two blend forms
agree with JAX's at rtol = atol = 1e-5 (``tests/test_parallel.py``'s bar);
float32 logits at atol 2e-4, rtol 1e-3 (JAX's own TTA bar), and masks equal
but at near ties of JAX's logits.  Small seeded models: base 8 and 16,
depth 1 and 2, stem 1 and 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu.ops import preprocess as jax_pre
from unetseg_tpu.parallel import tiles as jax_tiles
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.ops import preprocess
from unetseg_tpu_torch.parallel import tiles

ATOL, RTOL = 2e-4, 1e-3
# (stem, base, depth): alignment stem * 2**depth = 4, 2, 4.
CONFIGS = [(1, 8, 2), (1, 16, 1), (2, 8, 1)]


def _jax_cfg(stem, base, depth):
    return JaxModelConfig(base_channels=base, depth=depth, stem=stem,
                          image_size=32, compute_dtype="float32")


def _params(jcfg, seed=0):
    """JAX init with random biases, so every bias add counts."""
    params = jax.device_get(jax_unet.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)

    def fill(tree):
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            if k == "b":
                tree[k] = rng.standard_normal(v.shape).astype(np.float32) * .1
            elif isinstance(v, (dict, list)):
                fill(v)
    fill(params)
    return params


def _port_model(params, jcfg):
    return registry.build(params, ModelConfig(**dataclasses.asdict(jcfg)),
                          device="cpu")


def _near_tie(logits: np.ndarray, margin: float) -> np.ndarray:
    """Pixels whose top-2 logits lie within ``margin``."""
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2] <= margin


def _assert_masks_equal_but_ties(got, want, logits):
    differ = np.asarray(got) != np.asarray(want)
    tie = _near_tie(np.asarray(logits), 2 * (ATOL + RTOL * np.abs(
        np.asarray(logits)).max()))
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    assert differ.mean() < 0.01


@pytest.mark.parametrize("size,window,stride", [
    (100, 64, 32), (64, 64, 32), (40, 64, 16), (1536, 512, 256),
    (2048, 512, 384), (130, 32, 7), (10, 16, 8)])
def test_window_grid_and_regularity_match_jax(size, window, stride):
    got = tiles.window_grid(size, window, stride)
    assert got == jax_tiles.window_grid(size, window, stride)
    assert tiles._regular_grid(got, stride, window) == \
        jax_tiles._regular_grid(got, stride, window)


@pytest.mark.parametrize("window", [8, 64, 512])
def test_hann_weight_and_coverage_match_jax(window):
    np.testing.assert_array_equal(tiles._hann_weight(window),
                                  jax_tiles._hann_weight(window))
    for h, w, stride in ((window * 3, window * 2 + 5, window // 2),
                         (window, window, window // 4 or 1)):
        np.testing.assert_array_equal(
            tiles._inv_weight_sum(h, w, window, stride),
            jax_tiles._inv_weight_sum(h, w, window, stride))


@pytest.mark.parametrize("h,w,window,stride", [
    (128, 128, 64, 32),   # regular: the overlap-add form
    (96, 160, 32, 8),     # regular, four chunks per window
    (100, 90, 64, 48),    # irregular: the padded-stack form
    (64, 100, 64, 16)])   # one window row: the padded-stack form
def test_blend_matches_jax(h, w, window, stride):
    ys = tiles.window_grid(h, window, stride)
    xs = tiles.window_grid(w, window, stride)
    lt = np.random.default_rng(0).standard_normal(
        (len(ys) * len(xs), window, window, 3)).astype(np.float32)
    got = tiles.blend_windows(torch.from_numpy(lt), h, w, window, stride)
    want = jax_tiles.blend_windows(jnp.asarray(lt), h, w, window, stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_overlap_add_matches_padded_stack(monkeypatch):
    """On a regular grid the overlap-add form equals the padded stack, as in
    tests/test_parallel.py."""
    h = w = 128
    window, stride = 64, 32
    assert tiles._regular_grid(tiles.window_grid(h, window, stride), stride,
                               window)
    lt = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (9, window, window, 3)).astype(np.float32))
    fast = tiles.blend_windows(lt, h, w, window, stride)
    monkeypatch.setattr(tiles, "_regular_grid", lambda *a: False)
    slow = tiles.blend_windows(lt, h, w, window, stride)
    torch.testing.assert_close(fast, slow, rtol=1e-5, atol=1e-5)


def test_invalid_overlap_raises():
    for ov in (64, 100, -1):
        with pytest.raises(ValueError, match="overlap"):
            tiles._resolve_overlap(64, ov)
        with pytest.raises(ValueError):
            jax_tiles._resolve_overlap(64, ov)
    assert tiles._resolve_overlap(64, None) == 32
    model = _port_model(_params(_jax_cfg(1, 8, 1)), _jax_cfg(1, 8, 1))
    with pytest.raises(ValueError, match="overlap"):
        tiles.make_tiled_pipeline(model, window=32, overlap=32)
    with pytest.raises(ValueError, match="overlap"):
        tiles.sliding_window_logits(model, torch.zeros(40, 40), 32, -1)


def test_small_image_is_edge_padded():
    img = np.random.default_rng(2).integers(0, 256, (2, 5, 9), np.uint8)
    got, ph, pw = tiles._pad_to_window(torch.from_numpy(img), 12)
    want, jph, jpw = jax_tiles._pad_to_window(jnp.asarray(img), 12)
    assert (ph, pw) == (jph, jpw) == (7, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.pad(img, ((0, 0), (0, 7), (0, 3)), mode="edge"))
    same, ph, pw = tiles._pad_to_window(torch.from_numpy(img), 5)
    assert (ph, pw) == (0, 0) and torch.equal(same, torch.from_numpy(img))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "s%d_b%d_d%d" % c)
@pytest.mark.parametrize("hw,window,overlap", [
    ((40, 56), 16, None), ((40, 56), 16, 6), ((6, 30), 16, None)],
    ids=["regular", "irregular", "padded"])
def test_sliding_window_logits_match_jax(cfg, hw, window, overlap):
    jcfg = _jax_cfg(*cfg)
    params = _params(jcfg, seed=cfg[0] + cfg[2])
    img = np.random.default_rng(4).random(hw).astype(np.float32)
    want = np.asarray(jax_tiles.sliding_window_logits(
        params, jnp.asarray(img), jcfg, window, overlap))
    got = tiles.sliding_window_logits(_port_model(params, jcfg),
                                      torch.from_numpy(img), window, overlap)
    assert got.shape == want.shape == (*hw, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_chunked_windows_equal_one_batch(monkeypatch):
    """Chunks of 3 windows give the logits of one batch of all 20."""
    jcfg = _jax_cfg(1, 8, 2)
    model = _port_model(_params(jcfg), jcfg)
    img = torch.from_numpy(np.random.default_rng(5).random(
        (48, 80)).astype(np.float32))
    one = tiles.sliding_window_logits(model, img, 16, 8)
    monkeypatch.setattr(tiles, "MODEL_CHUNK", 3)
    chunked = tiles.sliding_window_logits(model, img, 16, 8)
    torch.testing.assert_close(chunked, one, rtol=1e-6, atol=1e-6)
    passes = []
    with torch.inference_mode():
        tiles.chunked_logits(model, torch.zeros(20, 16, 16, 1),
                             lambda: passes.append(1))
    assert len(passes) == 7


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "s%d_b%d_d%d" % c)
@pytest.mark.parametrize("device_post", [False, True],
                         ids=["argmax", "cleaned"])
def test_tiled_pipeline_masks_match_jax(cfg, device_post):
    jcfg = _jax_cfg(*cfg)
    params = _params(jcfg, seed=7)
    rng = np.random.default_rng(6)
    u8 = preprocess.normalize_u8(torch.from_numpy(
        synth_slice(rng, 64)[0][:44, :60]))
    logits = np.asarray(jax_tiles.sliding_window_logits(
        params, jnp.asarray(u8.numpy().astype(np.float32) / 255.0), jcfg,
        16, 4))
    want = np.asarray(jax_tiles.make_tiled_pipeline(
        jcfg, 16, 4, device_postprocess=False)(params, jnp.asarray(u8)))
    model = _port_model(params, jcfg)
    got = tiles.make_tiled_pipeline(model, 16, 4, device_postprocess=False)(u8)
    _assert_masks_equal_but_ties(got.numpy(), want, logits)
    if device_post:
        from unetseg_tpu.ops import postprocess as jax_post

        got_c = tiles.make_tiled_pipeline(model, 16, 4)(u8)
        # Cleaned masks agree where the argmax masks do.
        want_c = np.asarray(jax_post.postprocess_mask(jnp.asarray(
            got.numpy())))
        np.testing.assert_array_equal(got_c.numpy(), want_c)


def test_tiled_batch_pipeline_matches_per_image():
    jcfg = _jax_cfg(2, 8, 1)
    params = _params(jcfg, seed=8)
    model = _port_model(params, jcfg)
    rng = np.random.default_rng(9)
    u8b = torch.from_numpy(rng.integers(0, 256, (3, 36, 50), np.uint8))
    for dev_post in (False, True):
        batch = tiles.make_tiled_batch_pipeline(
            model, 16, None, device_postprocess=dev_post)(u8b)
        single = tiles.make_tiled_pipeline(model, 16, None,
                                           device_postprocess=dev_post)
        for i in range(3):
            assert torch.equal(batch[i], single(u8b[i])), (dev_post, i)
    want = np.asarray(jax_tiles.make_tiled_batch_pipeline(
        jcfg, 16, None, device_postprocess=False)(params, jnp.asarray(u8b)))
    logits = np.stack([np.asarray(jax_tiles.sliding_window_logits(
        params, jnp.asarray(u8b[i].numpy() / np.float32(255.0)), jcfg, 16))
        for i in range(3)])
    got = tiles.make_tiled_batch_pipeline(model, 16, None,
                                          device_postprocess=False)(u8b)
    _assert_masks_equal_but_ties(got.numpy(), want, logits)


# -- the device preprocess ---------------------------------------------------

def _raws():
    rng = np.random.default_rng(10)
    return {"random_768": rng.integers(0, 65536, (768, 768), np.uint16),
            "synth_1536x2048": synth_slice(rng, 2048)[0][:1536],
            "ragged_37x91": rng.integers(3000, 9000, (37, 91), np.uint16),
            "constant": np.full((64, 80), 1234, np.uint16),
            "top_of_range": np.full((16, 16), 65535, np.uint16)}


@pytest.mark.parametrize("name", list(_raws()))
def test_preprocess_matches_jax_bit_for_bit(name):
    raw = _raws()[name]
    t = torch.from_numpy(raw)
    np.testing.assert_array_equal(
        preprocess.normalize_u8(t).numpy(),
        np.asarray(jax_pre.normalize_u8(jnp.asarray(raw))))
    np.testing.assert_array_equal(
        preprocess.resize_normalize_u8(t).numpy(),
        np.asarray(jax_pre.resize_normalize_u8(jnp.asarray(raw))))
    np.testing.assert_array_equal(
        preprocess.model_input_from_u16(t).numpy(),
        np.asarray(jax_pre.model_input_from_u16(jnp.asarray(raw))))
    h, w = raw.shape
    for got, want in zip(preprocess._gather_plan(h, w, 512),
                         jax_pre._gather_plan(h, w, 512)):
        np.testing.assert_array_equal(got, want)


def test_preprocess_batch_matches_jax():
    raws = np.stack([_raws()["random_768"], _raws()["random_768"] // 3,
                     np.full((768, 768), 7, np.uint16)])
    u8, x = preprocess.preprocess_batch(torch.from_numpy(raws), 256)
    ju8, jx = jax_pre.preprocess_batch(jnp.asarray(raws), out_size=256)
    np.testing.assert_array_equal(u8.numpy(), np.asarray(ju8))
    assert x.shape == (3, 256, 256, 1) and x.dtype == torch.float32
    # Eager u8 / 255, as JAX's model_input_from_u8 gives it; the jitted
    # JAX batch may divide by a reciprocal, one f32 ulp away.
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jax_pre.model_input_from_u8(ju8))[..., None])
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2 ** -23,
                               atol=0)
    # The f32 device path and the f64 oracle may part by a gray level at
    # most; on these inputs they agree.
    np.testing.assert_array_equal(
        u8[0].numpy(), preprocess.preprocess_oracle_u8(raws[0], 256))
