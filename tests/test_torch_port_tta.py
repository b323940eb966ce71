"""The port's TTA ensemble (``unetseg_tpu_torch.parallel.tta``) against the
JAX package on the CPU.

Transforms, perms and transformed weights are equal to JAX's; float32
ensemble logits agree at atol 2e-4, rtol 1e-3 (JAX's own bar,
``tests/test_parallel.py``) and masks are equal but at near ties of JAX's
logits.  Small seeded models: base 8 and 16, depth 1 and 2, stem 1, 2 and 4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import registry as jax_registry
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu.parallel import tta as jax_tta
from unetseg_tpu_torch import engine
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.parallel import tta

ATOL, RTOL = 2e-4, 1e-3
# (stem, base, depth)
CONFIGS = [(1, 8, 2), (1, 16, 1), (2, 8, 1), (4, 8, 1)]


def _params(jcfg, seed):
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


def _assert_masks_equal_but_ties(got, want, logits):
    """Masks equal but where JAX's top-2 logits lie within the logits'
    tolerance (twice ATOL + RTOL of the largest)."""
    differ = np.asarray(got) != np.asarray(want)
    top = np.sort(logits, axis=-1)
    tie = top[..., -1] - top[..., -2] <= 2 * (ATOL + RTOL * np.abs(
        logits).max())
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    assert differ.mean() < 0.01


def _cfgs(stem, base, depth, num_classes=3):
    jcfg = JaxModelConfig(base_channels=base, depth=depth, stem=stem,
                          num_classes=num_classes, image_size=32,
                          compute_dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _u8(n=2, size=32, seed=23):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size),
                                                np.uint8)


@pytest.mark.parametrize("k", range(8))
def test_dihedral_matches_jax(k):
    a = np.random.default_rng(k).standard_normal((6, 6, 3)).astype(np.float32)
    got = tta.dihedral(torch.from_numpy(a), k)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_tta.dihedral(jnp.asarray(a), k)))
    np.testing.assert_array_equal(
        tta.dihedral_inverse(got, k).numpy(), a)
    np.testing.assert_array_equal(
        tta.dihedral_inverse(torch.from_numpy(a), k).numpy(),
        np.asarray(jax_tta.dihedral_inverse(jnp.asarray(a), k)))
    w = np.random.default_rng(10 + k).standard_normal(
        (3, 3, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tta._kernel_dihedral_inv(w, k),
        np.asarray(jax_tta._kernel_dihedral_inv(jnp.asarray(w), k)))


@pytest.mark.parametrize("r", [2, 4])
def test_space_to_depth_perms_match_jax(r):
    for k in range(8):
        assert tta._s2d_perm(r, k) == jax_tta._s2d_perm(r, k), k
        assert tta._d2s_perm(r, 3, k) == jax_tta._d2s_perm(r, 3, k), k


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "s%d_b%d_d%d" % c)
def test_transform_params_dihedral_matches_jax(cfg):
    jcfg, pcfg = _cfgs(*cfg)
    params = _params(jcfg, seed=cfg[0])
    for k in range(8):
        got = tta.transform_params_dihedral(params, pcfg, k)
        want = jax_tta.transform_params_dihedral(params, jcfg, k)
        leaves, tree = jax.tree_util.tree_flatten(got)
        want_leaves, want_tree = jax.tree_util.tree_flatten(want)
        assert tree == want_tree
        for a, b in zip(leaves, want_leaves):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, np.asarray(b))


def _jax_ensemble_logits(params, jcfg, u8):
    """The weight-space ensemble's mean logits, as JAX's test computes
    them."""
    x = jnp.asarray((u8.astype(np.float32) / 255.0)[..., None])
    acc = 0
    for k in range(tta.N_TRANSFORMS):
        th = jax_tta.transform_params_dihedral(params, jcfg, k)
        acc = acc + np.asarray(jax_registry.apply(th, x, jcfg))
    return acc / tta.N_TRANSFORMS


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "s%d_b%d_d%d" % c)
def test_weight_space_ensemble_matches_jax(cfg):
    """Each variant's logits against JAX's on the transformed weights, and
    the weight-space ensemble against the activation-space one (the
    equivariance), in float32."""
    jcfg, pcfg = _cfgs(*cfg)
    params = _params(jcfg, seed=3)
    u8 = _u8()
    x = torch.from_numpy(u8.astype(np.float32) / 255.0)[..., None]
    variants = tta.weight_variants(params, pcfg, "cpu")
    assert len(variants) == tta.N_TRANSFORMS
    ws = 0
    with torch.inference_mode():
        for k, model in enumerate(variants):
            lg = model(x)
            want = jax_registry.apply(
                jax_tta.transform_params_dihedral(params, jcfg, k),
                jnp.asarray(x.numpy()), jcfg)
            np.testing.assert_allclose(lg.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=RTOL)
            ws = ws + lg
        ws = ws / tta.N_TRANSFORMS
        model = registry.build(params, pcfg, "cpu")
        act = 0
        for k in range(tta.N_TRANSFORMS):
            xv = torch.stack([tta.dihedral(x[i], k) for i in range(2)])
            lg = model(xv)
            act = act + torch.stack([tta.dihedral_inverse(lg[i], k)
                                     for i in range(2)])
        act = act / tta.N_TRANSFORMS
    torch.testing.assert_close(ws, act, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ws.numpy(), _jax_ensemble_logits(
        params, jcfg, u8), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cfg", CONFIGS[:3], ids=lambda c: "s%d_b%d_d%d" % c)
@pytest.mark.parametrize("device_post", [False, True],
                         ids=["argmax", "cleaned"])
def test_tta_pipelines_match_jax(cfg, device_post):
    """The three pipelines' masks against JAX's weight-space masks: equal
    but at near ties; with the cleanup, equal where the argmax is."""
    jcfg, pcfg = _cfgs(*cfg)
    params = _params(jcfg, seed=4)
    u8 = _u8(seed=24)
    logits = _jax_ensemble_logits(params, jcfg, u8)
    want = np.asarray(jax_tta.make_tta_weightspace_pipeline(jcfg)(
        params, jnp.asarray(u8)))
    model = registry.build(params, pcfg, "cpu")
    t = torch.from_numpy(u8)
    ws = tta.make_tta_weightspace_pipeline(params, pcfg, "cpu")(t)
    act = torch.stack([tta.make_tta_pipeline(model, False)(t[i])
                       for i in range(2)])
    batch = tta.make_tta_batch_pipeline(model)(t)
    for got in (ws, act, batch):
        assert got.dtype == torch.uint8 and got.shape == u8.shape
        _assert_masks_equal_but_ties(got.numpy(), want, logits)
    if device_post:
        from unetseg_tpu.ops import postprocess as jax_post

        want_c = np.asarray(jax_post.postprocess_masks(jnp.asarray(
            ws.numpy())))
        got_c = tta.make_tta_weightspace_pipeline(
            params, pcfg, "cpu", device_postprocess=True)(t)
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        for i in range(2):
            np.testing.assert_array_equal(
                tta.make_tta_pipeline(model)(t[i]).numpy(),
                np.asarray(jax_post.postprocess_mask(jnp.asarray(
                    act[i].numpy()))))
        np.testing.assert_array_equal(
            tta.make_tta_batch_pipeline(model, True)(t).numpy(),
            np.asarray(jax_post.postprocess_masks(jnp.asarray(
                batch.numpy()))))


def test_engine_builds_the_variants_once(monkeypatch):
    """``infer_tta`` builds the 8 weight variants at its first call only,
    and counts 8 model passes per call."""
    jcfg, pcfg = _cfgs(2, 8, 1)
    params = _params(jcfg, seed=5)
    eng = engine.InferenceEngine(params, pcfg, device="cpu")
    built = []
    real_build = registry.build
    monkeypatch.setattr(registry, "build",
                        lambda *a, **kw: built.append(1) or real_build(*a, **kw))
    u8 = _u8(n=1, seed=25)[0]
    first = eng.infer_tta(u8)
    assert len(built) == tta.N_TRANSFORMS and eng.forwards == 8
    assert torch.equal(eng.infer_tta(u8), first)
    assert len(built) == tta.N_TRANSFORMS and eng.forwards == 16
    want = tta.make_tta_weightspace_pipeline(params, pcfg, "cpu")(
        torch.from_numpy(u8)[None])[0]
    assert torch.equal(first, want)
