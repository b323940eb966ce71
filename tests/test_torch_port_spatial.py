"""The port's spatial (sp) split (``parallel/spatial.py``, the band helpers
of ``parallel/mesh.py``, ``make_sharded_pipeline(spatial=True)`` and
``make_sharded_train_step`` over ``(dp, sp)``) on the CPU, against the JAX
package's ``P("dp", "sp")`` paths on its 8 virtual devices
(tests/test_parallel.py) and against the port's own unsplit forms.

The port's stand-in for the virtual devices is a device list that repeats
``"cpu"``: the split is by position.  The sizes are the JAX tests' (base
8, depth 2, 64², float32; training base 4, depth 2, 32²).  Bars: the halo
slabs bit-equal to the zero-padded tensor's rows; one banded conv and its
gradients within 1e-12 of the whole conv in float64; the pipeline's masks
``array_equal`` to JAX's; float32 logits within 1e-5 of JAX's
``registry.apply`` (``test_sharded_forward_matches_plain``'s bar); bf16
masks equal to the one-device forward's but at near ties
(``dec1.near_tie_sums``, 4 ulps); the sp train step's first loss within
rtol 1e-4 of JAX's, its losses falling as JAX's tests require, and its
parameters after two steps within 1e-5 of the one-device step's.
"""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unetseg_tpu import train as jax_train
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import registry as jax_registry
from unetseg_tpu.parallel import batch as jax_batch, mesh as jax_mesh
from unetseg_tpu_torch import engine, train
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.ops import conv, dec1
from unetseg_tpu_torch.parallel import batch, mesh, spatial

SIZE = 64
CPU = torch.device("cpu")
# name -> ModelConfig keywords beyond base 8, depth 2, 64², float32
FAMILIES = {
    "unet_stem1": {},
    "unet_stem2": dict(stem=2),
    "unetpp": dict(arch="unetpp"),
    "unetpp_ds": dict(arch="unetpp", deep_supervision=True),
    "attention_unet": dict(arch="attention_unet"),
}


def _cfgs(**kw):
    kw = {**dict(base_channels=8, depth=2, image_size=SIZE,
                 compute_dtype="float32"), **kw}
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _params(jcfg, seed=0):
    return jax.device_get(jax_registry.init(jax.random.key(seed), jcfg))


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("h, sp, unit, want", [
    (64, 4, 4, [16, 16, 16, 16]),
    (64, 3, 4, [24, 20, 20]),        # uneven: the first band one unit more
    (64, 8, 16, [16] * 4 + [0] * 4),  # fewer units than bands: empty bands
    (16, 16, 1, [1] * 16),           # one row a band
])
def test_band_rows(h, sp, unit, want):
    rows = mesh.band_rows(h, sp, unit)
    assert [len(r) for r in rows] == want
    assert [i for r in rows for i in r] == list(range(h))


@pytest.mark.parametrize("h, sp, unit", [(64, 4, 4), (64, 3, 4), (64, 8, 16),
                                         (16, 16, 1), (5, 1, 1)])
def test_halo_slabs_are_the_padded_rows(h, sp, unit):
    t = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, h, 7, 3)).astype(np.float32))
    parts = mesh.split_rows(t, [CPU] * sp, unit)
    bands = spatial.Bands.of(parts)
    assert len(bands.parts) == sum(1 for p in parts if p.shape[1])
    padded = F.pad(t, (0, 0, 0, 0, 1, 1))
    slabs = spatial.halo_slabs(bands.parts)
    start = 0
    for band, slab in zip(bands.parts, slabs):
        stop = start + band.shape[1]
        assert torch.equal(slab, padded[:, start:stop + 2])
        start = stop
    assert start == h
    assert torch.equal(spatial.gather(bands, CPU), t)


@pytest.mark.parametrize("sp, unit", [(2, 1), (3, 2), (8, 4), (32, 1)])
def test_banded_conv_equals_the_whole_conv_in_float64(sp, unit):
    """``conv3x3_bias_act_train`` on bands, forward and backward, against
    the whole tensor's, in float64 (the plain conv): uneven, empty and
    one-row bands."""
    g = torch.Generator().manual_seed(2)
    x, w, b, r = (torch.randn(s, generator=g, dtype=torch.float64)
                  for s in ((2, 16, 9, 5), (3, 3, 5, 6), (6,), (2, 16, 9, 6)))
    whole = [t.clone().requires_grad_(True) for t in (x, w, b)]
    banded = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want = conv.conv3x3_bias_act_train(*whole)
    (want * r).sum().backward()
    xb = spatial.split(banded[0], [CPU] * sp, unit)
    got = spatial.gather(conv.conv3x3_bias_act_train(xb, *banded[1:]), CPU)
    (got * r).sum().backward()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    for a, e in zip(banded, whole):
        torch.testing.assert_close(a.grad, e.grad, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n, sp, jax_n, jax_sp, kw", [
    (8, 4, 8, 4, {}),                        # dp 2 x sp 4
    (2, 2, 8, 4, {}),                        # dp 1 x sp 2
    (8, 8, 8, 8, dict(stem=2, depth=3)),     # f = 16: 4 bands, 4 empty
], ids=["dp2_sp4", "dp1_sp2", "empty_bands"])
def test_spatial_pipeline_matches_jax(n, sp, jax_n, jax_sp, kw):
    jcfg, cfg = _cfgs(**kw)
    params = _params(jcfg)
    u8 = _u8((2, SIZE, SIZE), seed=1)
    fn = batch.make_sharded_pipeline(
        cfg, mesh.make_mesh(n, sp=sp, devices=["cpu"] * n), spatial=True)
    got = fn(params, torch.from_numpy(u8))
    want = np.asarray(jax_batch.make_sharded_pipeline(
        jcfg, jax_mesh.make_mesh(jax_n, sp=jax_sp), spatial=True)(
            params, jnp.asarray(u8)))
    assert got.device == CPU and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    one = engine.InferenceEngine(params, cfg, device="cpu",
                                 device_postprocess=True)
    assert torch.equal(got, one._pipeline(torch.from_numpy(u8)))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_banded_logits_match_jax(name):
    jcfg, cfg = _cfgs(**FAMILIES[name])
    params = _params(jcfg, 3)
    x = np.random.default_rng(4).random((2, SIZE, SIZE, 1)).astype(
        np.float32)
    model = registry.build(params, cfg, "cpu")
    with torch.inference_mode():
        bands = spatial.split(torch.from_numpy(x), [CPU] * 4,
                              spatial.row_unit(cfg))
        got = spatial.gather(model(bands), CPU)
    want = np.asarray(jax_registry.apply(params, jnp.asarray(x), jcfg))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["unet_stem1", "unet_stem2", "unetpp",
                                  "attention_unet"])
def test_bf16_banded_masks_match_the_one_device_forward(name):
    """bf16 models at base 16 (a stem-1 UNet takes K6's fused route on one
    device, the bands the unfused one): masks equal to the one-device
    forward's but at near ties of its logits."""
    jcfg, cfg = _cfgs(**FAMILIES[name], base_channels=16,
                      compute_dtype="bfloat16")
    params = _params(jcfg, 5)
    x = torch.from_numpy(np.random.default_rng(6).random(
        (2, SIZE, SIZE, 1)).astype(np.float32))
    model = registry.build(params, cfg, "cpu")
    assert model.route == ("fused" if name == "unet_stem1" else "unfused")
    with torch.inference_mode():
        got = spatial.gather(model.masks(spatial.split(
            x, [CPU] * 4, spatial.row_unit(cfg))), CPU)
        want = model.masks(x)
        logits, absum = chip_smoke.head_sums(torch, model, x)
    differ = got != want
    tie = dec1.near_tie_sums(logits, absum, ulps=4)
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    assert differ.float().mean() < 0.01


def test_rows_that_do_not_cut_raise_the_unsplit_error():
    jcfg, cfg = _cfgs(stem=2)
    params = _params(jcfg)
    model = registry.build(params, cfg, "cpu")
    fn = batch.make_sharded_pipeline(
        cfg, mesh.make_mesh(2, sp=2, devices=["cpu"] * 2), spatial=True)
    for h in (66, 68, 70):  # stem, first and second max-pool
        with pytest.raises(RuntimeError) as want:
            with torch.inference_mode():
                model(torch.zeros((2, h, SIZE, 1)))
        with pytest.raises(RuntimeError) as got:
            fn(params, torch.zeros((2, h, SIZE), dtype=torch.uint8))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# training over (dp, sp)
# ---------------------------------------------------------------------------

TRAIN = dict(base_channels=4, depth=2, image_size=32,
             compute_dtype="float32")


def _train_batch(seed, distill=False):
    rng = np.random.default_rng(seed)
    imgs = rng.random((8, 32, 32, 1)).astype(np.float32)
    labels = (rng.random((8, 32, 32)) > 0.5).astype(np.int32) * 2
    if not distill:
        return imgs, labels
    return imgs, labels, rng.random((8, 32, 32, 3)).astype(np.float32)


def _kw(distill):
    """JAX's sp tests' step options, steps and schedule length."""
    if distill:
        return dict(distill=True, boundary_boost=3.0), 4, 50
    return {}, 5, 100


@pytest.fixture(scope="module")
def jax_first_loss():
    """distill -> the first loss of JAX's step over ``make_mesh(8, sp=2)``
    (one compile per mode; remat does not change the loss)."""
    out = {}

    def get(distill):
        if distill not in out:
            kw, _, total = _kw(distill)
            jcfg = JaxModelConfig(**TRAIN)
            params = _params(jcfg)
            tx = jax_train.make_optimizer(lr=1e-2, total_steps=total)
            state = jax_train.TrainState(params, tx.init(params),
                                         jnp.zeros((), jnp.int32))
            out[distill] = float(jax_train.make_sharded_train_step(
                jcfg, jax_mesh.make_mesh(8, sp=2), tx, **kw)(
                    state, tuple(jnp.asarray(a) for a in _train_batch(
                        6 + distill, distill)))[1])
        return out[distill]
    return get


@pytest.mark.parametrize("distill", [False, True], ids=["seg", "distill"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_sp_step_learns_as_jax(remat, distill, jax_first_loss):
    """JAX's sp tests (``test_sharded_train_step_runs_and_learns``, 5 steps
    at lr 1e-2; ``test_sharded_distill_step_with_boundary_boost``, 4 steps
    with boost 3) over sp = 2 (``["cpu"] * 2``: the batch whole, its rows
    in two bands; dp 2 x sp 2 is the next test's): finite losses that
    fall, the first within rtol 1e-4 of JAX's step over
    ``make_mesh(8, sp=2)`` on the same batch and weights."""
    kw, steps, total = _kw(distill)
    cfg = ModelConfig(**TRAIN, remat=remat)
    tx = train.make_optimizer(lr=1e-2, total_steps=total)
    state = train.state_from_params(_params(JaxModelConfig(**TRAIN)), tx,
                                    "cpu")
    step = train.make_sharded_train_step(
        cfg, mesh.make_mesh(2, sp=2, devices=["cpu"] * 2), tx, **kw)
    b = _train_batch(6 + distill, distill)
    losses = []
    for _ in range(steps):
        state, loss = step(state, b)
        losses.append(float(loss))
    np.testing.assert_allclose(losses[0], jax_first_loss(distill), rtol=1e-4)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.step == steps


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_sp_step_equals_the_one_device_step(remat):
    """``make_sharded_train_step`` over dp 2 x sp 2 (boundary weights,
    distillation) against the one-device step: the gradients, and after two
    steps the loss and the parameters within 1e-5 (the dp step's bar,
    tests/test_torch_port_train.py)."""
    cfg = ModelConfig(**TRAIN, remat=remat)
    params = _params(JaxModelConfig(**TRAIN), 11)
    b = _train_batch(12, distill=True)
    tx = train.make_optimizer(lr=1e-2, total_steps=20)
    kw = dict(boundary_boost=3.0, distill=True, alpha=0.4, temperature=1.5)
    sp_mesh = mesh.make_mesh(4, sp=2, devices=["cpu"] * 4)
    one = train.make_sharded_train_step(
        cfg, mesh.make_mesh(devices=["cpu"]), tx, **kw)
    two = train.make_sharded_train_step(cfg, sp_mesh, tx, **kw)
    s1, s2 = (train.state_from_params(params, tx, "cpu") for _ in range(2))
    g1 = train.loss_and_grads(s1.params, b, cfg, **kw)[1]
    g2 = train.loss_and_grads(s1.params, b, cfg, devices=[CPU, CPU],
                              bands=[[CPU, CPU]] * 2, **kw)[1]
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=1e-5, atol=1e-7)
    for _ in range(2):
        s1, l1 = one(s1, b)
        s2, l2 = two(s2, b)
        np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for k in s1.params:
        torch.testing.assert_close(s2.params[k], s1.params[k], rtol=1e-5,
                                   atol=1e-5)
