"""The port's model zoo (``models/unetpp.py``, ``models/attention_unet.py``,
``models/registry.py``) against the JAX package on the CPU.

float32: logits allclose to JAX ``registry.apply`` at 1e-4 (the bar of
``test_torch_port_unet.py``).  bf16, against JAX running its Pallas conv in
interpret mode (the convs round once, as K1 does), with the head bias
centred so every class occurs: every differing pixel a near tie within 4
bf16 ulps of its absolute head sum (``dec1.near_tie_sums``, the card's
rule), and argmax masks equal on >= 98.5% of pixels per slice.  The 99.9%
of the trained slim4 test is out of reach for seeded random weights: their
centred logits sit within a few bf16 ulps of a tie at 0.5-1.3% of the
pixels (UNet++ chains six convs at full resolution), so the f32 summation
orders of the two convs decide those; the plain UNet, held the same way
here, agrees on 99.5%.  The attention gate alone is held bit for bit.  Seeded numpy weights with random biases, so
every bias add counts; UNet++ with and without deep supervision, Attention
U-Net at stem 1 and 2; depth 1-2, base 8-16, 32²-64².
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unetseg_tpu import checkpoint as jax_ckpt
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import attention_unet as jax_attention
from unetseg_tpu.models import registry as jax_registry
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu.models import unetpp as jax_unetpp
from unetseg_tpu.ops import pallas_conv
from unetseg_tpu.parallel import tta as jax_tta
from unetseg_tpu_torch import checkpoint
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.models import attention_unet, registry, unet, unetpp
from unetseg_tpu_torch.ops import conv, dec1
from unetseg_tpu_torch.ops.preprocess import preprocess_oracle_u8
from unetseg_tpu_torch.parallel import tta

# name -> ModelConfig keywords (image_size is the test's input side)
CASES = {
    "unet_d2_b8": dict(arch="unet", base_channels=8, depth=2, image_size=64),
    "unetpp_d2_b8": dict(arch="unetpp", base_channels=8, depth=2,
                         image_size=64),
    "unetpp_d1_b16": dict(arch="unetpp", base_channels=16, depth=1,
                          image_size=32),
    "unetpp_ds_d2_b8": dict(arch="unetpp", base_channels=8, depth=2,
                            image_size=64, deep_supervision=True),
    "attention_d2_b8": dict(arch="attention_unet", base_channels=8, depth=2,
                            image_size=64),
    "attention_d1_b16": dict(arch="attention_unet", base_channels=16,
                             depth=1, image_size=32),
    "attention_stem2_d2_b8": dict(arch="attention_unet", base_channels=8,
                                  depth=2, stem=2, image_size=64),
}
JAX_MODULES = {"unetpp": jax_unetpp, "attention_unet": jax_attention}
PORT_MODULES = {"unetpp": unetpp, "attention_unet": attention_unet}


def _params(jcfg, seed):
    """JAX init with random biases (init zeroes them)."""
    params = jax.device_get(jax_registry.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)

    def fill(tree):
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            if k == "b":
                tree[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                    np.float32)
            elif isinstance(v, (dict, list)):
                fill(v)
    fill(params)
    return params


def _cfgs(name, **extra):
    jcfg = JaxModelConfig(**{**CASES[name], **extra})
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _head_sites(params):
    return params["heads"] if "heads" in params else [params["head"]]


@pytest.mark.parametrize("name", list(CASES))
def test_float32_logits_match_jax(name):
    jcfg, cfg = _cfgs(name, compute_dtype="float32")
    params = _params(jcfg, seed=len(name))
    size = jcfg.image_size
    x = np.random.default_rng(5).random((2, size, size, 1)).astype(np.float32)
    want = np.asarray(jax_registry.apply(params, jnp.asarray(x), jcfg))
    model = registry.build(params, cfg, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the masks route: the argmax of the logits (K6 is the plain UNet's)
    assert model.route == "unfused"
    with torch.no_grad():
        assert torch.equal(model.masks(torch.from_numpy(x)),
                           got.argmax(-1).to(torch.uint8))


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_masks_match_jax_pallas(name, monkeypatch):
    jcfg, cfg = _cfgs(name)
    params = _params(jcfg, seed=len(name) + 1)
    size = jcfg.image_size
    rng = np.random.default_rng(11)
    u8 = np.stack([preprocess_oracle_u8(synth_slice(rng, 96)[0], size)
                   for _ in range(3)])
    x = (u8.astype(np.float32) / 255.0)[..., None]
    # centre the head bias on the logits, so every class occurs
    logits = np.asarray(jax_registry.apply(params, jnp.asarray(x), jcfg))
    shift = np.median(logits.reshape(-1, jcfg.num_classes), axis=0)
    for site in _head_sites(params):
        site["b"] = (site["b"] - np.repeat(shift, jcfg.stem ** 2)).astype(
            np.float32)
    monkeypatch.setattr(pallas_conv, "conv3x3_bias_act", functools.partial(
        pallas_conv.conv3x3_bias_act, interpret=True))
    pcfg = dataclasses.replace(jcfg, conv_impl="experimental_pallas")
    want_logits = torch.from_numpy(np.asarray(jax_registry.apply(
        params, jnp.asarray(x), pcfg)))
    model = registry.build(params, cfg, device="cpu")
    with torch.no_grad():
        got = model.masks(torch.from_numpy(x))
        absum = chip_smoke.head_sums(torch, model, torch.from_numpy(x))[1]
    want = want_logits.argmax(-1).to(torch.uint8)
    differ = got != want
    agree = 1 - differ.reshape(3, -1).float().mean(1)
    assert agree.min() >= 0.985, agree
    tie = dec1.near_tie_sums(want_logits, absum, ulps=4)
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    assert len(torch.unique(want)) == jcfg.num_classes  # not one class only


def test_attention_gate_in_bf16_rounds_as_jax():
    """One gated stage's gate (up-conv, W_x, W_g, relu, psi, sigmoid,
    skip * a) in bf16: bit-equal to JAX's ops (``lax`` convs, each product
    rounded, then the bias added in bf16)."""
    jcfg = JaxModelConfig(arch="attention_unet", base_channels=16, depth=1,
                          image_size=32)
    params = _params(jcfg, seed=4)
    stage = params["decoder"][0]
    rng = np.random.default_rng(6)
    x = rng.random((2, 16, 16, 32)).astype(np.float32)
    skip = rng.random((2, 32, 32, 16)).astype(np.float32)
    bf = jnp.bfloat16
    g = jax_unet._conv_transpose(jnp.asarray(x, bf), stage["up"], dtype=bf)
    sk = jnp.asarray(skip, bf)
    a = jax.nn.relu(jax_unet._conv(sk, stage["att_x"], dtype=bf)
                    + jax_unet._conv(g, stage["att_g"], dtype=bf))
    a = jax.nn.sigmoid(jax_unet._conv(a, stage["att_psi"], dtype=bf))
    want = np.asarray((sk * a).astype(jnp.float32))

    model = registry.build(params, ModelConfig(**dataclasses.asdict(jcfg)),
                           device="cpu")
    st = model.decoder[0]
    with torch.no_grad():
        pg = st.up(torch.from_numpy(x).to(torch.bfloat16))
        ps = torch.from_numpy(skip).to(torch.bfloat16)
        got = st.gate(ps, pg).float().numpy()
    np.testing.assert_array_equal(np.asarray(g.astype(jnp.float32)),
                                  pg.float().numpy())
    np.testing.assert_array_equal(got, want)


def test_every_3x3_conv_runs_in_the_conv_wrapper(monkeypatch):
    """Full-depth layouts at a narrow width: 30 convs per UNet++ forward
    (7 of them C < 128 at base 64) and 18 per Attention U-Net forward, all
    through ``ops.conv``; no other conv site."""
    calls = []
    orig = conv.conv3x3_bias_act_plain

    def spy(x, w, b, relu=True):
        calls.append(w.shape[2])
        return orig(x, w, b, relu)

    monkeypatch.setattr(conv, "conv3x3_bias_act_plain", spy)
    for arch, want in (("unetpp", 30), ("attention_unet", 18)):
        cfg = ModelConfig(arch=arch, base_channels=4, image_size=32)
        params = registry.init(cfg, torch.Generator().manual_seed(0))
        model = registry.build(params, cfg, device="cpu")
        calls.clear()
        with torch.no_grad():
            model(torch.zeros(1, 32, 32, 1))
        # input widths in units of the base: at base 64 below 128 is < 2
        small = sum(c < 2 * cfg.base_channels for c in calls)
        assert (len(calls), small) == (want, 7 if arch == "unetpp" else 4)


@pytest.mark.parametrize("arch,kw", [("unetpp", {}),
                                     ("unetpp", {"deep_supervision": True}),
                                     ("attention_unet", {}),
                                     ("attention_unet", {"stem": 2})],
                         ids=["unetpp", "unetpp_ds", "attention",
                              "attention_stem2"])
def test_init_param_count_and_create_round_trip(arch, kw, tmp_path):
    jcfg = JaxModelConfig(arch=arch, base_channels=8, depth=2, image_size=32,
                          compute_dtype="float32", **kw)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = registry.init(cfg, torch.Generator().manual_seed(3))
    want = jax.eval_shape(lambda k: jax_registry.init(k, jcfg),
                          jax.random.key(0))
    shapes = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), params)
    assert shapes == jax.tree_util.tree_map(
        lambda a: (a.shape, np.dtype(a.dtype)), want)
    # He-normal weights, zero biases; the same seed draws the same tree
    again = registry.init(cfg, torch.Generator().manual_seed(3))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(a, b)
    assert not any(site["b"].any() for site in _head_sites(params))
    n = PORT_MODULES[arch].param_count(params)
    assert n == JAX_MODULES[arch].param_count(params) == \
        unet.param_count(params) > 0

    # port create -> JAX load and apply; JAX create -> port load and build
    path = str(tmp_path / "port.ckpt")
    checkpoint.create(path, cfg, seed=1)
    jparams, jcfg2 = jax_ckpt.load(path)
    assert jcfg2 == jcfg
    x = np.random.default_rng(0).random((1, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jax_registry.apply(jparams, jnp.asarray(x), jcfg))
    p2, cfg2 = checkpoint.load(path)
    with torch.no_grad():
        got = registry.build(p2, cfg2, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    jpath = str(tmp_path / "jax.ckpt")
    jax_ckpt.create(jpath, jcfg, seed=2)
    p3, cfg3 = checkpoint.load(jpath)
    assert cfg3 == cfg and unet.param_count(p3) == n
    registry.build(p3, cfg3, device="cpu")


def test_stem_and_head_count_errors_match_jax():
    jcfg = JaxModelConfig(arch="unetpp", base_channels=4, depth=2,
                          image_size=32, stem=2)
    with pytest.raises(ValueError) as jerr:
        jax_unetpp.init(jax.random.key(0), jcfg)
    with pytest.raises(ValueError) as perr:
        registry.init(ModelConfig(**dataclasses.asdict(jcfg)),
                      torch.Generator().manual_seed(0))
    assert str(perr.value) == str(jerr.value)

    # a deep-supervision tree served with deep_supervision=False, and the
    # converse: both packages raise in the forward with one message
    x = np.zeros((1, 32, 32, 1), np.float32)
    for ds in (True, False):
        jcfg = JaxModelConfig(arch="unetpp", base_channels=4, depth=2,
                              image_size=32, compute_dtype="float32",
                              deep_supervision=ds)
        params = jax.device_get(jax_registry.init(jax.random.key(0), jcfg))
        served = dataclasses.replace(jcfg, deep_supervision=not ds)
        with pytest.raises(ValueError, match="head") as jerr:
            jax_registry.apply(params, jnp.asarray(x), served)
        model = registry.build(params, ModelConfig(**dataclasses.asdict(
            served)), device="cpu")
        with pytest.raises(ValueError) as perr:
            model(torch.from_numpy(x))
        assert str(perr.value) == str(jerr.value)


def test_registry_dispatch_and_refusals(monkeypatch):
    for arch in ("unet", "unetpp", "attention_unet"):
        cfg = ModelConfig(arch=arch, base_channels=4, depth=1,
                          image_size=32)
        model = registry.build(registry.init(
            cfg, torch.Generator().manual_seed(0)), cfg, device="cpu")
        assert model.cfg == cfg
        assert next(model.parameters()).dtype == torch.bfloat16
    # the quantized arch (P11) is a family now: no random init, built as
    # stored (int8 weights, f32 scales: never cast to bf16)
    assert not registry.get("unet_w8a8").cast
    q_cfg = ModelConfig(arch="unet_w8a8", base_channels=4, depth=1,
                        image_size=32)
    with pytest.raises(ValueError, match="quantization"):
        registry.init(q_cfg, torch.Generator().manual_seed(0))
    from unetseg_tpu_torch import quantize

    f_cfg = dataclasses.replace(q_cfg, arch="unet")
    f_params = registry.init(f_cfg, torch.Generator().manual_seed(0))
    q_params = quantize.quantize_params(
        f_params, f_cfg, dict.fromkeys(quantize._conv_order(f_cfg), 1.0))
    q_model = registry.build(q_params, q_cfg, device="cpu")
    assert q_model.cfg == q_cfg
    assert q_model.encoder[0].conv1.weight.dtype == torch.int8
    assert q_model.encoder[0].conv1.scale.dtype == torch.float32
    with pytest.raises(KeyError):
        registry.get("nope")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for arch in ("unet", "unetpp", "attention_unet"):
        cfg = ModelConfig(arch=arch, base_channels=4, depth=1,
                          image_size=32, compute_dtype="float32")
        params = registry.init(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(NotImplementedError,
                           match=r"float32.*ROADMAP\.md queue A, P13"):
            registry.build(params, cfg, device="cuda")


@pytest.mark.parametrize("name", ["unetpp_ds_d2_b8", "attention_stem2_d2_b8"])
def test_weight_space_transform_matches_jax(name):
    """``transform_params_dihedral`` on the UNet++ tree (its heads a list)
    and on a stem-2 Attention U-Net (its s2d/d2s permutations): the same
    arrays as JAX's, and the transformed model computes the transformed
    logits."""
    jcfg, cfg = _cfgs(name, compute_dtype="float32")
    params = _params(jcfg, seed=9)
    size = jcfg.image_size
    x = np.random.default_rng(2).random((1, size, size, 1)).astype(np.float32)
    for k in (1, 5):
        got = tta.transform_params_dihedral(params, cfg, k)
        want = jax.device_get(jax_tta.transform_params_dihedral(params, jcfg,
                                                                k))
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        model = registry.build(got, cfg, device="cpu")
        with torch.no_grad():
            y = model(torch.from_numpy(x))[0]
        view = tta.dihedral(torch.from_numpy(x[0]), k)[None]
        ref = registry.build(params, cfg, device="cpu")
        with torch.no_grad():
            y_ref = tta.dihedral_inverse(ref(view)[0], k)
        torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
