"""The port's w8a8 quantization (``unetseg_tpu_torch.quantize``) on the CPU
against the JAX package's (``unetseg_tpu.quantize``), mirroring
tests/test_quantize.py.

Small float32 UNets (base 8, depth 2, 64²) at stem 1 and stem 2, JAX-seeded;
inputs from ``data.training_batch`` with a numpy generator.  Tolerances:

* ``training_batch``, ``quantize_params`` on the same scales, the checkpoint
  trees: bit-equal;
* ``calibrate``'s scales: rtol 1e-5 (two f32 forwards that sum in other
  orders);
* per site, given JAX's f32 input to it: the int8 activations, the int32
  sums of the plain conv (K7's plain version) or product, and the site's
  f32 output bit-equal (no FMA contraction on either side here);
* end to end: logits within rtol 1e-5 of ``apply_w8a8`` (measured
  bit-equal), masks >= 99.9% equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from unetseg_tpu import checkpoint as jax_ckpt, quantize as jq
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.data import training_batch as jax_training_batch
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu_torch import checkpoint, graphs, quantize
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import training_batch
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.models.unet import (depth_to_space, max_pool_2x2,
                                           space_to_depth)
from unetseg_tpu_torch.ops import conv_s8

SIZE = 64
_DN = ("NHWC", "HWIO", "NHWC")


def _cfgs(stem):
    jcfg = JaxModelConfig(base_channels=8, depth=2, image_size=SIZE,
                          compute_dtype="float32", stem=stem)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=[1, 2], ids=["stem1", "stem2"])
def setup(request):
    """(jcfg, cfg, float params, calibration batches, JAX scales, JAX
    int8 tree)."""
    jcfg, cfg = _cfgs(request.param)
    params = jax.device_get(jax_unet.init(jax.random.key(request.param),
                                          jcfg))
    calib = [training_batch(np.random.default_rng(11), n, SIZE)[0]
             for n in (3, 2)]
    scales = jq.calibrate(params, jcfg, calib)
    return jcfg, cfg, params, calib, scales, \
        jq.quantize_params(params, jcfg, scales)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_training_batch_bit_equal():
    for size in (64, 48):
        a = jax_training_batch(np.random.default_rng(4), 3, size)
        b = training_batch(np.random.default_rng(4), 3, size)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_calibrate_scales_close_to_jax(setup):
    jcfg, cfg, params, calib, scales, _ = setup
    got = quantize.calibrate(params, cfg, iter(calib), device="cpu")
    assert list(got) == quantize._conv_order(cfg) == jq._conv_order(jcfg)
    np.testing.assert_allclose([got[k] for k in scales],
                               [scales[k] for k in scales], rtol=1e-5)


def test_quantize_params_bit_equal(setup):
    jcfg, cfg, params, _, scales, jtree = setup
    tree = quantize.quantize_params(params, cfg, scales)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(jtree)
    for a, b in zip(_leaves(tree), _leaves(jtree)):
        assert type(a) is type(b) and a.dtype == b.dtype
        assert a.shape == b.shape and np.array_equal(a, b)


def _site_inputs(qparams, x, cfg):
    """[(name, site, JAX's f32 input to the site, JAX's output)] in forward
    order, by walking ``apply_w8a8``."""
    out = []

    def run(name, fn, x, site, **kw):
        y = fn(x, site, **kw)
        out.append((name, site, np.asarray(x), np.asarray(y)))
        return y

    x = jnp.asarray(x, jnp.float32)
    if cfg.stem > 1:
        x = jax_unet._space_to_depth(x, cfg.stem)
    skips = []
    for i, st in enumerate(qparams["encoder"]):
        x = run(f"encoder.{i}.conv1", jq._conv_w8a8, x, st["conv1"])
        x = run(f"encoder.{i}.conv2", jq._conv_w8a8, x, st["conv2"])
        skips.append(x)
        x = jax_unet._max_pool_2x2(x)
    bottleneck = qparams["bottleneck"]
    x = run("bottleneck.conv1", jq._conv_w8a8, x, bottleneck["conv1"])
    x = run("bottleneck.conv2", jq._conv_w8a8, x, bottleneck["conv2"])
    for i, (st, skip) in enumerate(zip(qparams["decoder"], reversed(skips))):
        x = jnp.concatenate([skip, run(f"decoder.{i}.up", jq._up2_w8a8, x,
                                       st["up"])], axis=-1)
        x = run(f"decoder.{i}.conv1", jq._conv_w8a8, x, st["conv1"])
        x = run(f"decoder.{i}.conv2", jq._conv_w8a8, x, st["conv2"])
    run("head", jq._conv_w8a8, x, qparams["head"], relu=False)
    return out


def test_every_site_bit_equal_to_jax(setup):
    """At each site, from JAX's own f32 input: the int8 activations, the
    int32 sums and the f32 output, bit for bit."""
    jcfg, cfg, _, _, _, jtree = setup
    model = registry.build(jtree, dataclasses.replace(cfg, arch="unet_w8a8"),
                           device="cpu")
    modules = dict(model.named_modules())
    x = training_batch(np.random.default_rng(12), 2, SIZE)[0]
    sites = _site_inputs(jtree, x, jcfg)
    assert len(sites) == len(quantize._conv_order(cfg))
    for name, site, x_in, y_jax in sites:
        mod = modules[name]
        xt = torch.from_numpy(x_in)
        xq_jax = np.asarray(jq._quant_act(jnp.asarray(x_in),
                                          site["act_scale"]))
        xq = conv_s8.quant_act(xt, mod.act_scale)
        assert np.array_equal(xq.numpy(), xq_jax), name
        w_q = site["w_q"]
        if w_q.shape[0] == 3:
            acc_jax = np.asarray(lax.conv_general_dilated(
                jnp.asarray(xq_jax), jnp.asarray(w_q), (1, 1), "SAME",
                dimension_numbers=_DN, preferred_element_type=jnp.int32))
            acc = conv_s8.conv3x3_s8_acc_plain(xq, mod.weight)
        else:
            c = w_q.shape[2]
            wk = (jnp.transpose(jnp.asarray(w_q)[::-1, ::-1], (2, 0, 1, 3))
                  .reshape(c, -1))
            acc_jax = np.asarray(lax.dot_general(
                jnp.asarray(xq_jax).reshape(-1, c), wk,
                (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
            acc = quantize.int8_matmul(xq.reshape(-1, c), mod.weight)
        assert acc.dtype == torch.int32
        assert np.array_equal(acc.numpy(), acc_jax), name
        with torch.inference_mode():
            y = mod(xt)
        assert y.dtype == torch.float32 and y.shape == y_jax.shape, name
        assert np.array_equal(y.numpy(), y_jax), name


def test_up2_exact_on_integer_grid():
    """Integer weights and activations inside the int8 range quantize
    exactly, so the port's int8 up-conv equals JAX's f32 transposed conv."""
    rng = np.random.default_rng(1)
    x = rng.integers(-40, 40, (2, 5, 6, 3)).astype(np.float32)
    w = rng.integers(-5, 5, (2, 2, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "VALID",
        dimension_numbers=_DN) + b)
    site = {"w_q": w.astype(np.int8), "w_scale": np.ones(4, np.float32),
            "b": b, "act_scale": np.float32(1.0)}
    up = quantize.W8A8UpConv(3, 4)
    state = checkpoint.params_from_jax({"up": site})
    up.load_state_dict({k[len("up."):]: v for k, v in state.items()})
    got = up(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jq._up2_w8a8(jnp.asarray(x), site)))


def test_end_to_end_matches_apply_w8a8(setup):
    jcfg, cfg, _, _, _, jtree = setup
    model = registry.build(jtree, dataclasses.replace(cfg, arch="unet_w8a8"),
                           device="cpu")
    x = training_batch(np.random.default_rng(13), 3, SIZE)[0]
    want = np.asarray(jq.apply_w8a8(jtree, jnp.asarray(x), jcfg))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        masks = model.masks(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.mean(masks == want.argmax(-1)) >= 0.999


def test_checkpoints_cross_both_ways(setup, tmp_path):
    """A JAX-written w8a8 file loads in the port with dtypes, shapes and
    values kept (``act_scale`` a 0-d f32 array), the port's
    ``save`` writes the same bytes as JAX's, and the port's
    ``quantize_checkpoint`` output loads in JAX."""
    jcfg, cfg, params, calib, _, jtree = setup
    src = str(tmp_path / "f32.ckpt")
    jax_ckpt.save(src, params, jcfg)
    jdst, pdst = str(tmp_path / "jax_w8a8.ckpt"), str(tmp_path / "w8a8.ckpt")
    jq.quantize_checkpoint(src, jdst, iter(calib))
    tree, qcfg = checkpoint.load(jdst)
    assert qcfg.arch == "unet_w8a8"
    jtree2, _ = jax_ckpt.load(jdst)
    for a, b in zip(_leaves(tree), _leaves(jtree2)):
        assert type(a) is type(b) and a.dtype == b.dtype
        assert np.shape(a) == np.shape(b) and np.array_equal(a, b)
    act = tree["head"]["act_scale"]
    assert act.shape == () and act.dtype == np.float32
    assert tree["encoder"][0]["conv1"]["w_q"].dtype == np.int8

    again = str(tmp_path / "again.ckpt")
    checkpoint.save(again, tree, qcfg)
    assert open(again, "rb").read() == open(jdst, "rb").read()

    q, pcfg = quantize.quantize_checkpoint(src, pdst, iter(calib),
                                           device="cpu")
    assert pcfg == qcfg
    back, bcfg = jax_ckpt.load(pdst)
    assert bcfg.arch == "unet_w8a8"
    for a, b in zip(_leaves(back), _leaves(q)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the same tree through JAX's save and the port's: the same bytes
    jax_again = str(tmp_path / "jax_again.ckpt")
    jax_ckpt.save(jax_again, q, jcfg.__class__(**dataclasses.asdict(pcfg)))
    assert open(jax_again, "rb").read() == open(pdst, "rb").read()


def test_params_from_jax_maps_w8a8_sites(setup):
    _, _, _, _, _, jtree = setup
    state = checkpoint.params_from_jax(jtree)
    site = jtree["encoder"][0]["conv1"]
    assert np.array_equal(state["encoder.0.conv1.weight"].numpy(),
                          site["w_q"].transpose(0, 1, 3, 2))
    assert np.array_equal(state["encoder.0.conv1.scale"].numpy(),
                          site["act_scale"] * site["w_scale"])
    assert state["encoder.0.conv1.act_scale"].shape == ()
    assert state["head.weight"].shape == jtree["head"]["w_q"].shape[2:]
    assert state["decoder.0.up.weight"].shape == (
        jtree["decoder"][0]["up"]["w_q"].shape[2],
        4 * jtree["decoder"][0]["up"]["w_q"].shape[3])


def test_errors_match_jax(setup, tmp_path, monkeypatch):
    jcfg, cfg, params, calib, _, _ = setup
    q_cfg = dataclasses.replace(cfg, arch="unet_w8a8")
    with pytest.raises(ValueError, match="produced by quantization"):
        registry.init(q_cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="calibration saw no data") as e:
        quantize.calibrate(params, cfg, [], device="cpu")
    with pytest.raises(ValueError) as je:
        jq.calibrate(params, jcfg, [])
    assert str(e.value) == str(je.value)
    src = str(tmp_path / "unetpp.ckpt")
    checkpoint.create(src, dataclasses.replace(cfg, arch="unetpp", stem=1),
                      seed=0)
    with pytest.raises(ValueError, match="UNet family"):
        quantize.quantize_checkpoint(src, str(tmp_path / "q.ckpt"), calib,
                                     device="cpu")
    # the drift guard: a calibration forward that parts from the UNet raises
    real = quantize._forward_f32
    monkeypatch.setattr(quantize, "_forward_f32",
                        lambda *a, **k: real(*a, **k) * 2 + 1)
    with pytest.raises(AssertionError, match="drifted"):
        quantize.calibrate(params, cfg, calib, device="cpu")


def test_k7_plain_version_exact_and_cpu_route():
    """K7's plain sums against a direct int64 sum over the nine taps, and
    the wrapper on CPU tensors: the plain version, no launch counted."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (2, 5, 7, 20), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, 9, 20), generator=g, dtype=torch.int8)
    xp = torch.nn.functional.pad(x.long(), (0, 0, 1, 1, 1, 1))
    want = sum(torch.einsum("bhwc,dc->bhwd", xp[:, dy:dy + 5, dx:dx + 7],
                            w[dy, dx].long())
               for dy in range(3) for dx in range(3))
    acc = conv_s8.conv3x3_s8_acc_plain(x, w)
    assert acc.dtype == torch.int32 and torch.equal(acc.long(), want)
    scale, bias = torch.rand(9), torch.randn(9)
    graphs.reset_launches()
    got = conv_s8.conv3x3_s8(x, w, scale, bias, relu=False)
    assert torch.equal(got, acc.float() * scale + bias)
    assert conv_s8.LAUNCHES["conv3x3_s8"] == 0
    with pytest.raises(TypeError, match="int8"):
        conv_s8.conv3x3_s8(x.float(), w, scale, bias)


def _site_by_site(model, x):
    """The w8a8 UNet as the sites' own f32-in / f32-out forwards compose it
    (each quantizes its f32 input; max-pool and concat on f32): JAX's
    ``apply_w8a8`` order, which ``W8A8UNet.forward`` computed before its
    activations passed between the sites in int8."""
    x = x.float()
    if model.cfg.stem > 1:
        x = space_to_depth(x, model.cfg.stem)
    skips = []
    for stage in model.encoder:
        x = stage.conv2(stage.conv1(x))
        skips.append(x)
        x = max_pool_2x2(x)
    x = model.bottleneck.conv2(model.bottleneck.conv1(x))
    for stage, skip in zip(model.decoder, reversed(skips)):
        x = torch.cat([skip, stage.up(x)], dim=-1)
        x = stage.conv2(stage.conv1(x))
    logits = model.head(x)
    if model.cfg.stem > 1:
        logits = depth_to_space(logits, model.cfg.stem)
    return logits


@pytest.mark.parametrize("stem", [1, 4])
def test_int8_flow_bit_equal_to_site_by_site(stem):
    """``W8A8UNet.forward`` (int8 between the sites: K7's plain version
    quantizing for its consumers, an encoder stage's last conv for two,
    int8 max-pool and concat) gives logits ``torch.equal`` to the
    site-by-site f32 composition, at stems 1 and 4, on a model calibrated
    by the port, each site's scale then set apart from the others."""
    jcfg, cfg = _cfgs(stem)
    params = jax.device_get(jax_unet.init(jax.random.key(10 + stem), jcfg))
    calib = [training_batch(np.random.default_rng(21), 3, SIZE)[0]]
    scales = quantize.calibrate(params, cfg, calib, device="cpu")
    # Calibration gives a stage's pooled path and its skip the same scale
    # (max-pooling keeps the maximum); spread them so that a site quantized
    # with another's scale shows.
    scales = {k: v * (1 + 0.05 * i) for i, (k, v) in enumerate(
        scales.items())}
    tree = quantize.quantize_params(params, cfg, scales)
    model = registry.build(tree, dataclasses.replace(cfg, arch="unet_w8a8"),
                           device="cpu")
    x = torch.from_numpy(training_batch(np.random.default_rng(22), 2,
                                        SIZE)[0])
    with torch.inference_mode():
        got = model(x)
        want = _site_by_site(model, x)
    assert got.shape == (2, SIZE, SIZE, cfg.num_classes)
    assert torch.isfinite(got).all() and torch.equal(got, want)
