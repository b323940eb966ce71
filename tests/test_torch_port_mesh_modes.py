"""The ``mesh=`` forms of activation-space TTA and sliding windows (P9d) on
the CPU: ``tta.make_tta_pipeline``, ``make_tta_batch_pipeline``,
``tiles.make_tiled_pipeline`` and ``make_tiled_batch_pipeline`` over a
mesh's dp devices, against the JAX package's ``mesh=`` forms on its 8
virtual devices and against the port's one-device forms; then the engine
over a device list, whose ``infer_tta`` (w8a8) and ``infer_tiled`` now run
over its devices, as JAX's engine does.

Models: float32 (stem 1) and w8a8 (stems 1 and 2) UNets at base 8, depth
2, from ``test_torch_port_spatial_w8a8.quantized``.  The port's stand-in
for the virtual devices is a device list that repeats ``"cpu"``.  The
window cases cut 15 and 30 windows, which split over none of dp 2, 4 and 8.
Bars: argmax masks ``array_equal`` to JAX's (for w8a8 this is above
``test_torch_port_quantize``'s end-to-end bar, whose logits were measured
bit-equal) and ``torch.equal`` to the port's one-device form; one model
pass a dp part.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_spatial_w8a8 import SEED, quantized, slices
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.parallel import (mesh as jax_mesh, tiles as jax_tiles,
                                  tta as jax_tta)
from unetseg_tpu_torch import engine
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.ops import conv, conv_s8
from unetseg_tpu_torch.parallel import mesh, tiles, tta

CPU = torch.device("cpu")
WINDOW, OVERLAP = 32, 12  # on 64 x 96: a 3 x 5 grid, irregular in x
CONVS = 10                # 3x3 convs of a depth-2 UNet
FAMILIES = ("f32", "w8a8_stem1", "w8a8_stem2")
MODES = ("tta", "tta_batch", "tiled", "tiled_batch")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(config, tree, inputs by mode, JAX's masks by mode on
    ``make_mesh(8)``): one JAX run a mode."""
    u8 = slices(4, SEED)
    stem = 2 if request.param == "w8a8_stem2" else 1
    cfg, params, qcfg, q = quantized(stem, SEED, u8)
    if request.param != "f32":
        cfg, params = qcfg, q
    wide = np.concatenate([u8[:2], u8[2:, :, :32]], axis=2)  # (2, 64, 96)
    inputs = {"tta": u8[0], "tta_batch": u8[:2], "tiled": wide[0],
              "tiled_batch": wide}
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
    jm = jax_mesh.make_mesh(8)
    jax_fns = {
        "tta": jax_tta.make_tta_pipeline(jcfg, mesh=jm,
                                         device_postprocess=False),
        "tta_batch": jax_tta.make_tta_batch_pipeline(jcfg, mesh=jm),
        "tiled": jax_tiles.make_tiled_pipeline(
            jcfg, WINDOW, OVERLAP, mesh=jm, device_postprocess=False),
        "tiled_batch": jax_tiles.make_tiled_batch_pipeline(
            jcfg, WINDOW, None, mesh=jm, device_postprocess=False)}
    want = {m: np.asarray(fn(params, jnp.asarray(inputs[m])))
            for m, fn in jax_fns.items()}
    return cfg, params, inputs, want


def port_pipeline(mode, model, mesh_=None):
    """The port's form of ``mode`` (argmax masks, no cleanup)."""
    if mode == "tta":
        return tta.make_tta_pipeline(model, False, mesh=mesh_)
    if mode == "tta_batch":
        return tta.make_tta_batch_pipeline(model, mesh=mesh_)
    if mode == "tiled":
        return tiles.make_tiled_pipeline(model, WINDOW, OVERLAP, False,
                                         mesh=mesh_)
    return tiles.make_tiled_batch_pipeline(model, WINDOW, None, False,
                                           mesh=mesh_)


@pytest.fixture()
def passes(monkeypatch):
    """Model passes, by the calls of the 3x3 convs' plain versions (one
    call a conv a pass; what a kernel launch is on the card)."""
    calls = []
    for mod, name in ((conv, "conv3x3_bias_act_plain"),
                      (conv_s8, "conv3x3_s8_q_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, **kw:
                            calls.append(1) or real(*a, **kw))
    return lambda: len(calls) / CONVS


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [2, 4])
def test_mesh_forms_match_jax_and_one_device(family, passes, mode, n):
    cfg, params, inputs, want = family
    model = registry.build(params, cfg, "cpu")
    u8 = torch.from_numpy(inputs[mode])
    one = port_pipeline(mode, model)(u8)
    single = passes()
    got = port_pipeline(mode, [model] * n,
                        mesh.make_mesh(devices=["cpu"] * n))(u8)
    assert got.device == CPU and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want[mode])
    assert torch.equal(got, one)
    assert len(np.unique(want[mode])) == cfg.num_classes
    # one pass a dp part: every window count here fits a pass
    assert single == 1 and passes() - single == n


def test_split_ragged_parts():
    """Contiguous parts of ceil(n / dp) rows, the last one shorter; no part
    for a device past the last row."""
    for n, dp, sizes in ((35, 2, [18, 17]), (15, 4, [4, 4, 4, 3]),
                         (1, 2, [1]), (5, 4, [2, 2, 1]), (8, 8, [1] * 8)):
        parts = mesh.split_ragged(torch.arange(n), [CPU] * dp)
        assert [len(p) for p in parts] == sizes
        assert torch.equal(torch.cat(parts), torch.arange(n))


def test_mesh_forms_refuse_what_does_not_split(family):
    cfg, params, inputs, _ = family
    model = registry.build(params, cfg, "cpu")
    three = mesh.make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="8 views do not split over dp=3"):
        tta.make_tta_pipeline([model] * 3, mesh=three)
    with pytest.raises(ValueError, match="does not split over 3 devices"):
        tta.make_tta_batch_pipeline([model] * 3, mesh=three)(
            torch.from_numpy(inputs["tta_batch"][:1]))
    with pytest.raises(ValueError, match="one model a dp device"):
        tiles.make_tiled_pipeline([model] * 2, mesh=three)


@pytest.mark.parametrize("family", ["f32", "w8a8_stem1"], indirect=True)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_engine_modes_over_its_devices(family, passes, n):
    """``InferenceEngine(devices=["cpu"] * n)``: windows over the devices
    always (15 windows: one pass a device); the w8a8 TTA over them when n
    divides 8 (a pass a device), else one pass on the first device; a float
    family's TTA stays weight-space (8 passes).  Masks (cleaned) equal to
    the one-device engine's."""
    cfg, params, inputs, _ = family
    one = engine.InferenceEngine(params, cfg, device="cpu",
                                 device_postprocess=True)
    multi = engine.InferenceEngine(params, cfg, devices=["cpu"] * n,
                                   device_postprocess=True)
    want_tta = one.infer_tta(inputs["tta"])
    want_tiled = one.infer_tiled(inputs["tiled"], WINDOW, OVERLAP)
    before = passes()
    got = multi.infer_tta(inputs["tta"])
    split = cfg.arch == "unet_w8a8" and 8 % n == 0
    tta_passes = n if split else 1 if cfg.arch == "unet_w8a8" else 8
    assert torch.equal(got, want_tta)
    assert multi._tta[0] == ("act" if cfg.arch == "unet_w8a8" else "ws")
    assert multi.forwards == passes() - before == tta_passes
    got = multi.infer_tiled(inputs["tiled"], WINDOW, OVERLAP)
    assert torch.equal(got, want_tiled)
    assert multi.forwards == passes() - before == tta_passes + n
