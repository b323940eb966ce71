"""The spatial (sp) split of the w8a8 UNet on the CPU: K7's plain version on
int8 halo slabs (``parallel/spatial.py``), the up-convs, head, quantize,
max-pool and concat band by band, served by
``make_sharded_pipeline(spatial=True)``, against the JAX package's
``P("dp", "sp")`` pipeline on its 8 virtual devices and against the port's
one-device w8a8 engine.

A float32 UNet (base 8, depth 2, 64², stem 1 and 2) from a numpy seed,
calibrated on ``training_batch`` as tests/test_torch_port_quantize.py's
``setup`` does (the port's ``calibrate``, whose scales are within rtol 1e-5
of JAX's; both sides then serve the one int8 tree).  The port's stand-in
for the virtual devices is a device list that repeats ``"cpu"``.  Bars: the
int8 slabs bit-equal to the zero-padded tensor's rows; masks
``array_equal`` to JAX's and to the one-device engine's; banded logits
``torch.equal`` to the whole forward's (the int8 flow is exact: int32
sums, per-pixel dequantize); one K7 call a 3x3 conv a band.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.parallel import batch as jax_batch, mesh as jax_mesh
from unetseg_tpu_torch import engine, quantize
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import training_batch
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.ops import conv_s8
from unetseg_tpu_torch.parallel import batch, mesh, spatial

SIZE = 64
CPU = torch.device("cpu")
BATCH = 4  # splits over JAX's dp 4 and the port's dp 1 and 2
CONVS = 10  # 3x3 convs of a depth-2 UNet
# Weights and slices whose cleaned masks keep foreground in every slice at
# both stems, so the masks compared are not empty.
SEED = 5


def float_params(cfg: ModelConfig, seed: int) -> dict:
    """The port's seeded init with random biases (every bias add counts)."""
    params = registry.init(cfg, torch.Generator().manual_seed(seed))
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


def slices(n: int, seed: int) -> np.ndarray:
    """(n, 64, 64) uint8 slices: ``training_batch`` images."""
    x = training_batch(np.random.default_rng(seed), n, SIZE)[0][..., 0]
    return np.round(x * 255).astype(np.uint8)


def centre_head(params: dict, cfg: ModelConfig, u8: np.ndarray) -> None:
    """Shift the head bias so that on ``u8`` each class leads on a share of
    the pixels and the foreground on about half: random weights otherwise
    paint one class, and the cleaned masks compared would be empty."""
    model = registry.build(params, cfg, "cpu")
    with torch.inference_mode():
        logits = model(torch.from_numpy(u8.astype(np.float32) / 255.0)[
            ..., None]).reshape(-1, cfg.num_classes).numpy()
    shift = np.median(logits, axis=0)
    c = logits - shift
    shift[2] += np.median(c[:, 2] - c[:, :2].max(1))
    head = params["head"]
    head["b"] = (head["b"] - np.tile(shift, cfg.stem ** 2)).astype(np.float32)


def quantized(stem: int, seed: int, u8: np.ndarray):
    """(float config, float tree, w8a8 config, int8 tree) at base 8, depth
    2, 64², the head centred on ``u8``: calibrated on two
    ``training_batch`` draws of seed 11."""
    cfg = ModelConfig(base_channels=8, depth=2, image_size=SIZE,
                      compute_dtype="float32", stem=stem)
    params = float_params(cfg, seed)
    centre_head(params, cfg, u8)
    calib = [training_batch(np.random.default_rng(11), n, SIZE)[0]
             for n in (3, 2)]
    scales = quantize.calibrate(params, cfg, calib, device="cpu")
    return cfg, params, dataclasses.replace(cfg, arch="unet_w8a8"), \
        quantize.quantize_params(params, cfg, scales)


@pytest.fixture(scope="module", params=[1, 2], ids=["stem1", "stem2"])
def setup(request):
    """(float config, float tree, w8a8 config, int8 tree, u8 batch, JAX's
    masks on ``make_mesh(8, sp=2)``): one JAX run a stem."""
    u8 = slices(BATCH, SEED)
    cfg, params, qcfg, q = quantized(request.param, SEED, u8)
    jcfg = JaxModelConfig(**dataclasses.asdict(qcfg))
    want = np.asarray(jax_batch.make_sharded_pipeline(
        jcfg, jax_mesh.make_mesh(8, sp=2), spatial=True)(q, jnp.asarray(u8)))
    return cfg, params, qcfg, q, u8, want


@pytest.fixture()
def k7_calls(monkeypatch):
    """Calls of K7's plain version (what a K7 launch is on the card)."""
    calls = []
    real = conv_s8.conv3x3_s8_q_plain
    monkeypatch.setattr(conv_s8, "conv3x3_s8_q_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("h, sp, unit", [(64, 4, 4), (64, 3, 4), (64, 8, 16),
                                         (9, 9, 1)])
def test_int8_halo_slabs_are_the_padded_rows(h, sp, unit):
    """An int8 band's slab is the zero-padded tensor's rows: the padding a
    whole-image conv reads, since the symmetric quantize maps 0 to 0."""
    t = torch.randint(-127, 128, (2, h, 7, 33), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(h + sp))
    bands = spatial.split(t, [CPU] * sp, unit)
    padded = F.pad(t, (0, 0, 0, 0, 1, 1))
    start = 0
    for band, slab in zip(bands.parts, spatial.halo_slabs(bands.parts)):
        stop = start + band.shape[1]
        assert slab.dtype == torch.int8
        assert torch.equal(slab, padded[:, start:stop + 2])
        start = stop
    assert start == h


@pytest.mark.parametrize("n", [2, 4], ids=["dp1_sp2", "dp2_sp2"])
def test_w8a8_spatial_pipeline_matches_jax_and_one_device(setup, k7_calls,
                                                          n):
    cfg, params, qcfg, q, u8, want = setup
    m = mesh.make_mesh(n, sp=2, devices=["cpu"] * n)
    fn = batch.make_sharded_pipeline(qcfg, m, spatial=True)
    spatial.reset_exchange()
    k7_calls.clear()
    got = fn(q, torch.from_numpy(u8))
    exchange = dict(spatial.EXCHANGE)
    assert got.device == CPU and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert all((want[i] == 2).any() for i in range(BATCH))
    dp = m.shape["dp"]
    assert len(k7_calls) == CONVS * 2 * dp  # every conv, every band
    assert exchange["exchanges"] == CONVS * dp
    one = engine.InferenceEngine(q, qcfg, device="cpu",
                                 device_postprocess=True)
    assert torch.equal(got, one._pipeline(torch.from_numpy(u8)))
    # the exchange moves int8: a quarter of the float32 UNet's bytes
    spatial.reset_exchange()
    batch.make_sharded_pipeline(cfg, m, spatial=True)(params,
                                                      torch.from_numpy(u8))
    assert exchange["halo_bytes"] * 4 == spatial.EXCHANGE["halo_bytes"] > 0
    assert exchange["slab_bytes"] * 4 == spatial.EXCHANGE["slab_bytes"]


@pytest.mark.parametrize("sp", [3, 32], ids=["uneven", "empty_bands"])
def test_w8a8_banded_logits_equal_the_whole_forward(setup, sp):
    """Logits of bands (uneven ones; more bands than units, so some are
    empty and left out) ``torch.equal`` to the one-tensor forward's."""
    _, _, qcfg, q, u8, _ = setup
    model = registry.build(q, qcfg, "cpu")
    x = torch.from_numpy(u8[:2].astype(np.float32) / 255.0)[..., None]
    with torch.inference_mode():
        bands = spatial.split(x, [CPU] * sp, spatial.row_unit(qcfg))
        got = spatial.gather(model(bands), CPU)
        want = model(x)
    assert len(bands.parts) == min(sp, SIZE // spatial.row_unit(qcfg))
    assert got.dtype == torch.float32 and torch.equal(got, want)
