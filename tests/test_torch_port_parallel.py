"""The port's ``parallel/mesh.py``, ``parallel/batch.py``, the engine over a
device list, the mesh weight-space TTA and the partition pool on the CPU,
against the JAX package on its 8-device virtual topology
(tests/test_parallel.py, tests/test_engine_mesh.py).

The port's stand-in for the virtual devices is a device list that repeats
``"cpu"``: the split is by position.  Small float32 UNets (base 8, depth 2,
64²; stem 1 and 2).  Masks of the dp forms are bit-equal to the one-device
forms and equal to JAX's (the sharded pipelines' cleaned masks; the TTA
masks but at near ties of JAX's logits, as tests/test_torch_port_tta.py
holds them); artifacts of threaded partitions byte-equal (JSONs) and
pixel-equal (PNGs) to the JAX engine's.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_native_ready import jax_native  # noqa: F401 (fixture)
from test_torch_port_tta import _jax_ensemble_logits
from test_torch_port_zoo_engine import (W, H, assert_same_artifacts,
                                        centred_checkpoint, write_raws)
from unetseg_tpu import engine as jax_engine
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu.parallel import batch as jax_batch, mesh as jax_mesh
from unetseg_tpu_torch import checkpoint, engine
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.parallel import batch, mesh, tta

SIZE = 64
WAIT_S = 300


def _cfgs(stem):
    jcfg = JaxModelConfig(base_channels=8, depth=2, image_size=SIZE,
                          compute_dtype="float32", stem=stem)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=[1, 2], ids=["stem1", "stem2"])
def model(request):
    jcfg, cfg = _cfgs(request.param)
    return jcfg, cfg, jax.device_get(jax_unet.init(jax.random.key(3), jcfg))


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_make_mesh_shapes_and_errors():
    m = mesh.make_mesh(8, sp=2, devices=["cpu"] * 8)
    assert m.shape == {"dp": 4, "sp": 2} == dict(jax_mesh.make_mesh(
        8, sp=2).shape)
    assert m.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert mesh.make_mesh(devices=["cpu"] * 3).shape == {"dp": 3, "sp": 1}
    with pytest.raises(ValueError) as err:
        mesh.make_mesh(8, sp=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError) as jerr:
        jax_mesh.make_mesh(8, sp=3)
    assert str(err.value) == str(jerr.value)
    if not torch.cuda.is_available():  # the default is the card's devices
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_mesh()
    parts = mesh.split_batch(torch.arange(6), ["cpu"] * 3)
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert mesh.gather_batch(parts, torch.device("cpu")).tolist() == \
        list(range(6))
    with pytest.raises(ValueError, match="split"):
        mesh.split_batch(torch.arange(5), ["cpu"] * 2)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_pipeline_matches_single_and_jax(model, n):
    jcfg, cfg, params = model
    u8 = _u8((8, SIZE, SIZE))
    got = batch.make_sharded_pipeline(
        cfg, mesh.make_mesh(devices=["cpu"] * n))(params, torch.from_numpy(u8))
    want = np.asarray(jax_batch.make_sharded_pipeline(
        jcfg, jax_mesh.make_mesh(n))(params, jnp.asarray(u8)))
    np.testing.assert_array_equal(got.numpy(), want)
    one = engine.InferenceEngine(params, cfg, device="cpu",
                                 device_postprocess=True)
    assert torch.equal(got, one._pipeline(torch.from_numpy(u8)))


def test_sharded_forward_matches_plain(model):
    jcfg, cfg, params = model
    x = np.random.default_rng(9).random((8, SIZE, SIZE, 1)).astype(np.float32)
    fwd = batch.make_sharded_forward(cfg, mesh.make_mesh(devices=["cpu"] * 4))
    got = fwd(params, torch.from_numpy(x))
    with torch.inference_mode():
        plain = registry.build(params, cfg, "cpu")(torch.from_numpy(x))
    assert torch.equal(got, plain)
    want = np.asarray(jax_batch.make_sharded_forward(
        jcfg, jax_mesh.make_mesh(8))(params, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_spatial_split_raises_p9c(model):
    """The meshes the spatial split's refusal met now serve as JAX's do: an
    sp > 1 mesh through ``make_sharded_pipeline`` and
    ``make_sharded_forward`` over its dp devices (``P("dp")``, replicated
    over sp), and ``spatial=True`` on an sp = 1 mesh (one band a part)."""
    jcfg, cfg, params = model
    u8 = _u8((4, SIZE, SIZE), seed=5)
    x = (u8.astype(np.float32) / 255)[..., None]
    sp_mesh = mesh.make_mesh(4, sp=2, devices=["cpu"] * 4)
    jsp_mesh = jax_mesh.make_mesh(4, sp=2)
    for got, want in (
            (batch.make_sharded_pipeline(cfg, sp_mesh),
             jax_batch.make_sharded_pipeline(jcfg, jsp_mesh)),
            (batch.make_sharded_pipeline(
                cfg, mesh.make_mesh(devices=["cpu"] * 2), spatial=True),
             jax_batch.make_sharded_pipeline(jcfg, jax_mesh.make_mesh(2),
                                             spatial=True))):
        np.testing.assert_array_equal(got(params, torch.from_numpy(u8)),
                                      np.asarray(want(params, u8)))
    got = batch.make_sharded_forward(cfg, sp_mesh)(params, torch.from_numpy(x))
    want = jax_batch.make_sharded_forward(jcfg, jsp_mesh)(params, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_engine_over_devices_matches_single_and_jax(model, n):
    """The dp engine: a batch that splits runs as n parts (n forwards),
    masks bit-equal to the one-device engine's and, cleaned on the device,
    equal to the JAX engine's on n virtual devices; an odd batch runs whole
    on the first device."""
    jcfg, cfg, params = model
    multi = engine.InferenceEngine(params, cfg, devices=["cpu"] * n,
                                   device_postprocess=True)
    single = engine.InferenceEngine(params, cfg, device="cpu",
                                    device_postprocess=True)
    assert multi.mesh.shape == {"dp": n, "sp": 1} and single.mesh is None
    assert len(set(map(id, multi.models))) == 1  # a repeated device shares
    u8 = _u8((8, SIZE, SIZE), seed=1)
    got = multi.infer(u8)
    assert multi.forwards == 2 * n  # the warm-up and the call, as parts
    assert torch.equal(got, single.infer(u8))
    jmulti = jax_engine.InferenceEngine(params, jcfg, device_postprocess=True,
                                        devices=jax.devices()[:n])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmulti.infer(u8)))
    odd = _u8((3, SIZE, SIZE), seed=2)
    before = multi.forwards
    assert torch.equal(multi.infer(odd), single.infer(odd))
    assert multi.forwards - before == 2  # warm-up and call, whole batches


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_tta_bit_equal_to_sequential_and_jax(model, n):
    jcfg, cfg, params = model
    multi = engine.InferenceEngine(params, cfg, devices=["cpu"] * n)
    single = engine.InferenceEngine(params, cfg, device="cpu")
    u8 = _u8((SIZE, SIZE), seed=3)
    got = multi.infer_tta(u8)
    assert multi._tta[0] == "ws" and multi.forwards == tta.N_TRANSFORMS
    assert torch.equal(got, single.infer_tta(u8))
    jmulti = jax_engine.InferenceEngine(params, jcfg,
                                        devices=jax.devices()[:n])
    want = np.asarray(jmulti.infer_tta(u8))
    assert jmulti._compiled[("tta", u8.shape)][0] == "ws"
    logits = _jax_ensemble_logits(params, jcfg, u8[None])[0]
    differ = got.numpy() != want
    top = np.sort(logits, axis=-1)
    tie = top[..., -1] - top[..., -2] <= 2 * (2e-4 + 1e-3 * np.abs(
        logits).max())
    assert not (differ & ~tie).any() and differ.mean() < 0.01


def test_mesh_tta_needs_a_divisor_of_eight(model):
    _, cfg, params = model
    with pytest.raises(ValueError, match="split"):
        tta.make_tta_weightspace_mesh_pipeline(
            params, cfg, mesh.make_mesh(devices=["cpu"] * 3))
    # an engine whose device count does not divide 8 takes the sequential
    # form on its first device
    three = engine.InferenceEngine(params, cfg, devices=["cpu"] * 3)
    u8 = _u8((SIZE, SIZE), seed=4)
    assert torch.equal(three.infer_tta(u8), engine.InferenceEngine(
        params, cfg, device="cpu").infer_tta(u8))


@pytest.fixture()
def served(tmp_path):
    """A JAX-written, head-centred stem-1 checkpoint, its RAWs, the global
    port engine on it (cleaned up after)."""
    raws = write_raws(str(tmp_path / "in"), 4)
    ckpt = centred_checkpoint(str(tmp_path / "engine" / "m.ckpt"),
                              {"arch": "unet"}, raws)
    assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "plog"),
                                    device="cpu")
    yield ckpt, raws
    engine.cleanup_resources()


def test_partitioned_engines_sizes_and_positions(served):
    devs = [torch.device("cpu")] * 8
    for n, sizes in ((3, [3, 3, 2]), (4, [2, 2, 2, 2]), (8, [1] * 8),
                     (20, [1] * 8), (0, [8])):
        parts = engine.make_partitioned_engines(n, devices=devs)
        assert [len(p.devices) for p in parts] == sizes, n
        # disjoint runs of positions that together cover the list
        assert sum((p.devices for p in parts), []) == devs
    one = engine.make_partitioned_engines(4, devices=["cpu"])
    assert len(one) == 1 and one[0].mesh is None  # one device, one engine
    if not torch.cuda.is_available():  # the default is the card's devices
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.make_partitioned_engines(2)
    engine.cleanup_resources()
    with pytest.raises(RuntimeError, match="initialize_engine"):
        engine.make_partitioned_engines(2, devices=devs)


def test_partitioned_engines_propagate_cascade(served, tmp_path):
    """tests/test_cascade.py::test_partitioned_engines_propagate_cascade:
    every partition serves the base engine's cascade."""
    ckpt, _ = served
    co = str(tmp_path / "co.ckpt")
    checkpoint.create(co, checkpoint.load(ckpt)[1], seed=7)
    assert engine.initialize_engine(
        ckpt, log_dir=str(tmp_path / "plog"), device="cpu",
        cascade_ckpt=ckpt, cascade_router="both", cascade_co_ckpt=co,
        cascade_threshold=0.0, cascade_margin_threshold=1.5)
    parts = engine.make_partitioned_engines(2, devices=["cpu"] * 4)
    assert len(parts) == 2
    for p in parts:
        assert p.cascade_attached and p._cascade_co[0] is not None
        assert p.cascade_router == "both"
        assert p.cascade_threshold == 0.0
        assert p.cascade_margin_threshold == 1.5
        assert p._fallback.devices == p.devices
    # the partition routes (threshold 0 px: everything), as parts
    u8 = _u8((2, SIZE, SIZE), seed=5)
    masks, _, n_routed = parts[0].infer_cascade(u8)
    assert masks.shape == (2, SIZE, SIZE) and n_routed == 2
    base_masks, _, _ = engine.get_engine().infer_cascade(u8)
    np.testing.assert_array_equal(masks, base_masks)


def test_threaded_callers_with_partitioned_engines(served, tmp_path,
                                                   jax_native):
    """tests/test_engine_mesh.py::test_threaded_callers_with_partitioned_
    engines: four threads, each with its partition engine, run
    ``process_single_image`` at once; every artifact equal to the JAX
    engine's partitions'."""
    ckpt, raws = served
    parts = engine.make_partitioned_engines(4, devices=["cpu"] * 8)
    assert jax_engine.initialize_engine(ckpt, log_dir=str(tmp_path / "jlog"))
    try:
        jparts = jax_engine.make_partitioned_engines(4)
        results = [None] * 4

        def worker(i):
            results[i] = engine.process_single_image(
                raws[i], W, H, str(tmp_path / f"p{i}"), eng=parts[i])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads) and all(results)
        for i in range(4):
            assert jax_engine.process_single_image(
                raws[i], W, H, str(tmp_path / f"j{i}"), eng=jparts[i])
            names = assert_same_artifacts(str(tmp_path / f"j{i}"),
                                          str(tmp_path / f"p{i}"))
            assert len(names) == 5, names
    finally:
        jax_engine.cleanup_resources()
