"""The port's study runner (``parallel/pipeline.py``) against the JAX
package's on the CPU.

A small float32 checkpoint written by the JAX package (base 8, depth 2,
64², ``tests/test_pipeline_study.py``'s ``SMALL``) serves both sides; 7
synthetic RAWs of 96 x 80 at batch 3 leave a ragged tail of 1.  Tolerance:
float32 masks are bit-equal; a raw argmax pixel may differ only where JAX's
top-2 logit margin is below ``TIE`` (each test reports how many did), and
the cleaned masks and artifacts are compared on the slices whose argmax
agree everywhere (all of them with these seeds).
"""

import collections
import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_native_ready import jax_native  # noqa: F401 (fixture)
from unetseg_tpu import checkpoint as jax_ckpt
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu.ops import preprocess as jax_pre
from unetseg_tpu.parallel import pipeline as jax_pipeline
from unetseg_tpu_torch import checkpoint
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.io import native, raw as raw_io
from unetseg_tpu_torch.parallel import pipeline
from unetseg_tpu_torch.utils.profiling import StageTimer, device_trace

SMALL = JaxModelConfig(base_channels=8, depth=2, image_size=64,
                       compute_dtype="float32")
W, H, N, BATCH = 96, 80, 7, 3
TIE = 1e-5


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX params, port params, port config) of one seeded checkpoint."""
    path = str(tmp_path_factory.mktemp("study") / "model.ckpt")
    jax_ckpt.create(path, SMALL, seed=0)
    jparams, _ = jax_ckpt.load(path)
    params, cfg = checkpoint.load(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(SMALL)
    return jparams, params, cfg


@pytest.fixture(scope="module")
def raws(tmp_path_factory):
    d = tmp_path_factory.mktemp("raws")
    rng = np.random.default_rng(7)
    paths = []
    for i in range(N):
        p = str(d / f"slice_{i:03d}.raw")
        raw_io.write_raw(p, synth_slice(rng, 112)[0][:H, :W])
        paths.append(p)
    return paths


def _u8(paths, host_preprocess):
    """The u8 slices each side's study feeds its model."""
    imgs = np.stack([np.asarray(raw_io.read_raw(p, W, H)) for p in paths])
    if host_preprocess:
        return np.stack([native.preprocess_u8(r, 64) for r in imgs])
    return np.asarray(jax_pre.preprocess_batch(jnp.asarray(imgs), 64)[0])


def _argmax_agreement(jparams, params, cfg, u8):
    """Slices whose port argmax equals JAX's everywhere; asserts every
    differing pixel is a JAX near tie and returns how many differ."""
    logits = np.asarray(jax_unet.apply(
        jparams, jax_pre.model_input_from_u8(jnp.asarray(u8))[..., None],
        SMALL))
    want = logits.argmax(-1)
    top2 = np.sort(logits, -1)[..., -2:]
    tie = top2[..., 1] - top2[..., 0] < TIE
    eng = pipeline.study_engine(params, cfg, "cpu")
    got = eng._masks(torch.from_numpy(np.array(u8))).numpy()
    differ = got != want
    assert not (differ & ~tie).any(), "argmax differs away from a near tie"
    print(f"argmax pixels differing at near ties: {int(differ.sum())}")
    return ~differ.any(axis=(1, 2))


def _same_files(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and names
    for f in names:
        with open(os.path.join(a_dir, f), "rb") as a, \
                open(os.path.join(b_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    return names


@pytest.mark.parametrize("host_preprocess,artifacts",
                         [(False, None), (True, "json"), (True, "full")])
def test_run_study_matches_jax(models, raws, tmp_path, jax_native,
                               host_preprocess, artifacts):
    jparams, params, cfg = models
    calls = collections.Counter()
    lock = threading.Lock()

    def emit(k, path, mask):
        assert path == raws[k] and mask.shape == (64, 64)
        with lock:
            calls[k] += 1

    kw = dict(batch_size=BATCH, keep_masks=True,
              host_preprocess=host_preprocess, artifacts=artifacts)
    want = jax_pipeline.run_study(jparams, SMALL, raws, W, H,
                                  out_dir=str(tmp_path / "jax"), **kw)
    pipeline.STAGES.reset()
    got = pipeline.run_study(params, cfg, raws, W, H, emit=emit,
                             out_dir=str(tmp_path / "port"), device="cpu",
                             **kw)
    assert got.n_slices == N and got.slices_per_sec > 0 and got.wall_s > 0
    assert calls == {k: 1 for k in range(N)}
    stages = pipeline.STAGES.summary()
    assert stages["load"]["calls"] == stages["d2h"]["calls"] == 3
    if artifacts:
        assert stages["emit"]["calls"] == 3

    agree = _argmax_agreement(jparams, params, cfg,
                              _u8(raws, host_preprocess))
    np.testing.assert_array_equal(got.masks[agree], want.masks[agree])
    assert set(np.unique(got.masks)) == {0, 2}  # the cleanup kept organs
    if artifacts:
        assert agree.all()
        names = _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
        per_slice = 5 if artifacts == "full" else 2
        assert len(names) >= N * (per_slice - 2) + 2


@pytest.mark.parametrize("device_postprocess", [False, True])
def test_device_resident_matches_jax(models, raws, tmp_path, jax_native,
                                     device_postprocess):
    jparams, params, cfg = models
    kw = dict(batch_size=BATCH, artifacts="json", keep_masks=True,
              device_postprocess=device_postprocess)
    want = jax_pipeline.run_study_device_resident(
        jparams, SMALL, raws, W, H, out_dir=str(tmp_path / "jax"), **kw)
    got = pipeline.run_study_device_resident(
        params, cfg, raws, W, H, out_dir=str(tmp_path / "port"),
        device="cpu", **kw)
    assert got.stage_s > 0 and got.slices_per_sec > 0
    assert got.inference_s == got.wall_s
    agree = _argmax_agreement(jparams, params, cfg, _u8(raws, True))
    assert agree.all()
    np.testing.assert_array_equal(got.masks, want.masks)
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    # the same masks as the host-preprocess study
    study = pipeline.run_study(params, cfg, raws, W, H, batch_size=BATCH,
                               keep_masks=True, host_preprocess=True,
                               device="cpu")
    np.testing.assert_array_equal(got.masks, study.masks)


def test_device_resident_without_artifacts(models, raws):
    _, params, cfg = models
    res = pipeline.run_study_device_resident(
        params, cfg, raws[:4], W, H, batch_size=4, artifacts=None,
        keep_masks=True, device="cpu")
    assert res.n_slices == 4 and res.masks.shape == (4, 64, 64)
    with pytest.raises(ValueError, match="out_dir"):
        pipeline.run_study_device_resident(params, cfg, raws, W, H,
                                           device="cpu")


@pytest.mark.parametrize("shape", [(3, 8, 16), (2, 64, 64), (1, 5, 40)])
def test_mask_packing_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    m = rng.integers(0, 4, shape, dtype=np.uint8)
    got = pipeline._pack_mask2(torch.from_numpy(m)).numpy()
    want = np.asarray(jax_pipeline._pack_mask2(jnp.asarray(m)))
    assert got.dtype == np.uint8 and got.shape == shape[:2] + (shape[2] // 4,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pipeline._unpack_mask2(got), m)
    np.testing.assert_array_equal(pipeline._unpack_mask2(got),
                                  jax_pipeline._unpack_mask2(want))

    # 1 bit a pixel, little-endian in a byte: JAX's expression
    # (_device_stage_resident) and np.unpackbits(bitorder="little") * 2
    clean = (rng.random(shape) < 0.5).astype(np.uint8) * 2
    got1 = pipeline._pack_mask1(torch.from_numpy(clean)).numpy()
    n, h, w = shape
    bits = (jnp.asarray(clean).reshape(n, h, w // 8, 8) != 0).astype(
        jnp.uint8)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    want1 = np.asarray((bits * weights).sum(-1, dtype=jnp.uint8))
    np.testing.assert_array_equal(got1, want1)
    np.testing.assert_array_equal(
        np.unpackbits(got1, axis=-1, bitorder="little") * np.uint8(2), clean)


@pytest.mark.parametrize("depth,n", [(1, 5), (3, 10), (4, 2)])
def test_prefetch_map_keeps_order_and_depth(depth, n):
    """Results come in order, and when the consumer receives one the pool
    holds exactly min(depth, items left) futures beyond it: never more
    than ``depth`` ahead, and never idle while items are left."""
    submitted = []

    class CountingPool:
        def __init__(self, pool):
            self.pool = pool

        def submit(self, fn, item):
            submitted.append(item)
            return self.pool.submit(fn, item)

    items = [f"item{i}" for i in range(n)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        out, ahead = [], []
        for item, res in pipeline.prefetch_map(CountingPool(pool), str.upper,
                                               items, depth):
            out.append((item, res))
            ahead.append(len(submitted) - len(out))
        want = list(jax_pipeline.prefetch_map(pool, str.upper, items, depth))
    assert out == want == [(s, s.upper()) for s in items]
    assert submitted == items
    assert ahead == [min(depth, n - k) for k in range(1, n + 1)]


def test_per_class_is_not_ported(models, raws, tmp_path):
    _, params, cfg = models
    with pytest.raises(NotImplementedError, match="P6"):
        pipeline.run_study(params, cfg, raws, W, H, host_preprocess=True,
                           artifacts="json", out_dir=str(tmp_path),
                           per_class=True, device="cpu")
    with pytest.raises(ValueError, match="host_preprocess"):
        pipeline.run_study(params, cfg, raws, W, H, artifacts="json",
                           out_dir=str(tmp_path), device="cpu")


def test_p50_latency(models):
    _, params, cfg = models
    raw = synth_slice(np.random.default_rng(1), 96)[0][:H, :W]
    assert pipeline.measure_p50_latency(params, cfg, raw, W, H, iters=3,
                                        device="cpu") > 0


def test_study_engine_is_keyed_by_params(models):
    _, params, cfg = models
    eng = pipeline.study_engine(params, cfg, "cpu")
    assert pipeline.study_engine(params, cfg, "cpu") is eng
    other = jax.tree_util.tree_map(np.copy, params)
    assert pipeline.study_engine(other, cfg, "cpu") is not eng
    assert pipeline.study_engine(params, cfg, "cpu", True) is not eng


def test_stage_timer_and_trace(tmp_path):
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    s = t.summary()
    assert s["a"]["calls"] == 2 and s["b"]["calls"] == 1
    with device_trace(None):  # no-op path
        pass
    t.reset()
    assert t.summary() == {}

    trace_dir = tmp_path / "trace"
    with device_trace(str(trace_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = os.listdir(trace_dir)
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert "aten::mm" in (trace_dir / traces[0]).read_text()
    with pytest.raises(KeyError, match="body"):
        with device_trace(str(tmp_path / "trace2")):
            raise KeyError("body")
