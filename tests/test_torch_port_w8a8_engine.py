"""A w8a8 checkpoint written by the JAX package, served by the port on the
CPU through every entry point, against the JAX engine.

The float parent: JAX-written float32 (base 8, depth 2, 64², stem 1 and 4,
the shipped slim4's stem), head bias centred on the RAWs' logits, from a
seed whose contours survive the cleanup (so the artifacts compared hold
contours);
``unetseg_tpu.quantize.quantize_checkpoint`` calibrates it on
``training_batch`` and writes the ``unet_w8a8`` file both engines serve.
``process_batch`` (host and device cleanup, per-class JSON) and the study
runner: files byte-equal to JAX's; ``process_single_image`` plain,
``per_class``, ``tta`` (activation space on both sides) and ``window``:
JSONs byte-equal, PNGs pixel-equal; the service (also with a partition
pool) byte-equal to ``process_single_image``; a cascade whose student is the
w8a8 model routes as JAX's does.  The port's w8a8 logits are bit-equal to
``apply_w8a8`` here (tests/test_torch_port_quantize.py), so every mask is
equal and every artifact is compared.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_port_native_ready import jax_native  # noqa: F401 (fixture)
from test_torch_port_zoo_engine import (W, H, assert_same_artifacts,
                                        assert_same_bytes, write_raws)
from unetseg_tpu import (checkpoint as jax_ckpt, engine as jax_engine,
                         quantize as jax_quantize)
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.io import native as jax_native_io
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu.parallel import pipeline as jax_pipeline
from unetseg_tpu_torch import checkpoint, engine, service
from unetseg_tpu_torch.io import raw as raw_io
from unetseg_tpu_torch.data import training_batch
from unetseg_tpu_torch.parallel import pipeline

N, BATCH = 4, 2


def centred_parent(path, stem, raw_paths, seed):
    """A JAX-written float32 UNet (base 8, depth 2, 64²) whose head bias is
    centred on ``raw_paths``' logits, the foreground leading on half of
    their pixels (``test_torch_port_zoo_engine.centred_checkpoint``, with
    the stem's subpixel head: its bias holds the class shift once per
    subpixel)."""
    jcfg = JaxModelConfig(base_channels=8, depth=2, image_size=64,
                          compute_dtype="float32", stem=stem)
    params = jax.device_get(jax_unet.init(jax.random.key(seed), jcfg))
    u8 = np.stack([jax_native_io.preprocess_u8(
        np.asarray(raw_io.read_raw(p, W, H)), 64) for p in raw_paths])
    x = jnp.asarray((u8.astype(np.float32) / 255.0)[..., None])
    logits = np.asarray(jax_unet.apply(params, x, jcfg)).reshape(-1, 3)
    shift = np.median(logits, axis=0)
    c = logits - shift
    shift[2] += np.median(c[:, 2] - c[:, :2].max(1))
    head = params["head"]
    head["b"] = (head["b"] - np.tile(shift, stem * stem)).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    jax_ckpt.save(path, params, jcfg)
    return path


#: stem -> JAX init seed of the float parent
SEEDS = {1: 1, 4: 2}


@pytest.fixture(scope="module", params=sorted(SEEDS),
                ids=lambda s: f"stem{s}")
def w8a8(request, tmp_path_factory):
    """(w8a8 checkpoint, float parent, RAWs, a RAW whose mask has a
    contour after the cleanup)."""
    d = tmp_path_factory.mktemp(f"w8a8_{request.param}")
    raws = write_raws(str(d / "in"), N, seed=13)
    parent = centred_parent(str(d / "engine" / "f32.ckpt"), request.param,
                            raws[:3], seed=SEEDS[request.param])
    dst = str(d / "engine" / "w8a8.ckpt")
    calib = [training_batch(np.random.default_rng(77), 4, 64)[0]]
    jax_quantize.quantize_checkpoint(parent, dst, calib)
    eng = engine.InferenceEngine(*checkpoint.load(dst), device="cpu")
    out = str(d / "probe")
    assert engine.process_batch(raws, W, H, [out] * N, eng=eng) == (N, 0)
    drawn = sorted(f[:-len("_contour_overlay.png")] for f in os.listdir(out)
                   if f.endswith("_contour_overlay.png"))
    assert drawn, "no contour survives the cleanup: the checks are vacuous"
    return dst, parent, raws, os.path.join(str(d / "in"), drawn[0] + ".raw")


@pytest.fixture()
def both(w8a8, tmp_path, jax_native):
    """init(**kw): the JAX and the port engine on the w8a8 checkpoint."""
    def init(**kw):
        assert jax_engine.initialize_engine(
            w8a8[0], log_dir=str(tmp_path / "jlog"), **kw)
        assert engine.initialize_engine(
            w8a8[0], log_dir=str(tmp_path / "plog"), device="cpu", **kw)
        eng = engine.get_engine()
        assert eng.cfg.arch == "unet_w8a8"
        return eng
    yield init
    jax_engine.cleanup_resources()
    engine.cleanup_resources()


@pytest.mark.parametrize("device_post", [False, True], ids=["host", "device"])
def test_process_batch_matches_jax(both, w8a8, tmp_path, device_post):
    raws = w8a8[2]
    both(device_postprocess=device_post)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = {} if device_post else {"per_class": True}
    assert jax_engine.process_batch(raws, W, H, [jdir] * N, batch_size=BATCH,
                                    emitter="native", **kw) == (N, 0)
    assert engine.process_batch(raws, W, H, [pdir] * N, batch_size=BATCH,
                                **kw) == (N, 0)
    names = assert_same_bytes(jdir, pdir)
    assert any(n.endswith("_contour_overlay.png") for n in names)


@pytest.mark.parametrize("mode", [{}, {"per_class": True}, {"tta": True},
                                  {"window": 64, "overlap": 16}],
                         ids=["plain", "per_class", "tta", "window"])
def test_process_single_image_modes_match_jax(both, w8a8, tmp_path, mode):
    eng = both()
    raw = w8a8[3]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_engine.process_single_image(raw, W, H, jdir, **mode)
    assert engine.process_single_image(raw, W, H, pdir, **mode)
    assert len(assert_same_artifacts(jdir, pdir)) >= 5
    if mode.get("tta"):
        assert eng._tta[0] == "act" and eng.forwards == 2  # warm-up + 1


def test_studies_match_jax(w8a8, tmp_path, jax_native):
    ckpt, _, raws, _ = w8a8
    jparams, jcfg = jax_ckpt.load(ckpt)
    params, cfg = checkpoint.load(ckpt)
    kw = dict(batch_size=BATCH, keep_masks=True, host_preprocess=True,
              artifacts="full")
    want = jax_pipeline.run_study(jparams, jcfg, raws, W, H,
                                  out_dir=str(tmp_path / "jax"), **kw)
    got = pipeline.run_study(params, cfg, raws, W, H,
                             out_dir=str(tmp_path / "port"), device="cpu",
                             **kw)
    np.testing.assert_array_equal(got.masks, want.masks)
    assert_same_bytes(str(tmp_path / "jax"), str(tmp_path / "port"))
    for post in (False, True):
        jdir, pdir = str(tmp_path / f"jr_{post}"), str(tmp_path / f"pr_{post}")
        want = jax_pipeline.run_study_device_resident(
            jparams, jcfg, raws, W, H, batch_size=BATCH, artifacts="json",
            out_dir=jdir, device_postprocess=post, keep_masks=True)
        got = pipeline.run_study_device_resident(
            params, cfg, raws, W, H, batch_size=BATCH, artifacts="json",
            out_dir=pdir, device_postprocess=post, keep_masks=True,
            device="cpu")
        np.testing.assert_array_equal(got.masks, want.masks)
        assert_same_bytes(jdir, pdir)


@pytest.mark.parametrize("partitions", [1, 2])
def test_service_serves_w8a8(w8a8, tmp_path, partitions):
    ckpt, _, _, raw = w8a8
    svc = service.SegmentationService(port=0, device="cpu",
                                      partitions=partitions)
    addr = svc.start()
    try:
        assert service.request(addr, {"cmd": "init", "cache": ckpt},
                               timeout=120)["ok"]
        out = str(tmp_path / "svc")
        r = service.request(addr, {"cmd": "process", "path": raw,
                                   "width": W, "height": H,
                                   "output_dir": out}, timeout=120)
        assert r["ok"], r
        service.request(addr, {"cmd": "shutdown"}, timeout=30)
    finally:
        svc.stop()
        engine.cleanup_resources()
    ref = str(tmp_path / "ref")
    eng = engine.InferenceEngine(*checkpoint.load(ckpt), device="cpu")
    assert engine.process_single_image(raw, W, H, ref, eng=eng)
    assert len(assert_same_bytes(ref, out)) == 5


def test_cascade_with_w8a8_student_matches_jax(w8a8, tmp_path, jax_native):
    """The w8a8 student with its float parent as the fallback (margin
    router): the statistic, the routed count and the masks equal to JAX's
    ``infer_cascade`` at a threshold between the 2nd and 3rd margins."""
    ckpt, parent, _, _ = w8a8
    u8 = np.random.default_rng(5).integers(0, 256, (4, 64, 64), np.uint8)
    try:
        engines = []
        for e, log in ((jax_engine, "jlog"), (engine, "plog")):
            kw = {} if e is jax_engine else {"device": "cpu"}
            assert e.initialize_engine(ckpt, log_dir=str(tmp_path / log),
                                       cascade_ckpt=parent,
                                       cascade_threshold=-np.inf, **kw)
            engines.append(e.get_engine())
        _, stat, n = engines[1].infer_cascade(u8.copy())
        assert n == 0
        s = np.sort(stat)
        for e in engines:
            e.cascade_threshold = float((s[1] + s[2]) / 2)
        (jm, jstat, jn), (pm, pstat, pn) = [e.infer_cascade(u8.copy())
                                            for e in engines]
    finally:
        jax_engine.cleanup_resources()
        engine.cleanup_resources()
    # the boundary margin is a float mean: another summation order
    np.testing.assert_allclose(pstat, jstat, rtol=1e-5, atol=1e-6)
    assert pn == jn == 2
    np.testing.assert_array_equal(pm, jm)
