"""UNet++ and Attention U-Net through the study runner, the TCP service and
the confidence cascade on the CPU, against the JAX package.

The checkpoints of ``test_torch_port_zoo_engine.py`` (JAX-written float32,
base 8, depth 2, 64², head bias centred).  ``run_study`` (host preprocess
with full artifacts, device preprocess without) and ``run_study_device_resident`` (host and
device cleanup): masks equal to JAX's ``run_study``, artifacts byte-equal
to JAX's files.  The service: ``init`` on each checkpoint and a
``process``, artifacts byte-equal to ``process_single_image``'s.  The
cascade: a plain-UNet student with an Attention U-Net fallback (margin
router) and a UNet++ fallback with an Attention U-Net co-model (both
routers), routed sets, statistics and masks equal to JAX's
``infer_cascade``.
"""

import numpy as np
import pytest

from test_torch_port_native_ready import jax_native  # noqa: F401 (fixture)
from test_torch_port_zoo_engine import (ARCHS, W, H, assert_same_bytes,
                                        centred_checkpoint, write_raws)
from unetseg_tpu import checkpoint as jax_ckpt, engine as jax_engine
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.parallel import pipeline as jax_pipeline
from unetseg_tpu_torch import checkpoint, engine, service
from unetseg_tpu_torch.parallel import pipeline

N, BATCH = 5, 2


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_serving")
    raws = write_raws(str(d / "in"), N, seed=11)
    ckpts = {name: centred_checkpoint(str(d / "engine" / f"{name}.ckpt"), kw,
                                      raws[:3], seed=i)
             for i, (name, kw) in enumerate(ARCHS.items())}
    ckpts["unet"] = str(d / "engine" / "unet.ckpt")
    jax_ckpt.create(ckpts["unet"], JaxModelConfig(
        base_channels=8, depth=2, image_size=64, compute_dtype="float32"),
        seed=3)
    return ckpts, raws


@pytest.mark.parametrize("arch", list(ARCHS))
def test_studies_match_jax(zoo, tmp_path, arch, jax_native):
    ckpts, raws = zoo
    jparams, jcfg = jax_ckpt.load(ckpts[arch])
    params, cfg = checkpoint.load(ckpts[arch])
    for host_pre in (True, False):  # the device preprocess writes none
        kw = dict(batch_size=BATCH, keep_masks=True, host_preprocess=host_pre,
                  artifacts="full" if host_pre else None)
        jdir = str(tmp_path / f"jax_{host_pre}")
        pdir = str(tmp_path / f"port_{host_pre}")
        want = jax_pipeline.run_study(jparams, jcfg, raws, W, H,
                                      out_dir=jdir, **kw)
        got = pipeline.run_study(params, cfg, raws, W, H, out_dir=pdir,
                                 device="cpu", **kw)
        assert got.n_slices == N
        np.testing.assert_array_equal(got.masks, want.masks)
        if host_pre:
            assert_same_bytes(jdir, pdir)
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
    assert (got.masks == 2).any()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_service_serves_the_family(zoo, tmp_path, arch):
    ckpts, raws = zoo
    svc = service.SegmentationService(port=0, device="cpu")
    addr = svc.start()
    try:
        r = service.request(addr, {"cmd": "init", "cache": ckpts[arch]},
                            timeout=120)
        assert r["ok"], r
        out = str(tmp_path / "svc")
        r = service.request(addr, {"cmd": "process", "path": raws[0],
                                   "width": W, "height": H,
                                   "output_dir": out}, timeout=120)
        assert r["ok"], r
        st = service.request(addr, {"cmd": "status"}, timeout=30)
        assert st["initialized"] and st["processed"] == 1
        service.request(addr, {"cmd": "shutdown"}, timeout=30)
    finally:
        svc.stop()
        engine.cleanup_resources()
    ref = str(tmp_path / "ref")
    eng = engine.InferenceEngine(*checkpoint.load(ckpts[arch]), device="cpu")
    assert engine.process_single_image(raws[0], W, H, ref, eng=eng)
    assert_same_bytes(ref, out)


@pytest.mark.parametrize("student,fallback,co,router", [
    ("unet", "attention_unet", None, "margin"),
    ("unet", "unetpp_ds", "attention_unet", "both"),
], ids=["attention_fallback_margin", "unetpp_fallback_attention_co_both"])
def test_cascade_with_zoo_models_matches_jax(zoo, tmp_path, jax_native,
                                             student, fallback, co, router):
    """The statistic read with nothing routed, then a threshold between
    its 3rd and 4th values (the 3 lowest margins, or the 3 highest
    disagreements, route): both engines route the same slices and write
    the same masks."""
    ckpts, _ = zoo
    args = dict(cascade_ckpt=ckpts[fallback], cascade_router=router,
                cascade_margin_threshold=-np.inf)
    if co:
        args["cascade_co_ckpt"] = ckpts[co]
    u8 = np.random.default_rng(5).integers(0, 256, (6, 64, 64), np.uint8)
    try:
        assert jax_engine.initialize_engine(
            ckpts[student], log_dir=str(tmp_path / "jlog"), **args)
        assert engine.initialize_engine(
            ckpts[student], log_dir=str(tmp_path / "plog"), device="cpu",
            **args)
        engines = (jax_engine.get_engine(), engine.get_engine())
        for e in engines:  # route nothing
            e.cascade_threshold = -np.inf if router == "margin" else np.inf
        _, stat, n = engines[1].infer_cascade(u8.copy())
        assert n == 0
        s = np.sort(stat)
        k = 3 if router == "margin" else 2
        for e in engines:
            e.cascade_threshold = float((s[k] + s[k + 1]) / 2)
        (jm, jstat, jn), (pm, pstat, pn) = [e.infer_cascade(u8.copy())
                                            for e in engines]
    finally:
        jax_engine.cleanup_resources()
        engine.cleanup_resources()
    np.testing.assert_allclose(pstat, jstat, rtol=1e-5, atol=1e-6)
    assert pn == jn and 0 < pn < 6
    np.testing.assert_array_equal(pm, jm)
