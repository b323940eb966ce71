"""The port's confidence cascade (``InferenceEngine.attach_cascade`` /
``infer_cascade``, P8) against the JAX engine's on the CPU.

The cases of ``tests/test_cascade.py``, each run through both engines on the
same checkpoints written by the JAX package (``SMALL`` student, ``SMALL``
co-model of another seed, ``BIG`` fallback; float32, 64²) and the same
seeded u8 batches.  Tolerance: the router statistic is float32 summed in
another order, so it is held to rtol 1e-5 / atol 1e-6; every threshold
lies halfway between two slices' statistics, far outside that tolerance,
so the routed sets must be equal; the masks are bit-equal.
"""

import inspect
import io
import json
import os

import numpy as np
import pytest

from test_torch_port_native_ready import jax_native  # noqa: F401 (fixture)
from unetseg_tpu import checkpoint as jax_ckpt, engine as jax_engine
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu_torch import checkpoint, cli, engine, service
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.io import native, raw as raw_io
from unetseg_tpu_torch.utils.logger import derive_log_dir

SMALL = JaxModelConfig(base_channels=8, depth=2, image_size=64,
                       compute_dtype="float32")
BIG = JaxModelConfig(base_channels=12, depth=2, image_size=64,
                     compute_dtype="float32")
RTOL, ATOL = 1e-5, 1e-6
W, H = 100, 80
# thresholds that route nothing and everything, per router:
# (cascade_threshold, cascade_margin_threshold)
NONE = {"margin": (-np.inf, 1.5), "disagree": (np.inf, 1.5),
        "both": (np.inf, -np.inf)}
ALL = {"margin": (np.inf, 1.5), "disagree": (-1.0, 1.5),
       "both": (np.inf, np.inf)}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("cascade") / "engine"
    d.mkdir()
    paths = {}
    for name, cfg, seed in (("student", SMALL, 0), ("co", SMALL, 7),
                            ("fallback", BIG, 1)):
        paths[name] = str(d / f"{name}.ckpt")
        jax_ckpt.create(paths[name], cfg, seed=seed)
    return paths


@pytest.fixture()
def pair(ckpts, tmp_path, jax_native):
    """init(router, **kw) -> (JAX engine, port engine), each initialized
    with the cascade on the same checkpoints."""
    def init(router="margin", **kw):
        args = dict(cascade_ckpt=ckpts["fallback"], cascade_router=router,
                    cascade_co_ckpt=ckpts["co"], **kw)
        assert jax_engine.initialize_engine(
            ckpts["student"], log_dir=str(tmp_path / "jlog"), **args)
        assert engine.initialize_engine(
            ckpts["student"], log_dir=str(tmp_path / "plog"), device="cpu",
            **args)
        return jax_engine.get_engine(), engine.get_engine()
    yield init
    jax_engine.cleanup_resources()
    engine.cleanup_resources()


def _batch(n=5, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, 64, 64)).astype(np.uint8)


def _set(engines, threshold, margin_threshold=1.5):
    for e in engines:
        e.cascade_threshold = threshold
        e.cascade_margin_threshold = margin_threshold


def _both(engines, u8, n_valid=None):
    """infer_cascade on both engines -> the port's (masks, stat, n), after
    holding the statistic within tolerance and the masks and counts
    equal."""
    jm, jc, jn = engines[0].infer_cascade(u8.copy(), n_valid=n_valid)
    pm, pc, pn = engines[1].infer_cascade(u8.copy(), n_valid=n_valid)
    assert pc.dtype == np.float32 and pc.shape == jc.shape
    np.testing.assert_allclose(pc, jc, rtol=RTOL, atol=ATOL)
    assert pn == jn
    np.testing.assert_array_equal(pm, jm)
    return pm, pc, pn


def _plain(ckpt, u8, device_postprocess=False):
    params, cfg = checkpoint.load(ckpt)
    eng = engine.InferenceEngine(params, cfg, "cpu", device_postprocess)
    return eng.to_host(eng.infer(u8.copy()))()


def _between(stat, k):
    """A threshold halfway between the k-th and (k+1)-th smallest
    statistics."""
    s = np.sort(stat)
    assert s[k] - s[k - 1] > 10 * (ATOL + RTOL * abs(s[k])), s
    return float((s[k - 1] + s[k]) / 2)


@pytest.mark.parametrize("router", ["margin", "disagree", "both"])
def test_route_none_matches_plain_infer(pair, ckpts, router):
    engines = pair(router)
    _set(engines, *NONE[router])
    u8 = _batch()
    masks, stat, n = _both(engines, u8)
    assert n == 0 and np.isfinite(stat).all()
    np.testing.assert_array_equal(masks, _plain(ckpts["student"], u8))


@pytest.mark.parametrize("router", ["margin", "disagree", "both"])
@pytest.mark.parametrize("device_postprocess", [False, True])
def test_route_all_matches_fallback(pair, ckpts, router, device_postprocess):
    engines = pair(router, device_postprocess=device_postprocess)
    _set(engines, *ALL[router])
    u8 = _batch()
    masks, _, n = _both(engines, u8)
    assert n == 5
    np.testing.assert_array_equal(
        masks, _plain(ckpts["fallback"], u8, device_postprocess))


@pytest.mark.parametrize("router", ["margin", "disagree"])
@pytest.mark.parametrize("device_postprocess", [False, True])
def test_partial_routing_splices(pair, ckpts, router, device_postprocess):
    """The 3 lowest margins (or highest disagreements) of 7 route into a
    bucket of 4; every other row is the student's."""
    engines = pair(router, device_postprocess=device_postprocess)
    u8 = _batch(n=7)
    _set(engines, *NONE[router])
    _, stat, _ = _both(engines, u8)
    if router == "margin":
        _set(engines, _between(stat, 3))
        routed = np.argsort(stat)[:3]
    else:
        _set(engines, _between(stat, 4))
        routed = np.argsort(stat)[4:]
    calls = []
    fallback = engines[1]._fallback_pass
    engines[1]._fallback_pass = lambda u: calls.append(u.shape[0]) or \
        fallback(u)
    masks, stat2, n = _both(engines, u8)
    np.testing.assert_array_equal(stat2, stat)
    assert n == 3 and calls == [4]
    fb = _plain(ckpts["fallback"], u8, device_postprocess)
    st = _plain(ckpts["student"], u8, device_postprocess)
    for i in range(7):
        np.testing.assert_array_equal(masks[i], fb[i] if i in routed
                                      else st[i])


def test_bucket_padding_and_n_valid(pair, ckpts):
    """A ragged batch of 5 padded to 8 (the last slice repeated): the
    threshold routes slice 4, whose copies fill the tail, yet only the
    first 5 rows may route; the routed slices go to the fallback in a
    bucket of the next power of two, padded with the first routed one."""
    engines = pair("margin")
    u8 = _batch(n=5, seed=11)
    padded = np.concatenate([u8, np.repeat(u8[-1:], 3, axis=0)])
    _set(engines, *NONE["margin"])
    _, stat, _ = _both(engines, padded)
    k = int(np.sum(stat[:5] < stat[4])) + 1  # slice 4 is the k-th lowest
    _set(engines, _between(stat[:5], k) if k < 5 else
         float(stat.max()) + 1.0)
    seen = []
    fallback = engines[1]._fallback_pass
    engines[1]._fallback_pass = lambda u: seen.append(u.clone()) or \
        fallback(u)
    masks, _, n = _both(engines, padded, n_valid=5)
    routed = np.sort(np.argsort(stat[:5])[:k])
    bucket = 1 << (k - 1).bit_length()
    assert 4 in routed and n == k and len(seen) == 1
    assert seen[0].shape[0] == bucket
    np.testing.assert_array_equal(seen[0].numpy()[:k], padded[routed])
    np.testing.assert_array_equal(
        seen[0].numpy()[k:], np.repeat(padded[routed[:1]], bucket - k, 0))
    st = _plain(ckpts["student"], padded)
    fb = _plain(ckpts["fallback"], padded)
    for i in range(8):
        np.testing.assert_array_equal(masks[i], fb[i] if i in routed
                                      else st[i])


def test_disagreement_is_mask_mismatch(pair, ckpts):
    engines = pair("disagree")
    _set(engines, *NONE["disagree"])
    u8 = _batch(n=7)
    _, stat, _ = _both(engines, u8)
    want = (_plain(ckpts["student"], u8) != _plain(ckpts["co"], u8)).reshape(
        7, -1).sum(1)
    np.testing.assert_array_equal(stat, want.astype(np.float32))


def test_disagree_self_co_routes_nothing(ckpts, tmp_path, jax_native):
    """co == student: no pixel disagrees, nothing routes at threshold 0."""
    args = dict(cascade_ckpt=ckpts["fallback"], cascade_router="disagree",
                cascade_co_ckpt=ckpts["student"], cascade_threshold=0.0)
    try:
        assert jax_engine.initialize_engine(
            ckpts["student"], log_dir=str(tmp_path / "j"), **args)
        assert engine.initialize_engine(
            ckpts["student"], log_dir=str(tmp_path / "p"), device="cpu",
            **args)
        u8 = _batch()
        masks, stat, n = _both(
            (jax_engine.get_engine(), engine.get_engine()), u8)
        assert n == 0
        np.testing.assert_array_equal(stat, np.zeros(5, np.float32))
        np.testing.assert_array_equal(masks, _plain(ckpts["student"], u8))
    finally:
        jax_engine.cleanup_resources()
        engine.cleanup_resources()


def test_both_is_union_of_the_two_routers(pair, ckpts):
    engines = pair("both")
    u8 = _batch(n=9)
    _set(engines, *NONE["both"])
    _, d_stat, _ = _both(engines, u8)
    for e in engines:
        e.cascade_router = "margin"
    _set(engines, *NONE["margin"])
    _, m_stat, _ = _both(engines, u8)
    for e in engines:
        e.cascade_router = "both"
    d_thr, m_thr = _between(d_stat, 8), _between(m_stat, 1)
    _set(engines, d_thr, m_thr)
    expect = np.nonzero((d_stat > d_thr) | (m_stat < m_thr))[0]
    masks, stat, n = _both(engines, u8)
    assert n == expect.size >= 1
    np.testing.assert_array_equal(stat, d_stat)  # the statistic: disagreement
    only_d = np.nonzero(d_stat > d_thr)[0]
    only_m = np.nonzero(m_stat < m_thr)[0]
    assert set(only_d) | set(only_m) == set(expect) and \
        set(only_d) != set(only_m)
    fb = _plain(ckpts["fallback"], u8)
    st = _plain(ckpts["student"], u8)
    for i in range(9):
        np.testing.assert_array_equal(masks[i], fb[i] if i in expect
                                      else st[i])


@pytest.mark.parametrize("router", ["disagree", "both"])
def test_router_requires_co(ckpts, router):
    params, cfg = checkpoint.load(ckpts["student"])
    eng = engine.InferenceEngine(params, cfg, "cpu")
    with pytest.raises(ValueError, match="co_params"):
        eng.attach_cascade(params, cfg, router=router)
    with pytest.raises(ValueError, match="router must be"):
        eng.attach_cascade(params, cfg, router="vote")
    assert not eng.cascade_attached
    with pytest.raises(RuntimeError, match="attach_cascade first"):
        eng.infer_cascade(_batch())


@pytest.mark.parametrize("router", ["margin", "disagree", "both"])
def test_process_batch_under_cascade(pair, tmp_path, router):
    """process_batch with a cascade: artifacts byte-equal to the JAX
    engine's native emitter, and the batch records count the routed
    slices (the median slice of 3 routes)."""
    engines = pair(router)
    rng = np.random.default_rng(5)
    paths = []
    for i in range(3):
        p = tmp_path / "in" / f"s{i}.raw"
        p.parent.mkdir(exist_ok=True)
        raw_io.write_raw(str(p), synth_slice(rng, 112)[0][:H, :W])
        paths.append(str(p))
    _set(engines, *NONE[router])
    u8 = np.stack([native.preprocess_u8(np.asarray(raw_io.read_raw(
        p, W, H)), 64) for p in paths])
    _, stat, _ = _both(engines, np.concatenate([u8, u8[-1:]]), n_valid=3)
    stat = stat[:3]
    if router == "margin":
        _set(engines, _between(stat, 1))
    else:
        _set(engines, _between(stat, 2), -np.inf)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_engine.process_batch(paths, W, H, [jdir] * 3, batch_size=4,
                                    emitter="native") == (3, 0)
    assert engine.process_batch(paths, W, H, [pdir] * 3,
                                batch_size=4) == (3, 0)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir)) and len(names) >= 9
    for f in names:
        with open(os.path.join(jdir, f), "rb") as a, \
                open(os.path.join(pdir, f), "rb") as b:
            assert a.read() == b.read(), f
    records = [json.loads(line) for line in
               open(tmp_path / "plog" / "timings.jsonl")]
    batches = [r for r in records if r["event"] == "batch"]
    assert [r["cascade_routed"] for r in batches] == [1]


@pytest.mark.parametrize("router", ["margin", "both"])
def test_process_single_image_under_cascade(pair, tmp_path, router):
    import cv2

    engines = pair(router)
    _set(engines, *ALL[router])
    raw = tmp_path / "one.raw"
    raw_io.write_raw(str(raw), synth_slice(np.random.default_rng(8), 112)[0]
                     [:H, :W])
    jdir, pdir = str(tmp_path / "j1"), str(tmp_path / "p1")
    assert jax_engine.process_single_image(str(raw), W, H, jdir)
    assert engine.process_single_image(str(raw), W, H, pdir)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir)) and len(names) >= 3
    for f in names:
        a, b = os.path.join(jdir, f), os.path.join(pdir, f)
        if f.endswith(".json"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
        else:
            np.testing.assert_array_equal(
                cv2.imread(b, cv2.IMREAD_UNCHANGED),
                cv2.imread(a, cv2.IMREAD_UNCHANGED), err_msg=f)
    log = open(tmp_path / "plog" / "segmentation_log.txt").read()
    assert "Cascade: routed to fallback model" in log
    assert "Cascade fallback attached" in log


@pytest.mark.parametrize("router,passes", [("margin", 1), ("disagree", 2),
                                           ("both", 2)])
def test_initialize_engine_warms_cascade(ckpts, tmp_path, router, passes):
    assert engine.initialize_engine(
        ckpts["student"], log_dir=str(tmp_path / "log"), device="cpu",
        cascade_ckpt=ckpts["fallback"], cascade_router=router,
        cascade_co_ckpt=ckpts["co"])
    try:
        eng = engine.get_engine()
        assert eng.cascade_attached and eng.cascade_router == router
        assert {1, (router, 1), ("cascade", 1)} <= eng._warm
        # the plain batch-1 warm-up, the router pass, the fallback's
        assert eng.forwards == 1 + passes + 1
    finally:
        engine.cleanup_resources()


def test_failed_cascade_reinit_leaves_no_engine(ckpts, tmp_path):
    """A re-init whose cascade cannot be attached returns False, logs why
    and leaves no engine, not the previous one and not one without the
    cascade."""
    log = str(tmp_path / "log")
    try:
        assert engine.initialize_engine(ckpts["student"], log_dir=log,
                                        device="cpu",
                                        cascade_ckpt=ckpts["fallback"])
        for kw, msg in (
                ({"cascade_ckpt": str(tmp_path / "nope.ckpt")},
                 "cascade checkpoint not found"),
                ({"cascade_ckpt": ckpts["fallback"], "cascade_router": "both"},
                 "router needs cascade_co_ckpt"),
                ({"cascade_ckpt": ckpts["fallback"], "cascade_router": "vote"},
                 "router must be")):
            assert engine.get_engine() is not None or "router" in msg
            assert not engine.initialize_engine(ckpts["student"], log_dir=log,
                                                device="cpu", **kw)
            assert engine.get_engine() is None
            text = open(os.path.join(log, "segmentation_log.txt")).read()
            assert msg in text, (kw, text)
        raw = tmp_path / "x.raw"
        raw_io.write_raw(str(raw), np.zeros((64, 64), np.uint16))
        assert not engine.process_single_image(str(raw), 64, 64,
                                               str(tmp_path / "o"))
    finally:
        engine.cleanup_resources()


def test_cli_cascade_forms(ckpts, tmp_path, capsys):
    s, co, fb = ckpts["student"], ckpts["co"], ckpts["fallback"]
    script = "\n".join([
        f"init {s} --cascade {fb} 2.0",
        f"init {s} --cascade-disagree {co} {fb} 10",
        f"init {s} --cascade-both {co} {fb} 10 0.5",
        f"init {s} --cascade",                        # no checkpoint
        f"init {s} --cascade {fb} x",                 # bad threshold
        f"init {s} --cascade-disagree {co}",          # no fallback
        f"init {s} --cascade-disagree {co} {fb} x",
        f"init {s} --cascade-both {co} {fb} 10 x",
        f"init {s} --cascades {fb}",                  # misspelled
        "exit"]) + "\n"
    assert cli.repl(io.StringIO(script), device="cpu") == 0
    out, err = capsys.readouterr()
    assert out.count("Engine initialized successfully") == 3
    for msg in ("--cascade requires a checkpoint path",
                "invalid cascade threshold",
                "--cascade-disagree requires <co_ckpt> <fallback_ckpt>",
                "invalid disagreement threshold", "invalid margin threshold",
                "unknown init option '--cascades'"):
        assert msg in err, msg
    assert engine.get_engine() is None  # exit cleaned up


def test_cli_cascade_defaults(monkeypatch):
    """The JAX REPL's defaults: margin 1.5; 106 disagreeing pixels; the
    union's margin leg 1.5 unless given."""
    sig = inspect.signature(engine.initialize_engine).parameters
    jsig = inspect.signature(jax_engine.initialize_engine).parameters
    for k in ("cascade_threshold", "cascade_router",
              "cascade_margin_threshold"):
        assert sig[k].default == jsig[k].default, k
    calls = []
    monkeypatch.setattr(cli.engine, "initialize_engine",
                        lambda cache, **kw: calls.append(kw) or False)
    cli.repl(io.StringIO("init m --cascade fb\n"
                         "init m --cascade-disagree co fb\n"
                         "init m --cascade-both co fb\n"
                         "init m --cascade-both co fb 32 0.7\nexit\n"),
             device="cpu")
    assert calls[0]["cascade_ckpt"] == "fb" and \
        "cascade_threshold" not in calls[0]
    assert calls[1] == {"device": "cpu", "device_postprocess": False,
                        "cascade_router": "disagree", "cascade_co_ckpt": "co",
                        "cascade_ckpt": "fb", "cascade_threshold": 106.0}
    assert calls[2]["cascade_router"] == "both" and \
        calls[2]["cascade_threshold"] == 106.0 and \
        "cascade_margin_threshold" not in calls[2]
    assert (calls[3]["cascade_threshold"],
            calls[3]["cascade_margin_threshold"]) == (32.0, 0.7)


def test_service_cascade_init_fields(ckpts, tmp_path):
    raw = tmp_path / "s.raw"
    raw_io.write_raw(str(raw), synth_slice(np.random.default_rng(2), 112)[0]
                     [:H, :W])
    svc = service.SegmentationService(port=0, device="cpu")
    addr = svc.start()
    try:
        r = service.request(addr, {"cmd": "init", "cache": ckpts["student"],
                                   "cascade": ckpts["fallback"],
                                   "cascade_router": "vote"})
        assert not r["ok"] and "cascade_router" in r["error"]
        r = service.request(addr, {"cmd": "init", "cache": ckpts["student"],
                                   "cascade": ckpts["fallback"],
                                   "cascade_router": "both"})
        assert not r["ok"]  # no co-model
        r = service.request(addr, {
            "cmd": "init", "cache": ckpts["student"],
            "cascade": ckpts["fallback"], "cascade_router": "both",
            "cascade_co": ckpts["co"], "cascade_threshold": -1,
            "cascade_margin_threshold": 0.5})
        assert r["ok"], r
        eng = engine.get_engine()
        assert (eng.cascade_router, eng.cascade_threshold,
                eng.cascade_margin_threshold) == ("both", -1.0, 0.5)
        r = service.request(addr, {"cmd": "process", "path": str(raw),
                                   "width": W, "height": H,
                                   "output_dir": str(tmp_path / "o")})
        assert r["ok"], r
        assert "s_mask.png" in os.listdir(tmp_path / "o")
        log = open(os.path.join(derive_log_dir(ckpts["student"]),
                                "segmentation_log.txt")).read()
        assert "Cascade: routed to fallback model" in log
    finally:
        svc.stop()
