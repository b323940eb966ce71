"""The port's TCP service and REPL (``unetseg_tpu_torch.service`` / ``cli``)
on the CPU, mirroring tests/test_service.py and
tests/test_engine_e2e.py::test_cli_repl.

Every socket read and thread join has its own timeout, and nothing waits on
a fixed clock: races are staged with events around a gated engine call.
"""

import io
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from unetseg_tpu import checkpoint as jax_ckpt
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu_torch import cli, engine, service
from unetseg_tpu_torch.io import raw as raw_io

SMALL = JaxModelConfig(base_channels=8, depth=2, image_size=64,
                       compute_dtype="float32")
WAIT_S = 120.0


def _req(addr, req):
    return service.request(addr, req, timeout=WAIT_S)


def _setup_data(tmp_path, n=3):
    cache = tmp_path / "engine" / "model.ckpt"
    cache.parent.mkdir(exist_ok=True)
    jax_ckpt.create(str(cache), SMALL, seed=0)
    rng = np.random.default_rng(0)
    (tmp_path / "data").mkdir(exist_ok=True)
    for i in range(n):
        raw_io.write_raw(str(tmp_path / "data" / f"s{i}.raw"),
                         rng.integers(0, 65536, (70, 90), np.uint16))
    return str(cache)


def _process(tmp_path, name, out, **extra):
    path = tmp_path / "data" / name if name else tmp_path / "data"
    return {"cmd": "process", "path": str(path), "width": 90, "height": 70,
            "output_dir": str(tmp_path / out), **extra}


@pytest.fixture()
def svc(tmp_path):
    s = service.SegmentationService(port=0, device="cpu")
    addr = s.start()
    yield s, addr, tmp_path
    s.stop()


class _Gate:
    """Wraps an engine entry point: the call announces itself, then waits
    until released."""

    def __init__(self, fn):
        self.fn = fn
        self.started = threading.Event()
        self.release = threading.Event()

    def __call__(self, *args, **kwargs):
        self.started.set()
        if not self.release.wait(WAIT_S):
            raise TimeoutError("gate never released")
        return self.fn(*args, **kwargs)


def _run_in_thread(fn):
    box = {}
    t = threading.Thread(target=lambda: box.update(resp=fn()))
    t.start()
    return t, box


def test_service_end_to_end_device_postprocess(tmp_path):
    s = service.SegmentationService(port=0, device_postprocess=True,
                                    device="cpu")
    addr = s.start()
    try:
        cache = _setup_data(tmp_path)
        assert _req(addr, {"cmd": "status"}) == {
            "ok": True, "initialized": False, "processed": 0,
            "device_postprocess": True, "partitions": 1, "draining": False}
        r = _req(addr, _process(tmp_path, "s0.raw", "out0"))
        assert not r["ok"] and "not initialized" in r["error"]

        assert _req(addr, {"cmd": "init", "cache": cache}) == {"ok": True}
        assert engine.get_engine().device_postprocess
        assert _req(addr, _process(tmp_path, "s0.raw", "out1"))["ok"]
        assert (tmp_path / "out1" / "s0_mask.png").exists()
        r = _req(addr, _process(tmp_path, None, "out2"))
        assert r == {"ok": True, "processed": 3, "failed": 0}
        for i in range(3):
            assert (tmp_path / "out2" / f"s{i}_mask.png").exists()
        r = _req(addr, {"cmd": "status"})
        assert r["initialized"] and r["processed"] == 4

        r = _req(addr, {"cmd": "frobnicate"})
        assert not r["ok"] and "unknown cmd" in r["error"]
        r = _req(addr, {"cmd": "init"})
        assert not r["ok"] and "requires 'cache'" in r["error"]
        r = _req(addr, {"cmd": "process", "path": "/nope.raw", "width": 8,
                        "height": 8, "output_dir": str(tmp_path)})
        assert not r["ok"]
        assert _req(addr, {"cmd": "status"})["ok"]
    finally:
        s.stop()
    assert engine.get_engine() is None


def test_service_shutdown():
    s = service.SegmentationService(port=0, device="cpu")
    addr = s.start()
    r = _req(addr, {"cmd": "shutdown"})
    assert r == {"ok": True, "shutdown": True}
    assert s._server.shutdown_requested
    s.stop()


def test_service_shutdown_races_inflight_request(tmp_path, monkeypatch):
    """Shutdown on one connection while another has a directory request in
    flight: the request completes with its response and artifacts, new work
    is refused, and stop() waits for it before tearing the engine down."""
    s = service.SegmentationService(port=0, device="cpu")
    addr = s.start()
    gate = _Gate(engine.process_batch)
    monkeypatch.setattr(engine, "process_batch", gate)
    try:
        cache = _setup_data(tmp_path, n=4)
        assert _req(addr, {"cmd": "init", "cache": cache})["ok"]
        t, inflight = _run_in_thread(
            lambda: _req(addr, _process(tmp_path, None, "race_out")))
        assert gate.started.wait(WAIT_S)
        assert _req(addr, {"cmd": "shutdown"})["shutdown"]
        r = _req(addr, _process(tmp_path, "s0.raw", "x"))
        assert not r["ok"] and "shutting down" in r["error"]

        stopper = threading.Thread(target=s.stop)
        stopper.start()
        assert engine.get_engine() is not None  # the lock is still held
        gate.release.set()
        t.join(WAIT_S)
        stopper.join(WAIT_S)
        assert not t.is_alive() and not stopper.is_alive()
        assert inflight["resp"] == {"ok": True, "processed": 4, "failed": 0}
        for i in range(4):
            assert (tmp_path / "race_out" / f"s{i}_mask.png").exists()
        assert engine.get_engine() is None
    finally:
        gate.release.set()
        s.stop()


def test_service_request_timeout(svc, monkeypatch):
    s, addr, tmp_path = svc
    cache = _setup_data(tmp_path, n=1)
    assert _req(addr, {"cmd": "init", "cache": cache})["ok"]
    gate = _Gate(engine.process_single_image)
    monkeypatch.setattr(engine, "process_single_image", gate)
    s.max_detached = 1
    try:
        r = _req(addr, _process(tmp_path, "s0.raw", "t_out", timeout_s=0.01))
        assert not r["ok"] and "timed out" in r["error"]
        assert gate.started.is_set()
        # the cap: one detached request is running, new timed work is refused
        r = _req(addr, _process(tmp_path, "s0.raw", "t_out", timeout_s=5))
        assert not r["ok"] and "rejecting new timed work" in r["error"]
        assert _req(addr, {"cmd": "status"})["ok"]
    finally:
        gate.release.set()


def test_service_metrics_endpoint(svc):
    s, addr, tmp_path = svc
    cache = _setup_data(tmp_path, n=2)
    assert _req(addr, {"cmd": "init", "cache": cache})["ok"]
    for i in range(2):
        assert _req(addr, _process(tmp_path, f"s{i}.raw", "m_out"))["ok"]
    r = _req(addr, {"cmd": "metrics", "n": 10})
    events = [rec["event"] for rec in r["records"]]
    assert r["ok"] and "init" in events and events.count("image") == 2
    img = [rec for rec in r["records"] if rec["event"] == "image"][-1]
    assert "inference_ms" in img and "total_ms" in img
    r = _req(addr, {"cmd": "metrics", "n": 1})
    assert len(r["records"]) == 1 and r["records"][0]["event"] == "image"


def test_service_rejects_dropped_and_unported_fields(svc):
    s, addr, tmp_path = svc
    cache = _setup_data(tmp_path, n=1)
    # the cascade's init fields serve (P8): the model as its own fallback
    r = _req(addr, {"cmd": "init", "cache": cache, "cascade": cache,
                    "cascade_threshold": 0.0})
    assert r["ok"], r
    assert engine.get_engine().cascade_attached
    r = _req(addr, {"cmd": "init", "cache": cache, "cascade": cache,
                    "cascade_router": "vote"})
    assert not r["ok"] and "cascade_router" in r["error"]
    assert _req(addr, {"cmd": "init", "cache": cache, "cascade": None})["ok"]
    assert not engine.get_engine().cascade_attached

    r = _req(addr, _process(tmp_path, None, "o", tta=True))
    assert not r["ok"] and "tta" in r["error"]
    r = _req(addr, _process(tmp_path, "s0.raw", "o", tier="json"))
    assert not r["ok"] and "directory" in r["error"]
    r = _req(addr, _process(tmp_path, "s0.raw", "o", timeout_s="abc"))
    assert not r["ok"] and "timeout_s" in r["error"]
    r = _req(addr, _process(tmp_path, None, "o", emitter="pil"))
    assert not r["ok"] and "emitter" in r["error"]
    # per_class serves a file and a directory (P6)
    r = _req(addr, _process(tmp_path, "s0.raw", "pc_one", per_class=True))
    assert r["ok"], r
    assert "s0_classes.json" in os.listdir(tmp_path / "pc_one")
    r = _req(addr, _process(tmp_path, None, "pc_dir", per_class=True))
    assert r["ok"] and r["processed"] == 1, r
    assert "s0_classes.json" in os.listdir(tmp_path / "pc_dir")
    # TTA and sliding windows serve a file, and a directory request with
    # them is refused.
    for i, field in enumerate(({"tta": True}, {"window": 64},
                               {"window": 64, "overlap": 0})):
        r = _req(addr, _process(tmp_path, "s0.raw", f"mode{i}", **field))
        assert r["ok"], (field, r)
        assert "s0_mask.png" in os.listdir(tmp_path / f"mode{i}"), field
        r = _req(addr, _process(tmp_path, None, "o", **field))
        assert not r["ok"] and "directory" in r["error"], (field, r)

    r = _req(addr, _process(tmp_path, None, "o2", tier="json",
                            emitter="native"))
    assert r["ok"]
    assert sorted(os.listdir(tmp_path / "o2")) == [
        "s0.json", "s0_original_sizes.json"]
    # the partition pool serves (P9b): two CPU partitions, a file and a
    # directory request through checked-out engines, byte-equal to the
    # global engine's files above
    pooled = service.SegmentationService(port=0, partitions=2, device="cpu")
    paddr = pooled.start()
    try:
        assert _req(paddr, {"cmd": "init", "cache": cache})["ok"]
        st = _req(paddr, {"cmd": "status"})
        assert st["partitions"] == 2 and pooled._n_built == 2, st
        r = _req(paddr, _process(tmp_path, None, "pool_dir", tier="json",
                                 emitter="native"))
        assert r["ok"] and r["processed"] == 1, r
        for f in os.listdir(tmp_path / "o2"):
            assert (tmp_path / "o2" / f).read_bytes() == \
                (tmp_path / "pool_dir" / f).read_bytes(), f
        assert _req(paddr, _process(tmp_path, "s0.raw", "pool_one"))["ok"]
        assert "s0_mask.png" in os.listdir(tmp_path / "pool_one")
    finally:
        pooled.stop()


def test_service_pool_devices_follow_device(monkeypatch):
    """The pool splits the card the service was given: ``cuda:1`` keeps it
    on that card (a one-device pool is the global engine itself), a bare
    ``cuda`` splits every visible card, the CPU ``partitions`` positions."""
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(service.pmesh, "visible_devices", lambda: cards)
    base = object()
    monkeypatch.setattr(engine, "get_engine", lambda: base)
    split = []
    monkeypatch.setattr(
        engine, "make_partitioned_engines",
        lambda n, post, devices: split.append(devices) or list(devices))
    for device, want_devices, want_pool in (
            ("cuda:1", [cards[1]], [base]),
            ("cuda", cards, cards),
            ("cpu", [torch.device("cpu")] * 3, [torch.device("cpu")] * 3)):
        s = service.SegmentationService(port=0, partitions=3, device=device)
        try:
            assert s._pool_devices() == want_devices, device
            s._build_partitions()
            assert s._engines == want_pool and s._n_built == len(want_pool)
        finally:
            s._server.server_close()
    assert split == [cards, [torch.device("cpu")] * 3]


def test_service_one_device_pool_serves_global_engine(tmp_path, monkeypatch):
    """A pool over one device holds the global engine, not a second copy of
    the model there; a re-init puts the new global engine in the pool."""
    cache = _setup_data(tmp_path, n=1)
    pooled = service.SegmentationService(port=0, partitions=4, device="cpu")
    monkeypatch.setattr(pooled, "_pool_devices",
                        lambda: [torch.device("cpu")])
    paddr = pooled.start()
    try:
        for i in range(2):
            assert _req(paddr, {"cmd": "init", "cache": cache})["ok"]
            assert pooled._engines == [engine.get_engine()]
            assert pooled._engines[0] is engine.get_engine()
            assert _req(paddr, _process(tmp_path, "s0.raw", f"one{i}"))["ok"]
            assert pooled._engines[0] is engine.get_engine()
        assert _req(paddr, {"cmd": "status"})["partitions"] == 4
        for f in os.listdir(tmp_path / "one0"):
            assert (tmp_path / "one0" / f).read_bytes() == \
                (tmp_path / "one1" / f).read_bytes(), f
    finally:
        pooled.stop()


def test_service_garbage_frames_survive():
    s = service.SegmentationService(port=0, device="cpu")
    host, port = s.start()
    try:
        with socket.create_connection((host, port), timeout=WAIT_S) as sock:
            f = sock.makefile("rwb")
            for junk in (b"\xff\xfe\x00binary junk", b"{not json",
                         b"[1, 2,", b'"just a string"'):
                f.write(junk + b"\n")
                f.flush()
                resp = json.loads(f.readline())
                assert resp["ok"] is False and "error" in resp
            f.write(json.dumps({"cmd": "status"}).encode() + b"\n")
            f.flush()
            resp = json.loads(f.readline())
            assert resp["ok"] and not resp["initialized"]
    finally:
        s.stop()


def test_cli_serve_arg_parsing(monkeypatch, capsys):
    calls = {}

    def fake_serve(host, port, device_postprocess=False,
                   request_timeout_s=None, partitions=1, device="cuda"):
        calls.update(host=host, port=port, dp=device_postprocess,
                     timeout=request_timeout_s, device=device,
                     partitions=partitions)

    monkeypatch.setattr(service, "serve", fake_serve)
    assert cli.main(["--serve", "0.0.0.0:9000", "--device-post"]) == 0
    assert calls == {"host": "0.0.0.0", "port": 9000, "dp": True,
                     "timeout": None, "device": "cuda", "partitions": 1}
    assert cli.main(["--serve"]) == 0
    assert (calls["host"], calls["port"], calls["dp"]) == \
        ("127.0.0.1", 8473, False)
    assert cli.main(["--serve", "9001", "--timeout", "2.5", "--device",
                     "cpu", "--partitions", "1"]) == 0
    assert (calls["port"], calls["timeout"], calls["device"]) == \
        (9001, 2.5, "cpu")
    assert cli.main(["--serve", "[::1]:9002"]) == 0
    assert (calls["host"], calls["port"]) == ("::1", 9002)

    # --partitions reaches the service (P9b)
    assert cli.main(["--serve", "9001", "--partitions", "4"]) == 0
    assert (calls["port"], calls["partitions"]) == (9001, 4)

    calls.clear()
    for argv, msg in ((["--serve", "9001", "--partitions", "x"],
                       "invalid literal"),
                      (["--serve", "host:port"], "invalid --serve"),
                      (["--serve", "::1:9000"], "brackets"),
                      (["--serve", "9001", "--timeout"], "--timeout")):
        assert cli.main(argv) == 2, argv
        assert msg in capsys.readouterr().err, argv
    assert calls == {}


def test_cli_repl(tmp_path, capsys):
    cache = _setup_data(tmp_path, n=2)
    raw = tmp_path / "data" / "s0.raw"
    out = tmp_path / "cli_out"
    script = "\n".join([
        "help",
        "bogus",
        f"process {raw} 90 70 {out}",                 # before init
        f"init {cache} --cascade",                    # no fallback given
        f"init {cache} --cascade {cache} 0",          # the cascade (P8)
        f"init {cache}",
        f"process --tta {raw} 90 70 {tmp_path / 'tta_out'}",
        f"process --window 64 --overlap 16 {raw} 90 70 "
        f"{tmp_path / 'window_out'}",
        f"process --tta {tmp_path / 'data'} 90 70 {out}",     # directory
        f"process --window 64 {tmp_path / 'data'} 90 70 {out}",
        f"process --window x {raw} 90 70 {out}",      # not an integer
        # per-class JSON (P6) reaches the engine, which refuses it with
        # device cleanup, as the JAX engine does
        f"process --per-class {raw} 90 70 {tmp_path / 'pc_out'}",
        f"process --batched {raw} 90 70 {out}",       # directory flag
        f"process {raw} 90 70 {out}",
        f"process -r --batched --fast-emit --tier json {tmp_path / 'data'} "
        f"90 70 {tmp_path / 'dir_out'}",
        "exit",
    ]) + "\n"
    assert cli.repl(stdin=io.StringIO(script), device="cpu",
                    device_postprocess=True) == 0
    captured = capsys.readouterr()
    assert "Welcome to Medical Image Segmentation Tool" in captured.out
    assert "Unknown command: bogus" in captured.err
    assert "Error: Engine not initialized" in captured.err
    assert "Engine initialized successfully" in captured.out
    assert "--cascade requires a checkpoint path" in captured.err
    assert captured.out.count("Engine initialized successfully") == 2
    assert "ROADMAP.md" not in captured.err
    assert "per_class requires the host postprocess path" in captured.out
    assert not (tmp_path / "pc_out" / "s0_classes.json").exists()
    assert captured.err.count("not supported for directory inputs") == 2
    assert "['--tta']" in captured.err and "['--window']" in captured.err
    assert "--window requires an integer" in captured.err
    assert captured.out.count("Processing completed") == 3
    for d in ("tta_out", "window_out"):
        assert (tmp_path / d / "s0_mask.png").exists(), d
    assert "apply to directory inputs only" in captured.err
    assert "Processing completed" in captured.out
    assert "Success: 2 files" in captured.out
    assert "Exiting..." in captured.out
    assert (out / "s0_mask.png").exists()
    assert sorted(os.listdir(tmp_path / "dir_out")) == [
        "s0.json", "s0_original_sizes.json", "s1.json",
        "s1_original_sizes.json"]
    assert engine.get_engine() is None
