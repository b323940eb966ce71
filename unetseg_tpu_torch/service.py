"""Long-lived serving daemon around the port engine (``unetseg_tpu.service``).

The reference REPL's command surface (``src/main.cpp:62-199``) over a TCP
socket as newline-delimited JSON: one connection, many requests, engine state
shared across connections:

  {"cmd": "init", "cache": "/path/model.ckpt",
   "cascade": null, "cascade_threshold": 1.5,
   "cascade_router": "margin"|"disagree"|"both", "cascade_co": null,
   "cascade_margin_threshold": 1.5}
  {"cmd": "process", "path": "...", "width": W, "height": H,
   "output_dir": "...", "recursive": false, "tta": false, "window": null,
   "overlap": null, "per_class": false, "timeout_s": null,
   "emitter": "cv2"|"native", "tier": "full"|"mask_json"|"json"}
  {"cmd": "status"}
  {"cmd": "metrics", "n": 20}
  {"cmd": "shutdown"}

Responses: {"ok": true, ...} or {"ok": false, "error": "..."}.  Per-image
failures inside a directory request are counted, not fatal (parity with
src/main.cpp:159-163).  Device work is serialised with a lock (one card
owner); artifact writing happens in the request thread.

* ``shutdown`` drains gracefully: new work is rejected at once ("shutting
  down"), and in-flight requests on other connections finish and get their
  responses before teardown.
* ``timeout_s`` (per request, or the service-wide ``request_timeout_s``)
  bounds a process request: on expiry the client gets a timeout error while
  the work finishes in the background, at most ``max_detached`` at a time.
* ``metrics`` returns the tail of the structured timings log.

``tta``, ``window`` and ``overlap`` serve a single file (the 8-fold TTA
ensemble, sliding windows at native resolution); a directory request with
any of them is refused.  The ``cascade*`` init fields attach the confidence
cascade (``engine.initialize_engine``); ``per_class`` adds each slice's
``{base}_classes.json``.

``partitions=N`` (``--partitions N``) builds a pool of partition engines
after each ``init`` (``engine.make_partitioned_engines``: the visible CUDA
devices split into at most N engines for a bare ``device="cuda"``; on the
CPU, N engines over ``["cpu"] * N``).  A pool over one card (a one-card
host, or ``device="cuda:1"``, which keeps the pool on that card) is the
global engine itself.  Each ``process`` request checks an engine
out and runs without the device lock, so concurrent clients run in
parallel, each on its own devices; a re-init discards engines checked out
against the old checkpoint when they come back; ``shutdown`` waits for
every checked-out engine.

Start with ``python -m unetseg_tpu_torch --serve [HOST:]PORT`` or
:func:`serve` / :class:`SegmentationService` programmatically.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Optional, Tuple

import torch

from unetseg_tpu_torch import engine
from unetseg_tpu_torch.io import raw as raw_io
from unetseg_tpu_torch.parallel import mesh as pmesh
from unetseg_tpu_torch.utils.logger import GLOBAL_LOG


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):  # one connection, many newline-delimited requests
        srv: "SegmentationService" = self.server.service  # type: ignore
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            # Dispatch and the response write both run inside the in-flight
            # window, so stop()'s drain covers the write too.
            with srv._track_request():
                try:
                    req = json.loads(line)
                    resp = srv.dispatch(req)
                except Exception as e:  # malformed JSON / internal error
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                # Set the flag before the response is on the wire, so a
                # client that reads the reply and checks state never races.
                if resp.get("shutdown"):
                    self.server.shutdown_requested = True  # type: ignore
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
            if resp.get("shutdown"):
                return


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class SegmentationService:
    """Engine-backed request dispatcher and TCP server lifecycle."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 device_postprocess: bool = False,
                 request_timeout_s: Optional[float] = None,
                 partitions: int = 1, device: str = "cuda"):
        self._lock = threading.Lock()   # the card's owner
        self._device = device
        self._device_postprocess = device_postprocess
        self._request_timeout_s = request_timeout_s
        self._draining = False          # shutdown received: reject new work
        self._n_processed = 0
        self._count_lock = threading.Lock()
        self._inflight = 0              # handler requests mid dispatch/write
        self._inflight_cv = threading.Condition()
        self._detached = 0              # timed-out requests still running
        self.max_detached = 8           # repeated client timeouts must not
                                        # queue work without bound
        # partitions > 1: a checkout pool of partition engines, so
        # concurrent clients run in parallel, each on its own devices.
        self._partitions = max(1, int(partitions))
        self._engines: list = []        # the pool: engines not checked out
        self._n_built = 0               # engines of the current pool
        self._pool_cv = threading.Condition()
        self._pool_gen = 0              # bumped by re-init: stale engines
        self._outstanding = 0           # checked-out engines in flight
        self._server = _Server((host, port), _Handler)
        self._server.service = self  # type: ignore
        self._server.shutdown_requested = False  # type: ignore
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    # -- request dispatch ----------------------------------------------------

    def dispatch(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd == "shutdown":
            self._draining = True  # reject new work; in-flight finishes
            return {"ok": True, "shutdown": True}
        if self._draining and cmd in ("init", "process"):
            return {"ok": False, "error": "shutting down"}
        if cmd == "init":
            return self._init(req)
        if cmd == "process":
            return self._with_timeout(req, self._process)
        if cmd == "status":
            return {"ok": True, "initialized": engine.get_engine() is not None,
                    "processed": self._n_processed,
                    "device_postprocess": self._device_postprocess,
                    "partitions": self._partitions, "draining": self._draining}
        if cmd == "metrics":
            return self._metrics(req)
        return {"ok": False, "error": f"unknown cmd: {cmd!r}"}

    @contextmanager
    def _track_request(self):
        """In-flight window over dispatch and response write (stop() waits
        for these before teardown, so every accepted request gets its
        bytes)."""
        with self._inflight_cv:
            self._inflight += 1
        try:
            yield
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def _with_timeout(self, req: dict, fn) -> dict:
        """Bound a request by ``timeout_s`` (request field) or the service
        default.  Python threads cannot be killed, so an expired request
        keeps running detached (still serialised by the device lock) and the
        client gets a timeout error at once.  At most ``max_detached`` such
        requests may be outstanding; beyond that, timed requests are
        refused up front."""
        timeout = req.get("timeout_s", self._request_timeout_s)
        if timeout is None:
            return fn(req)
        try:
            # parse before starting the worker, so a bad value leaves no
            # uncounted thread behind
            timeout = float(timeout)
        except (TypeError, ValueError):
            return {"ok": False,
                    "error": f"invalid timeout_s: {req.get('timeout_s')!r}"}
        with self._count_lock:
            if self._detached >= self.max_detached:
                return {"ok": False,
                        "error": f"{self._detached} timed-out requests still "
                                 "running; rejecting new timed work"}
        box = {}
        done = threading.Event()

        def run():
            try:
                box["resp"] = fn(req)
            except Exception as e:
                box["resp"] = {"ok": False,
                               "error": f"{type(e).__name__}: {e}"}
            finally:
                done.set()
                with self._count_lock:
                    if box.get("detached"):
                        self._detached -= 1

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout)
        if t.is_alive():
            with self._count_lock:
                if not done.is_set():  # run() may have finished since
                    box["detached"] = True
                    self._detached += 1
            if box.get("detached"):
                return {"ok": False,
                        "error": f"request timed out after {timeout}s "
                                 "(work continues in background)"}
        return box["resp"]

    def _metrics(self, req: dict) -> dict:
        """Tail of the structured timings log (timings.jsonl), read from one
        block at the end of the file."""
        n = int(req.get("n", 20))
        path = GLOBAL_LOG.jsonl_path
        if not path or not os.path.exists(path):
            return {"ok": True, "records": []}
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            block = min(size, max(65536, 1024 * n))
            f.seek(size - block)
            data = f.read().decode("utf-8", "replace")
        lines = data.splitlines()
        if block < size and lines:
            lines = lines[1:]  # drop the partial first line of the block
        records = []
        for line in lines[-n:]:
            try:
                records.append(json.loads(line))
            except ValueError:
                pass
        return {"ok": True, "records": records}

    def _init(self, req: dict) -> dict:
        cache = req.get("cache")
        if not cache:
            return {"ok": False, "error": "init requires 'cache'"}
        router = req.get("cascade_router", "margin")
        if router not in engine.ROUTERS:
            return {"ok": False, "error":
                    "cascade_router must be 'margin', 'disagree' or 'both'"}
        try:
            threshold = float(req.get("cascade_threshold", 1.5))
            margin_threshold = float(req.get("cascade_margin_threshold", 1.5))
        except (TypeError, ValueError):
            return {"ok": False, "error": "cascade thresholds must be numbers"}
        with self._lock:
            ok = engine.initialize_engine(
                cache, device=self._device,
                device_postprocess=self._device_postprocess,
                cascade_ckpt=req.get("cascade"),
                cascade_threshold=threshold, cascade_router=router,
                cascade_co_ckpt=req.get("cascade_co"),
                cascade_margin_threshold=margin_threshold)
            if ok and self._partitions > 1:
                try:
                    self._build_partitions()
                except Exception as e:
                    # a half-built pool would leave get_engine() set while
                    # every checkout waits on an empty pool
                    engine.cleanup_resources()
                    return {"ok": False,
                            "error": f"partition pool build failed: "
                                     f"{type(e).__name__}: {e}"}
        return {"ok": True} if ok else \
            {"ok": False, "error": f"initialization failed for {cache}"}

    # -- the partition pool -------------------------------------------------

    def _pool_devices(self) -> list:
        """The devices the pool splits: the service's card when ``device``
        names one (``cuda:1``), every visible card for a bare ``cuda``, and
        ``partitions`` positions of the CPU."""
        dev = torch.device(self._device)
        if dev.type != "cuda":
            return [dev] * self._partitions
        return [dev] if dev.index is not None else pmesh.visible_devices()

    def _build_partitions(self) -> None:
        """A fresh pool over :meth:`_pool_devices`.  A pool of one device is
        the global engine itself, which already lies there: a second engine
        would be a second copy of the model on that card."""
        devices = self._pool_devices()
        fresh = ([engine.get_engine()] if len(devices) == 1 else
                 engine.make_partitioned_engines(
                     self._partitions, self._device_postprocess,
                     devices=devices))
        with self._pool_cv:
            # engines checked out against the old checkpoint are dropped
            # when they come back
            self._pool_gen += 1
            self._engines = fresh
            self._n_built = len(fresh)
            self._pool_cv.notify_all()

    def _checkout(self, wait_s: float = 600.0):
        """(generation, engine) from the pool, or None when draining, when
        no pool was built, or after ``wait_s``."""
        deadline = time.monotonic() + wait_s
        with self._pool_cv:
            while True:
                if self._draining or self._n_built == 0:
                    return None
                if self._engines:
                    self._outstanding += 1
                    return self._pool_gen, self._engines.pop()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._pool_cv.wait(remaining)

    def _checkin(self, gen: int, eng) -> None:
        with self._pool_cv:
            self._outstanding -= 1
            if gen == self._pool_gen:
                self._engines.append(eng)
            self._pool_cv.notify_all()

    def _process(self, req: dict) -> dict:
        if engine.get_engine() is None:
            return {"ok": False, "error": "engine not initialized"}
        try:
            path = req["path"]
            width = int(req["width"])
            height = int(req["height"])
            out_dir = req["output_dir"]
        except KeyError as e:
            return {"ok": False, "error": f"process requires {e.args[0]!r}"}
        tta = bool(req.get("tta", False))
        window = req.get("window")
        overlap = req.get("overlap")
        per_class = bool(req.get("per_class", False))
        emitter = req.get("emitter", "cv2")
        tier = req.get("tier", "full")
        if tier not in engine.ARTIFACT_TIERS:
            return {"ok": False,
                    "error": f"tier must be one of {engine.ARTIFACT_TIERS}"}
        if emitter not in engine.EMITTERS:
            return {"ok": False,
                    "error": f"emitter must be one of {engine.EMITTERS}"}

        # Fields only one path type honours must not be silently dropped.
        if os.path.isdir(path):
            unsupported = [k for k in ("tta", "window", "overlap")
                           if req.get(k)]
            if unsupported:
                return {"ok": False,
                        "error": f"directory requests do not support "
                                 f"{unsupported} (batched path); send the "
                                 f"files individually"}
        elif emitter != "cv2" or tier != "full":
            return {"ok": False,
                    "error": "emitter/tier apply to directory (batched) "
                             "requests only"}

        partitioned = self._partitions > 1
        eng = gen = None                # the global engine, under the lock
        lock = self._lock
        if partitioned:
            checked_out = self._checkout()
            if checked_out is None:
                return {"ok": False,
                        "error": ("shutting down" if self._draining else
                                  "no partition engine available")}
            gen, eng = checked_out
            lock = nullcontext()        # the engine owns its devices
        try:
            with lock:
                if os.path.isdir(path):
                    files = raw_io.find_16bit_images(
                        path, recursive=bool(req.get("recursive", False)))
                    if not files:
                        return {"ok": False,
                                "error": f"no images under {path}"}
                    out_dirs = [
                        os.path.join(out_dir, os.path.relpath(
                            os.path.dirname(f), path))
                        for f in files]
                    n_ok, n_fail = engine.process_batch(
                        files, width, height, out_dirs, eng=eng,
                        emitter=emitter, tier=tier, per_class=per_class)
                    with self._count_lock:
                        self._n_processed += n_ok
                    return {"ok": n_fail == 0, "processed": n_ok,
                            "failed": n_fail}
                ok = engine.process_single_image(
                    path, width, height, out_dir, tta=tta,
                    window=int(window) if window else None,
                    # overlap=0 (non-overlapping windows) is a valid value
                    overlap=int(overlap) if overlap is not None else None,
                    per_class=per_class, eng=eng)
                with self._count_lock:
                    self._n_processed += int(ok)
                return {"ok": True} if ok else \
                    {"ok": False, "error": f"processing failed for {path}"}
        finally:
            if partitioned:
                self._checkin(gen, eng)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self.address

    def serve_until_shutdown(self, poll_s: float = 0.2) -> None:
        self.start()
        while not self._server.shutdown_requested:  # type: ignore
            time.sleep(poll_s)
        self.stop()

    def stop(self, drain_timeout_s: float = 60.0) -> None:
        """Stop accepting, let in-flight requests finish and write their
        responses (and every checked-out partition engine come back), then
        tear the engine down.  The drain is bounded: after
        ``drain_timeout_s`` (a detached request may hold the device lock)
        it warns and tears down anyway."""
        self._draining = True
        self._server.shutdown()
        self._server.server_close()
        deadline = time.monotonic() + drain_timeout_s
        # the pool drains when every checked-out engine is back (stale ones
        # count too: they leave _outstanding though not rejoining the pool)
        with self._pool_cv:
            while self._outstanding > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    print(f"Warning: tearing down with {self._outstanding} "
                          f"request(s) still running after "
                          f"{drain_timeout_s}s drain")
                    break
                self._pool_cv.wait(remaining)
            self._engines = []
            self._n_built = 0
            self._pool_cv.notify_all()
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cv.wait(remaining)
        acquired = self._lock.acquire(
            timeout=max(0.0, deadline - time.monotonic()))
        try:
            if not acquired:
                print("Warning: device lock still held at teardown "
                      "(detached request?); cleaning up anyway")
            engine.cleanup_resources()
        finally:
            if acquired:
                self._lock.release()
        if self._thread is not None:
            self._thread.join(timeout=drain_timeout_s)


def serve(host: str = "127.0.0.1", port: int = 8473,
          device_postprocess: bool = False,
          request_timeout_s: Optional[float] = None,
          partitions: int = 1, device: str = "cuda") -> None:
    """Blocking entry point (``python -m unetseg_tpu_torch --serve``)."""
    svc = SegmentationService(host, port, device_postprocess,
                              request_timeout_s=request_timeout_s,
                              partitions=partitions, device=device)
    print(f"unetseg_tpu_torch service listening on "
          f"{svc.address[0]}:{svc.address[1]}", flush=True)
    svc.serve_until_shutdown()


def request(addr: Tuple[str, int], req: dict, timeout: float = 300.0) -> dict:
    """Tiny client: one request, one JSON response."""
    with socket.create_connection(addr, timeout=timeout) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())
