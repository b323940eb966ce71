"""The traced stretch of a run: ``torch.profiler`` over CPU and CUDA, the
stretch marked by one annotation, the Chrome trace written under the run's
temporary directory and reduced to device intervals, kernels by name, and
idle gaps named by what the host was doing."""

from __future__ import annotations

import bisect
import contextlib
import functools
import heapq
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def spans(targets: List[Tuple[object, str, str]]):
    """Wrap each ``getattr(owner, attr)`` in a ``record_function`` span
    named ``name`` while the block runs, so the trace names the host
    layers; the originals come back after it."""
    saved = []
    for owner, attr, name in targets:
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)
        functools.update_wrapper(wrapped, fn)
        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


class Profiler:
    """``start()`` / ``stop()`` around whole units of work; ``stop``
    synchronises the device first, so every kernel of the stretch is in."""

    def __init__(self, out_dir: str):
        self.path = os.path.join(out_dir, "trace.json")
        self._prof = None
        self._mark = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:  # the host spans of every thread, not only this one's
            cfg = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            cfg = None
        self._prof = torch.profiler.profile(activities=acts,
                                            experimental_config=cfg)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()

    def stop(self) -> "Trace":
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            return Trace(json.load(f).get("traceEvents", []))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """Times in the trace's microseconds; results in seconds."""

    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        marks = [e for e in xs if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError("the trace lacks its window annotation")
        m = marks[0]
        self.t0, self.t1 = float(m["ts"]), float(m["ts"]) + float(m["dur"])
        self.device = [(e["name"], float(e["ts"]), float(e["dur"]))
                       for e in xs if e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"], float(e["ts"]),
                      float(e["ts"]) + float(e["dur"]))
                     for e in xs if e.get("cat") in HOST_CATS
                     and e.get("name") != WINDOW]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _clipped(self, pred=None) -> List[Tuple[str, float, float]]:
        out = []
        for name, ts, dur in self.device:
            if pred is not None and not pred(name):
                continue
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b > a:
                out.append((name, a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(
            [(a, b) for _, a, b in self._clipped()])) * 1e-6

    def kernels(self, pred) -> Tuple[int, float]:
        """(launches, summed seconds) of the device operations whose name
        ``pred`` accepts, inside the window."""
        ks = self._clipped(pred)
        return len(ks), sum(b - a for _, a, b in ks) * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        acc: Dict[str, float] = defaultdict(float)
        for name, a, b in self._clipped():
            acc[name] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(acc.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The window's idle time summed by the innermost host span that
        was running at each gap's middle ("no traced host span" where
        none was)."""
        busy = _union([(a, b) for _, a, b in self._clipped()])
        gaps, last = [], self.t0
        for a, b in busy:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.t1 > last:
            gaps.append((last, self.t1))
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        acc: Dict[str, float] = defaultdict(float)
        active: list = []  # heap of (end, -start, name)
        i = 0
        for a, b in sorted(gaps):
            mid = 0.5 * (a + b)
            j = bisect.bisect_right(starts, mid)
            while i < j:
                name, s, e = host[i]
                heapq.heappush(active, (e, -s, name))
                i += 1
            while active and active[0][0] <= mid:
                heapq.heappop(active)
            name = (max(active, key=lambda t: -t[1])[2] if active
                    else "no traced host span")
            acc[name] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(acc.items(), key=lambda kv: -kv[1])
                [:top]]


def summary(trace: Optional[Trace]) -> Optional[dict]:
    if trace is None:
        return None
    return {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
