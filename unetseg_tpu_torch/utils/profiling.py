"""Stage timers: the port of ``unetseg_tpu.utils.profiling``.

``StageTimer`` accumulates wall time per named stage (the study runner
records its host stages into ``parallel.pipeline.STAGES``); unlike the JAX
copy it takes a lock, since loader and emitter threads record into one
timer.  While a ``torch.profiler`` records, each stage is also a span
(``record_function``) in the profiler's trace, on the thread that ran it
and on the clock of the device's kernels; nested stages nest there.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler


def _recording() -> bool:
    """Whether a ``torch.profiler`` is recording.  The module flag is set
    for every thread (a profiler of all threads leaves the C++ check false
    even on its own); the C++ check covers a profiler enabled without it."""
    return (getattr(_autograd_profiler, "_is_profiler_enabled", False)
            or torch.autograd._profiler_enabled())


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    >>> t = StageTimer("study.")
    >>> with t.stage("preprocess"): ...
    >>> t.summary()  # {"preprocess": {"calls": 1, "total_s": ...}}

    Under a profiler the stage is also the span ``study.preprocess``.
    """

    def __init__(self, span_prefix: str) -> None:
        self.span_prefix = span_prefix
        self._acc: Dict[str, list] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        span = None
        if _recording():
            span = torch.profiler.record_function(self.span_prefix + name)
            span.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if span is not None:
                span.__exit__(None, None, None)
            with self._lock:
                entry = self._acc.setdefault(name, [0, 0.0])
                entry[0] += 1
                entry[1] += dt

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {"calls": c, "total_s": s, "mean_s": s / max(c, 1)}
                for k, (c, s) in self._acc.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()
