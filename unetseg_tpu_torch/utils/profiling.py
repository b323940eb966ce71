"""Stage timers and an optional device trace: the port of
``unetseg_tpu.utils.profiling``.

``StageTimer`` accumulates wall time per named stage (the study runner
records its host stages into ``parallel.pipeline.STAGES``); unlike the JAX
copy it takes a lock, since loader and emitter threads record into one
timer.  ``device_trace`` writes a ``torch.profiler`` trace under a
directory, viewable in TensorBoard or Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    >>> t = StageTimer()
    >>> with t.stage("preprocess"): ...
    >>> t.summary()  # {"preprocess": {"calls": 1, "total_s": ...}}
    """

    def __init__(self) -> None:
        self._acc: Dict[str, list] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Optional ``torch.profiler`` trace of the body (host operators, and
    the device's kernels when CUDA is available), written as a Chrome trace
    JSON under ``log_dir``.  A no-op when ``log_dir`` is None or empty.

    Only the profiler's own start and stop failures are swallowed:
    profiling never breaks the pipeline, and the body's exceptions
    propagate."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
            except Exception:
                pass
