"""Hung-device watchdog for benchmark entry points: a copy of
``unetseg_tpu.utils.watchdog``.

A device that hangs in its first call gives a benchmark nothing to report.
Armed before the first CUDA call and disarmed after the first real
execution, this watchdog turns such a hang into one machine-readable error
line and a non-zero exit instead.  It imports nothing but the standard
library.
"""

import os
import threading
from typing import Callable


def arm_backend_watchdog(on_timeout: Callable[[float], None],
                         deadline_s: float = None) -> threading.Event:
    """Arm a daemon timer; call ``event.set()`` once the backend proved live.

    If the event is not set within the deadline (``BENCH_PROBE_TIMEOUT_S``
    env or 600 s), ``on_timeout(deadline_s)`` runs — it should print its
    report — and the PROCESS IS KILLED with ``os._exit(2)`` (a hung device
    call cannot be cancelled; exiting is the only way to unblock).
    """
    if deadline_s is None:
        deadline_s = float(os.environ.get("BENCH_PROBE_TIMEOUT_S", "600"))
    done = threading.Event()

    def _watch():
        if not done.wait(deadline_s):
            try:
                on_timeout(deadline_s)
            finally:
                os._exit(2)

    threading.Thread(target=_watch, daemon=True).start()
    return done
