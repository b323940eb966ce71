"""Logging subsystem, a copy of ``unetseg_tpu.utils.logger``.

Same file layout and line format as the reference: the log
``<parent(cache)>/../log/segmentation_log.txt`` is truncated on every init
(``src/initialize.cpp:29-31``, path derivation ``src/main.cpp:87``), plus a
structured per-image timing record (``timings.jsonl``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional


class SegmentationLog:
    def __init__(self) -> None:
        self._f = None
        self._jsonl = None
        self._path: Optional[str] = None
        self._jsonl_path: Optional[str] = None
        self._lock = threading.Lock()

    def open(self, log_dir: str, structured: bool = True) -> bool:
        """(Re)open the log in ``log_dir``; the previous handles close only
        once the new open worked, and on failure the log stays closed."""
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "segmentation_log.txt")
        try:
            f = open(path, "w")  # truncate-on-init, parity with initialize.cpp:31
        except OSError:
            print(f"Failed to create log file: {path}")
            self.close()
            return False
        self.close()
        with self._lock:
            self._f, self._path = f, path
            if structured:
                try:
                    self._jsonl_path = os.path.join(log_dir, "timings.jsonl")
                    self._jsonl = open(self._jsonl_path, "w")
                except OSError:
                    self._jsonl = None
                    self._jsonl_path = None
        return True

    @property
    def path(self) -> Optional[str]:
        return self._path

    @property
    def jsonl_path(self) -> Optional[str]:
        return self._jsonl_path

    def is_open(self) -> bool:
        return self._f is not None

    def write(self, line: str) -> None:
        with self._lock:
            if self._f:
                self._f.write(line + "\n")
                self._f.flush()

    def record(self, **fields) -> None:
        """Machine-readable timing record (extension over the reference)."""
        with self._lock:
            if self._jsonl:
                self._jsonl.write(json.dumps(fields, sort_keys=True) + "\n")
                self._jsonl.flush()

    def close(self) -> None:
        with self._lock:
            if self._f:
                self._f.close()
                self._f = None
            if self._jsonl:
                self._jsonl.close()
                self._jsonl = None


GLOBAL_LOG = SegmentationLog()


def derive_log_dir(cache_path: str) -> str:
    """log_dir = parent(cache)/../log, parity with src/main.cpp:87."""
    return os.path.join(os.path.dirname(cache_path), "..", "log")
