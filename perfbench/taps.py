"""Taps on the program: they hand the benchmark what the timed path
produced at two layer boundaries, without changing it.

* the study engine's ``_pipeline``: each batch's u8 as the device got it
  (the host library's resample, shipped, or the device resample);
* ``native.postprocess_packed_batch`` (the study runner's call where
  the classes fit 2 bits) and ``native.postprocess_batch`` (its call
  otherwise): each row's decoded class mask, as the device produced it,
  and its cleaned mask.

Both are called on the study's main thread, batch by batch; which rows are
kept is the kind's choice (``row_ids(call_index, rows)``, call indices
counted from ``new_study()``).  A tap keeps the first instance of each kept
input and judges every later one against it.  The u8 stays on the device:
the first instance is a copy there, and a later one adds the count of its
pixels that differ from it to a device counter, with no wait.  The masks
are fingerprinted (outside the lock); an instance whose fingerprint
differs from the first is kept too (at most ``MAX_VARIANTS``), so every
distinct answer is judged.
"""

from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

MAX_VARIANTS = 3


def fingerprint(a: np.ndarray) -> int:
    b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    if b.size % 8:
        return zlib.crc32(b)
    w = b.view(np.uint64)
    return int(w.sum(dtype=np.uint64)) ^ (int(w[::3].sum(dtype=np.uint64)) << 1)


def unpack2(packed: np.ndarray) -> np.ndarray:
    """(h, w/4) uint8, 2 bits a pixel, pixel 0 in the low bits -> (h, w)."""
    out = np.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], axis=-1)
    return out.reshape(packed.shape[0], -1).astype(np.uint8)


class Record:
    """The first instance of one input's outputs, and the ones that
    differed from it."""

    def __init__(self, arrays: tuple, fp: tuple):
        self.instances = [tuple(np.array(a) for a in arrays)]
        self.fps = [fp]
        self.seen = 1
        self.differing = 0


class U8Record:
    """The first u8 of one input, on the device, and the most pixels by
    which a later one differed from it (a device counter)."""

    def __init__(self, u8: torch.Tensor):
        self.first = u8.clone()
        self.most_differing = torch.zeros((), dtype=torch.int64,
                                          device=u8.device)
        self.seen = 1

    def add(self, u8: torch.Tensor) -> None:
        self.seen += 1
        torch.maximum(self.most_differing, torch.ne(u8, self.first).sum(),
                      out=self.most_differing)


class Taps:
    def __init__(self, native, engine):
        self.native = native
        self.engine = engine
        self.u8: Dict[int, U8Record] = {}
        self.masks: Dict[int, Record] = {}   # (decoded, cleaned)
        #: ``row_ids(call_index, rows)`` -> the id of each row of a call,
        #: None for a row not kept.
        self.row_ids: Optional[Callable[[int, int], List[Optional[int]]]] = None
        self.calls = {"u8": 0, "cleanup": 0}
        self._lock = threading.Lock()
        self._orig = {}

    def new_study(self) -> None:
        self.calls = {"u8": 0, "cleanup": 0}

    def reset(self) -> None:
        with self._lock:
            self.u8.clear()
            self.masks.clear()
        self.new_study()

    def _ids(self, tap: str, rows: int) -> List[Optional[int]]:
        with self._lock:
            j = self.calls[tap]
            self.calls[tap] += 1
        return self.row_ids(j, rows) if self.row_ids else []

    def _u8_rows(self, u8: torch.Tensor) -> None:
        for r, i in enumerate(self._ids("u8", u8.shape[0])):
            if i is None:
                continue
            rec = self.u8.get(i)
            if rec is None:
                self.u8[i] = U8Record(u8[r])
            else:
                rec.add(u8[r])

    def _keep(self, key: int, arrays: tuple) -> None:
        fp = tuple(fingerprint(a) for a in arrays)
        with self._lock:
            rec = self.masks.get(key)
            if rec is None:
                self.masks[key] = Record(arrays, fp)
                return
            rec.seen += 1
            if fp in rec.fps:
                return
            rec.differing += 1
            if len(rec.instances) <= MAX_VARIANTS:
                rec.instances.append(tuple(np.array(a) for a in arrays))
                rec.fps.append(fp)

    def _cleanup_rows(self, decoded, cleaned) -> None:
        for r, i in enumerate(self._ids("cleanup", len(cleaned))):
            if i is not None:
                self._keep(i, (decoded[r], cleaned[r]))

    def install(self) -> None:
        nat, eng = self.native, self.engine
        pipe, packed_fn, plain_fn = (eng._pipeline,
                                     nat.postprocess_packed_batch,
                                     nat.postprocess_batch)
        self._orig = {"postprocess_packed_batch": packed_fn,
                      "postprocess_batch": plain_fn}

        def _pipeline(u8_batch, x=None):
            self._u8_rows(u8_batch)
            return pipe(u8_batch, x)

        def postprocess_packed_batch(packed, width):
            out = packed_fn(packed, width)
            self._cleanup_rows(packed, out)
            return out

        def postprocess_batch(masks):   # unpacked: over 4 classes
            out = plain_fn(masks)
            self._cleanup_rows(np.asarray(masks), out)
            return out

        eng._pipeline = _pipeline   # this engine only, not its class
        nat.postprocess_packed_batch = postprocess_packed_batch
        nat.postprocess_batch = postprocess_batch

    def uninstall(self) -> None:
        for name, fn in self._orig.items():
            setattr(self.native, name, fn)
        self._orig = {}
        if self.engine is not None:
            self.engine.__dict__.pop("_pipeline", None)
        self.engine = None   # the program's state is freed before judging
