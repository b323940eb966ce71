"""Full-study throughput runner (BASELINE config 4: a 300-slice CT study),
the port of ``unetseg_tpu.parallel.pipeline``.

A three-stage host/device pipeline replacing the reference's serial
per-file loop (src/main.cpp:148-164):

  stage A (host thread pool): read RAW slices into their rows of a reused
                              pinned slot, a share of the oldest batch a
                              thread, and copy each batch to the device
  stage B (device):           (preprocess +) UNet + argmax (+ cleanup)
  stage C (host thread pool): C++ mask cleanup, PNG/JSON emission, contours

CUDA launches are asynchronous: the main loop enqueues batch k+1's
forward and its device-to-host copy (pinned memory, an event:
``InferenceEngine.to_host``) before it waits for batch k's copy, so the
device runs batch k+1 while the host cleans and emits batch k.  Nothing in
the loop synchronises the whole device.

The model comes from ``InferenceEngine`` (its ``_pipeline`` is the device
stage); the engines are cached by the params object they were built from
(:func:`study_engine`), so repeated studies and ``measure_p50_latency`` on
one checkpoint reuse one model and its warm-up, and a study of another
checkpoint never meets it.  Each host stage's wall time is recorded into
``STAGES`` (a ``StageTimer``; the loader and emitter stages are summed over
their threads); under a ``torch.profiler`` each stage is also a span
``study.<stage>`` on the thread that ran it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.engine import InferenceEngine, _emit_per_class_json
from unetseg_tpu_torch.io import native, raw as raw_io
from unetseg_tpu_torch.ops import preprocess
from unetseg_tpu_torch.utils.profiling import StageTimer

#: Host stages of the last studies.  On the loader threads (in the
#: device-resident mode: its untimed staging), one a share of a batch in
#: :func:`run_study` (one a batch otherwise): "load" (read, host
#: preprocess, tail padding), within it "read" (with the device resample,
#: reading the RAW files into the batch's rows; with the host resample,
#: mapping them); one a batch: "h2d" (enqueueing the copy to the device
#: from the batch's pinned slot, or pinning a private array first).  On
#: the study's own thread, one after another: "wait_load" (waiting for the
#: next loaded batch), "dispatch" (enqueueing the device stage and the
#: copy back), "d2h" (waiting for a batch's masks on the host: the
#: device's remaining work and the copy), "cleanup" (host C++ cleanup, or
#: the 1-bit unpack), "handoff" (keeping the masks, handing them to the
#: emitter threads).  On the emitter threads: "emit" (artifacts).  Callers
#: reset it.
STAGES = StageTimer("study.")

_TIERS = {"json": native.TIER_JSON, "mask_json": native.TIER_MASK_JSON,
          "full": native.TIER_FULL}
_ENGINES: "OrderedDict[tuple, Tuple[dict, InferenceEngine]]" = OrderedDict()
_MAX_ENGINES = 4


@dataclass
class StudyResult:
    n_slices: int
    wall_s: float
    slices_per_sec: float
    masks: Optional[np.ndarray] = None
    stage_s: float = 0.0  # device-resident mode: untimed on-device staging


def study_engine(params, cfg: ModelConfig, device: str = "cuda",
                 device_postprocess: bool = False) -> InferenceEngine:
    """The engine serving ``params`` (a JAX-layout tree, taken as
    immutable) on ``device``, built at the first call and kept for the next
    studies of the same params object (the last few are kept)."""
    key = (id(params), cfg, str(torch.device(device)), device_postprocess)
    hit = _ENGINES.get(key)
    if hit is not None and hit[0] is params:
        return hit[1]
    eng = InferenceEngine(params, cfg, device, device_postprocess)
    # The entry holds ``params``, so its id cannot be reused while cached.
    _ENGINES[key] = (params, eng)
    while len(_ENGINES) > _MAX_ENGINES:
        _ENGINES.popitem(last=False)
    return eng


def prefetch_map(pool, fn, items, depth: int):
    """Run ``fn`` over ``items`` through ``pool``, keeping at most ``depth``
    futures outstanding, yielding ``(item, result)`` in order.

    The shared bounded-prefetch orchestration of :func:`run_study` and
    ``engine.process_batch``: lazy submission keeps peak host memory
    O(depth * batch), not O(study), while the pool stays ahead of the
    consumer."""
    items = list(items)
    q: deque = deque()
    idx = 0

    def top_up():
        nonlocal idx
        while idx < len(items) and len(q) < depth:
            q.append((items[idx], pool.submit(fn, items[idx])))
            idx += 1

    top_up()
    while q:
        item, fut = q.popleft()
        top_up()
        yield item, fut.result()


class StagingCount:
    """What the study runner's staging did since the last reset: batches
    staged, those staged into a ring slot an earlier batch had used
    ("reused"), and those whose slices more than one loader thread filled
    ("split")."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def add(self, reused: bool, split: bool) -> None:
        with self._lock:
            self.batches += 1
            self.reused += reused
            self.split += split

    def reset(self) -> None:
        with self._lock:
            self.batches = self.reused = self.split = 0

    def summary(self) -> Dict[str, Optional[float]]:
        with self._lock:
            b, r, s = self.batches, self.reused, self.split
        return {"batches": b, "reused": r, "split": s,
                "reuse_pct": 100.0 * r / b if b else None,
                "split_pct": 100.0 * s / b if b else None}


#: The study runner's staging counts; callers reset it, as ``STAGES``.
STAGING = StagingCount()


class _Slot:
    """One batch of a staging ring: the source of its batch's copy to the
    device, refilled only after that copy is done (:meth:`wait_free`)."""

    def __init__(self, tensor: torch.Tensor) -> None:
        self.tensor = tensor
        self.host = tensor.numpy()
        self.copied = None  # the event after the last copy out of the slot
        self.batches = 0    # batches staged into it

    def wait_free(self) -> None:
        copied = self.copied
        if copied is not None:  # one CUDA call a batch, not one a task
            copied.synchronize()
            self.copied = None

    def to_device(self, device: torch.device) -> torch.Tensor:
        if device.type != "cuda":
            # the device is the host: a copy out, so that the slot can be
            # refilled while the batch is still in use
            return self.tensor.clone()
        dev = self.tensor.to(device, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record(torch.cuda.current_stream(device))
        return dev


_RINGS: "OrderedDict[tuple, List[_Slot]]" = OrderedDict()
_RINGS_LOCK = threading.Lock()
_MAX_RINGS = 4


@contextlib.contextmanager
def _staging_ring(n: int, shape: tuple, dtype: np.dtype,
                  device: torch.device) -> Iterator[List[_Slot]]:
    """A ring of at least ``n`` slots of one batch shape, dtype and device
    (views of one host tensor, pinned where the device is a card) for one
    user at a time: taken from the cache (made at the first use, or when
    the cached one is too small) and put back after, the last few kept."""
    key = (str(device), shape, np.dtype(dtype))
    with _RINGS_LOCK:
        ring = _RINGS.pop(key, None)
    if ring is None or len(ring) < n:
        block = torch.from_numpy(np.empty((n,) + shape, dtype))
        if device.type == "cuda":
            block = block.pin_memory()
        ring = [_Slot(t) for t in block]
    try:
        yield ring
    finally:
        with _RINGS_LOCK:
            _RINGS[key] = ring
            while len(_RINGS) > _MAX_RINGS:
                _RINGS.popitem(last=False)


def _slice_layout(to_u8_size: Optional[int], width: int, height: int):
    """(shape, dtype) of one staged slice: the host resample's u8, or the
    RAW's u16."""
    if to_u8_size is not None:
        return (to_u8_size, to_u8_size), np.dtype(np.uint8)
    return (height, width), np.dtype(np.uint16)


class _Staging:
    """One batch being staged into ``host`` (a ring slot's array, or a
    private one) by one or more :func:`_load_batch` calls, each landing its
    rows; the call that lands the last pads the ragged tail, copies the
    batch to the device and resolves ``future`` with its result."""

    def __init__(self, host: np.ndarray, rows: int,
                 slot: Optional[_Slot] = None) -> None:
        self.host, self.rows, self.slot = host, rows, slot
        self.reused = slot is not None and slot.batches > 0
        if slot is not None:
            slot.batches += 1
        self.left = rows
        self.threads = set()
        self.lock = threading.Lock()
        self.future: Future = Future()

    def land(self, n: int) -> bool:
        """Count ``n`` landed rows; whether they were the batch's last."""
        with self.lock:
            self.threads.add(threading.get_ident())
            self.left -= n
            return self.left == 0

    def to_device(self, device: torch.device) -> torch.Tensor:
        if self.slot is not None:
            return self.slot.to_device(device)
        dev = torch.from_numpy(self.host)
        if device.type == "cuda":
            dev = dev.pin_memory().to(device, non_blocking=True)
        return dev

    def resolve(self, result=None, error: Optional[BaseException] = None):
        with self.lock:
            if self.future.done():  # an earlier row's load failed
                return
            if error is not None:
                self.future.set_exception(error)
            else:
                self.future.set_result(result)


def _load_batch(paths: Sequence[str], width: int, height: int,
                to_u8_size: Optional[int] = None,
                pad_to: Optional[int] = None,
                to_device: bool = False,
                keep_host: bool = False,
                device: str = "cuda",
                into: Optional[Tuple[_Staging, int]] = None):
    """Read + (optionally) host-preprocess a batch; optionally pad the
    ragged tail to the batch shape (the last slice repeated) and copy it to
    ``device``.

    ``to_device=True`` enqueues the host-to-device copy from the calling
    (loader) thread, from pinned memory, without waiting for it.  The copy
    goes on that thread's current stream, which is the device's default
    stream, the same stream the main thread's forward runs on: the forward
    enqueued after this returns is ordered after the copy.  ``keep_host``
    also returns the host array (the emitter needs the normalized u8):
    -> (host, device).

    ``into=(staging, row)`` (the study runner's) lands the slices in the
    rows of a batch being staged from ``row`` on and returns None; the call
    that lands the batch's last row pads and copies the batch (to the
    staging array's length, whatever ``pad_to``) and resolves
    ``staging.future`` with what this function returns otherwise."""
    private = into is None
    if private:
        shape, dtype = _slice_layout(to_u8_size, width, height)
        host = np.empty((max(len(paths), pad_to or 0),) + shape, dtype)
        into = (_Staging(host, len(paths)), 0)
    staging, row = into
    try:
        with STAGES.stage("load"):
            if staging.slot is not None:
                staging.slot.wait_free()
            dst = staging.host[row: row + len(paths)]
            # the u16 slices are read straight into their rows; for the host
            # resample read_raw maps the files, whose pages come in at the
            # first touch, in the resample
            with STAGES.stage("read"):
                if to_u8_size is None:
                    for d, p in zip(dst, paths):
                        raw_io.read_raw_into(p, width, height, d)
                else:
                    raws = [np.asarray(raw_io.read_raw(p, width, height))
                            for p in paths]
            if to_u8_size is not None:
                for d, r in zip(dst, raws):
                    d[...] = native.preprocess_u8(r, to_u8_size)
            if not staging.land(len(paths)):
                return None
            out = staging.host
            out[staging.rows:] = out[staging.rows - 1]
        dev = out
        if to_device:
            with STAGES.stage("h2d"):
                dev = staging.to_device(torch.device(device))
    except BaseException as e:
        staging.resolve(error=e)
        raise
    result = (out, dev) if keep_host else dev
    if not private:
        STAGING.add(staging.reused, len(staging.threads) > 1)
    staging.resolve(result)
    return result if private else None


class _ShareTasks:
    """A pool front for :func:`prefetch_map`: a batch (its paths) goes in
    as tasks of ``share`` slices each, in order, all into one
    :class:`_Staging` made by ``staging(rows)``; the batch's future comes
    back."""

    def __init__(self, pool, staging: Callable[[int], _Staging],
                 share: int) -> None:
        self.pool, self.staging, self.share = pool, staging, share

    def submit(self, fn, paths):
        st = self.staging(len(paths))
        for row in range(0, len(paths), self.share):
            self.pool.submit(fn, paths[row: row + self.share], (st, row))
        return st.future


def _staged(pool, batch_paths: Sequence[Sequence[str]], width: int,
            height: int, to_u8_size: Optional[int], batch_size: int,
            device: torch.device, depth: int, share: int,
            ring: Optional[List[_Slot]] = None):
    """Each batch of ``batch_paths`` as :func:`_load_batch` loads it to
    ``device``, in order, staged share by share: tasks of ``share`` slices
    through ``pool`` in batch order, so that the loader threads fill the
    oldest batch first, with at most ``depth`` batches outstanding.  The
    batches go into ``ring``'s slots in turn (``depth + 1`` of them at
    least: a slot is refilled only by a batch submitted after the one
    before it was taken); without a ring each goes into a private array,
    which is also returned: -> (host, device)."""
    shape, dtype = _slice_layout(to_u8_size, width, height)
    if ring is not None and len(ring) <= depth:
        raise ValueError(f"a ring of {len(ring)} slots for {depth} batches "
                         "in flight")
    slots = itertools.cycle(ring) if ring is not None else None

    def staging(rows: int) -> _Staging:
        if slots is None:
            return _Staging(np.empty((batch_size,) + shape, dtype), rows)
        slot = next(slots)
        return _Staging(slot.host, rows, slot)

    def load(paths, into):
        return _load_batch(paths, width, height, to_u8_size, batch_size,
                           True, keep_host=ring is None, device=device,
                           into=into)

    tasks = _ShareTasks(pool, staging, share)
    for _, res in prefetch_map(tasks, load, batch_paths, depth):
        yield res


def _pack_mask2(mask: torch.Tensor) -> torch.Tensor:
    """(N, H, W) class mask in {0,1,2,3} -> (N, H, W/4) uint8, 2 bits a
    pixel, pixel 0 in the low bits: a quarter of the device-to-host
    bytes."""
    n, h, w = mask.shape
    m = mask.to(torch.uint8).reshape(n, h, w // 4, 4)
    return (m[..., 0] | (m[..., 1] << 2) | (m[..., 2] << 4)
            | (m[..., 3] << 6))


def _unpack_mask2(packed: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`_pack_mask2` (vectorized numpy)."""
    n, h, w4 = packed.shape
    out = np.empty((n, h, w4, 4), np.uint8)
    out[..., 0] = packed & 3
    out[..., 1] = (packed >> 2) & 3
    out[..., 2] = (packed >> 4) & 3
    out[..., 3] = (packed >> 6) & 3
    return out.reshape(n, h, w4 * 4)


def _pack_mask1(mask: torch.Tensor) -> torch.Tensor:
    """(N, H, W) cleaned mask in {0, 2} -> (N, H, W/8) uint8, 1 bit a pixel,
    little-endian in each byte (``np.unpackbits(bitorder="little")``
    inverts it)."""
    n, h, w = mask.shape
    bits = (mask.reshape(n, h, w // 8, 8) != 0).to(torch.uint8)
    # the shifts are made on the device: a host tensor's copy would wait
    # for the work queued before it
    shifts = torch.arange(8, dtype=torch.uint8, device=mask.device)
    return (bits << shifts).sum(-1, dtype=torch.uint8)


def _device_stage(params, cfg: ModelConfig, u8_input: bool = False,
                  pack_masks: bool = False, device: str = "cuda"):
    """The study's device stage on the cached engine of ``params``:
    ``stage(batch) -> masks`` on the device, enqueued, not waited for.

    ``u8_input=True`` takes already-preprocessed u8 slices (the host
    bit-exact path: half the host-to-device bytes); otherwise (N, h, w)
    uint16 RAWs are resampled and quantized on the device
    (``preprocess.preprocess_batch``).  ``pack_masks=True`` packs the
    class mask 4 pixels a byte."""
    eng = study_engine(params, cfg, device)
    size = cfg.image_size

    def stage(raws: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if u8_input:
                u8, x = raws, None
            else:
                u8, x = preprocess.preprocess_batch(raws, size)
            masks = eng._pipeline(u8, x)
            return _pack_mask2(masks) if pack_masks else masks

    return stage


def _tier(artifacts: Optional[str], out_dir: Optional[str]):
    """The emitter's tier bits for ``artifacts`` (None: no artifacts),
    after checking that the emitter can run and making ``out_dir``."""
    if artifacts is None:
        return None
    if out_dir is None:
        raise ValueError("artifacts emission requires out_dir")
    tier = _TIERS[artifacts]
    if not native.emit_slice_available():
        # fail before the study runs, not in an emitter future after the
        # device work produced no artifacts
        raise RuntimeError("artifact emission requires the host library "
                           "(csrc/emit.cpp), which did not build")
    os.makedirs(out_dir, exist_ok=True)
    return tier


def _emit(u8_host, masks, paths, out_dir, width, height, tier):
    """``native.emit_batch`` of one batch's slices, timed as "emit"."""
    bases = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    with STAGES.stage("emit"):
        return native.emit_batch(
            u8_host[: len(paths)], masks, [out_dir] * len(paths), bases,
            [os.path.basename(p) for p in paths], width, height, tier)


def _check_emitted(futures) -> None:
    results = [f.result() for f in futures]
    fails = sum(int(np.sum(c < 0))
                for c in results if isinstance(c, np.ndarray))
    if fails:
        raise IOError(f"{fails} slice artifact write(s) failed")


def run_study(
    params,
    cfg: ModelConfig,
    slice_paths: Sequence[str],
    width: int,
    height: int,
    batch_size: int = 32,
    emit: Optional[Callable[[int, str, np.ndarray], None]] = None,
    loader_threads: int = 4,
    emitter_threads: Optional[int] = None,
    keep_masks: bool = False,
    host_preprocess: bool = False,
    artifacts: Optional[str] = None,
    out_dir: Optional[str] = None,
    per_class: bool = False,
    device: str = "cuda",
) -> StudyResult:
    """Run a whole study (stack of same-sized slices) through the pipeline.

    ``emit(slice_index, path, cleaned_mask)`` is called on an emitter
    thread for each slice; pass None to measure pure pipeline throughput.
    ``emitter_threads`` defaults to ``loader_threads``.

    ``artifacts`` switches on the batched native emitter (csrc/emit.cpp,
    one C call per batch, OpenMP over slices): "json" (size + contour
    JSON), "mask_json" (+ mask PNG) or "full" (the reference's five
    artifacts) under ``out_dir``; it requires ``host_preprocess=True`` (the
    emitter needs the normalized u8 on the host).  ``host_preprocess=True``
    runs the bit-exact C++ resample in the loader threads and ships u8;
    otherwise the u16 RAWs are preprocessed on the device.

    ``per_class=True`` (it requires ``artifacts``) also writes each
    slice's ``{base}_classes.json`` from its decoded mask before the
    cleanup (``engine._emit_per_class_json``), on the emitter threads.
    """
    size = cfg.image_size
    if emitter_threads is None:
        emitter_threads = loader_threads
    if artifacts is not None and not host_preprocess:
        raise ValueError("artifacts emission requires host_preprocess=True")
    tier = _tier(artifacts, out_dir)
    if per_class and tier is None:
        raise ValueError("per_class requires artifacts emission "
                         "(pass artifacts=/out_dir=)")
    # 2-bit packing quarters the device-to-host bytes; sound only when
    # every class id fits 2 bits
    pack = size % 4 == 0 and cfg.num_classes <= 4
    eng = study_engine(params, cfg, device)
    device_stage = _device_stage(params, cfg, u8_input=host_preprocess,
                                 pack_masks=pack, device=device)

    n = len(slice_paths)
    batches = [
        list(range(i, min(i + batch_size, n))) for i in range(0, n, batch_size)
    ]
    masks_out = np.empty((n, size, size), np.uint8) if keep_masks else None

    # Warm-up before the clock (the engine warms at initialize, the
    # reference at its CUDA-graph capture, src/process.cpp:92-105), once
    # per engine and batch size.
    eng.compile(batch_size)

    t0 = time.perf_counter()

    # Each loader takes a share of a batch, the oldest batch first, so the
    # first batch is ready when a share is; the batches go into a reused
    # ring of (pinned) slots.  The emitter keeps its batch's host u8 after
    # the copy, so in artifact mode each batch has a private array
    # instead.
    depth = loader_threads + 1
    u8_size = size if host_preprocess else None
    shape, dtype = _slice_layout(u8_size, width, height)
    staging_ring = (contextlib.nullcontext() if tier is not None
                    else _staging_ring(depth + 1, (batch_size,) + shape,
                                       dtype, eng.device))
    with staging_ring as ring, \
            ThreadPoolExecutor(max_workers=loader_threads) as loaders, \
            ThreadPoolExecutor(max_workers=emitter_threads) as emitters:
        pending: List[Tuple[Callable[[], np.ndarray], object, List[int]]] = []
        emit_futures = []

        def _emit_per_class(packed_or_full, paths):
            """Per-class JSONs of a batch's decoded masks (class 1 exists
            only before the cleanup), timed as "emit"."""
            with STAGES.stage("emit"):
                decoded = (_unpack_mask2(packed_or_full) if pack
                           else packed_or_full)
                for mask, p in zip(decoded, paths):
                    _emit_per_class_json(
                        mask, out_dir, os.path.splitext(os.path.basename(p))[0],
                        width, height)

        def drain(entry):
            wait, u8_host, idxs = entry
            with STAGES.stage("d2h"):
                packed_or_full = wait()[: len(idxs)]  # drop the tail's pad
            if per_class:
                with STAGES.stage("handoff"):
                    emit_futures.append(emitters.submit(
                        _emit_per_class, packed_or_full,
                        [slice_paths[k] for k in idxs]))
            with STAGES.stage("cleanup"):
                if pack:
                    masks = native.postprocess_packed_batch(packed_or_full,
                                                            size)
                else:
                    masks = native.postprocess_batch(packed_or_full)
            with STAGES.stage("handoff"):
                if keep_masks:
                    masks_out[idxs] = masks
                if tier is not None:
                    emit_futures.append(emitters.submit(
                        _emit, u8_host, masks, [slice_paths[k] for k in idxs],
                        out_dir, width, height, tier))
                if emit is not None:
                    for j, k in enumerate(idxs):
                        emit_futures.append(
                            emitters.submit(emit, k, slice_paths[k], masks[j]))

        loaded = _staged(loaders, [[slice_paths[k] for k in idxs]
                                   for idxs in batches],
                         width, height, u8_size, batch_size, eng.device,
                         depth, -(-batch_size // loader_threads), ring)
        for idxs in batches:
            with STAGES.stage("wait_load"):
                raws = next(loaded)
            # raws are on the device already (a loader-thread copy); in
            # artifact mode the loader also kept the host u8 for the emitter
            host_u8 = None
            if tier is not None:
                host_u8, raws = raws
            with STAGES.stage("dispatch"):
                pending.append((eng.to_host(device_stage(raws)), host_u8,
                                idxs))
            if len(pending) > 1:  # overlap: drain k while the device runs k+1
                drain(pending.pop(0))
        while pending:
            drain(pending.pop(0))
        _check_emitted(emit_futures)

    wall = time.perf_counter() - t0
    return StudyResult(n_slices=n, wall_s=wall, slices_per_sec=n / wall,
                       masks=masks_out)


def run_study_device_resident(
    params,
    cfg: ModelConfig,
    slice_paths: Sequence[str],
    width: int,
    height: int,
    batch_size: int = 128,
    artifacts: Optional[str] = "json",
    out_dir: Optional[str] = None,
    emitter_threads: int = 1,
    keep_masks: bool = False,
    device_postprocess: bool = False,
    device: str = "cuda",
) -> StudyResult:
    """The config-4 study with the host-to-device transport staged out of
    the timed window.

    The whole study is first put on the device (host bit-exact preprocess,
    one copy per batch, reported as ``stage_s``); the timed window then
    enqueues every batch's forward and mask copy at once and drains them in
    order: the packed masks' device-to-host copy, the C++ cleanup and the
    tiered native emit.  ``artifacts=None`` measures the artifact-free
    floor.

    ``device_postprocess=True`` runs the mask cleanup on the device
    (``ops/postprocess``, two K3 launches a batch) and ships the cleaned
    mask at 1 bit a pixel; it needs the 3-class {0, 2} cleanup contract and
    ``size % 8 == 0``.
    """
    size = cfg.image_size
    if device_postprocess and (cfg.num_classes != 3 or size % 8):
        raise ValueError("device_postprocess study mode assumes the 3-class "
                         "{0,2} cleanup contract and size % 8 == 0")
    tier = _tier(artifacts, out_dir)
    pack = size % 4 == 0 and cfg.num_classes <= 4
    eng = study_engine(params, cfg, device, device_postprocess)

    def stage(u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            masks = eng._pipeline(u8)
            if device_postprocess:
                return _pack_mask1(masks)
            return _pack_mask2(masks) if pack else masks

    n = len(slice_paths)
    batches = [
        list(range(i, min(i + batch_size, n))) for i in range(0, n, batch_size)
    ]

    # ---- staging (untimed): preprocess on host, one copy per batch --------
    t_stage = time.perf_counter()
    host_u8: List[np.ndarray] = []
    dev_u8: List[torch.Tensor] = []
    for idxs in batches:
        h, d = _load_batch([slice_paths[k] for k in idxs], width, height,
                           size, batch_size, True, keep_host=True,
                           device=eng.device)
        host_u8.append(h)
        dev_u8.append(d)
    eng.compile(batch_size)  # warm-up; waits for the copies too
    stage_s = time.perf_counter() - t_stage

    masks_out = np.empty((n, size, size), np.uint8) if keep_masks else None

    # ---- timed: enqueue every batch, then drain in order -------------------
    t0 = time.perf_counter()
    with STAGES.stage("dispatch"):
        pending = [eng.to_host(stage(d)) for d in dev_u8]
    emit_futures = []
    with ThreadPoolExecutor(max_workers=emitter_threads) as emitters:
        for bi, (idxs, wait) in enumerate(zip(batches, pending)):
            with STAGES.stage("d2h"):
                packed_np = wait()[: len(idxs)]  # drop the tail's pad
            with STAGES.stage("cleanup"):
                if device_postprocess:
                    # cleaned on the device; 1 bit a pixel -> {0, 2}
                    masks = np.unpackbits(
                        packed_np, axis=-1, bitorder="little") * np.uint8(2)
                elif pack:
                    masks = native.postprocess_packed_batch(packed_np, size)
                else:
                    masks = native.postprocess_batch(packed_np)
            if keep_masks:
                masks_out[idxs] = masks
            if tier is not None:
                emit_futures.append(emitters.submit(
                    _emit, host_u8[bi], masks,
                    [slice_paths[k] for k in idxs], out_dir, width, height,
                    tier))
        _check_emitted(emit_futures)
    wall = time.perf_counter() - t0

    return StudyResult(n_slices=n, wall_s=wall, slices_per_sec=n / wall,
                       masks=masks_out, stage_s=stage_s)


def measure_p50_latency(params, cfg: ModelConfig, raw: np.ndarray,
                        width: int, height: int, iters: int = 20,
                        device: str = "cuda") -> float:
    """p50 single-slice RAW -> polygons latency in seconds (BASELINE
    metric 3).

    The engine's per-image flow: bit-exact host preprocess -> u8 to the
    device -> UNet + argmax -> host cleanup -> contour trace -> JSON bytes.
    File I/O is excluded (the RAW is preloaded, no artifact is written)."""
    size = cfg.image_size
    eng = study_engine(params, cfg, device)

    def once() -> None:
        u8h = native.preprocess_u8(np.asarray(raw), size)
        m = eng.to_host(eng._masks(eng._put(u8h[None])))()
        mask = native.postprocess_batch(m[0])
        vis = np.where(mask == 2, 255, 0).astype(np.uint8)
        contours = native.extract_contours(vis)
        if contours:
            native.contour_json_bytes(contours, "slice", width, height,
                                      width / size, height / size)

    once()  # warm-up
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        once()
        lat.append(time.perf_counter() - t0)
    return float(np.percentile(lat, 50))
