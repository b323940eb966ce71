"""Full-study throughput runner (BASELINE config 4: a 300-slice CT study),
the port of ``unetseg_tpu.parallel.pipeline``.

A three-stage host/device pipeline replacing the reference's serial
per-file loop (src/main.cpp:148-164):

  stage A (host thread pool): read RAW slices, assemble batches, copy them
                              to the device
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
their threads).
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.engine import InferenceEngine, not_ported
from unetseg_tpu_torch.io import native, raw as raw_io
from unetseg_tpu_torch.ops import preprocess
from unetseg_tpu_torch.utils.profiling import StageTimer

#: Host stages of the last studies: "load" (read, host preprocess, tail
#: padding) and "h2d" (pinning and enqueueing the copy to the device), on
#: the loader threads (in the device-resident mode: its untimed staging);
#: "d2h" (waiting for a batch's masks on the host: the device's remaining
#: work and the copy), "cleanup" (host C++ cleanup, or the 1-bit unpack),
#: "emit" (artifacts, on the emitter threads).  Callers reset it.
STAGES = StageTimer()

_TIERS = {"json": native.TIER_JSON, "mask_json": native.TIER_MASK_JSON,
          "full": native.TIER_FULL}
_ENGINES: "OrderedDict[tuple, Tuple[dict, InferenceEngine]]" = OrderedDict()
_MAX_ENGINES = 4


@dataclass
class StudyResult:
    n_slices: int
    wall_s: float
    slices_per_sec: float
    inference_s: float
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


def _load_batch(paths: Sequence[str], width: int, height: int,
                to_u8_size: Optional[int] = None,
                pad_to: Optional[int] = None,
                to_device: bool = False,
                keep_host: bool = False,
                device: str = "cuda"):
    """Read + (optionally) host-preprocess a batch; optionally pad the
    ragged tail to the batch shape (the last slice repeated) and copy it to
    ``device``.

    ``to_device=True`` enqueues the host-to-device copy from the calling
    (loader) thread, from pinned memory, without waiting for it.  The copy
    goes on that thread's current stream, which is the device's default
    stream, the same stream the main thread's forward runs on: the forward
    enqueued after this returns is ordered after the copy.  ``keep_host``
    also returns the host array (the emitter needs the normalized u8):
    -> (host, device)."""
    with STAGES.stage("load"):
        raws = [np.asarray(raw_io.read_raw(p, width, height)) for p in paths]
        if to_u8_size is not None:
            out = np.stack([native.preprocess_u8(r, to_u8_size)
                            for r in raws])
        else:
            out = np.stack(raws)
        if pad_to is not None and out.shape[0] < pad_to:
            pad = np.repeat(out[-1:], pad_to - out.shape[0], axis=0)
            out = np.concatenate([out, pad], axis=0)
    dev = out
    if to_device:
        with STAGES.stage("h2d"):
            dev = torch.from_numpy(out)
            if torch.device(device).type == "cuda":
                dev = dev.pin_memory().to(device, non_blocking=True)
    if keep_host:
        return out, dev
    return dev


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

    ``per_class=True`` (per-class JSON, P6) is not ported: it raises.
    """
    if per_class:
        raise not_ported("per-class JSON", "P6")
    size = cfg.image_size
    if emitter_threads is None:
        emitter_threads = loader_threads
    if artifacts is not None and not host_preprocess:
        raise ValueError("artifacts emission requires host_preprocess=True")
    tier = _tier(artifacts, out_dir)
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
    inference_s = 0.0

    def load(idxs):
        return _load_batch([slice_paths[k] for k in idxs], width, height,
                           size if host_preprocess else None, batch_size,
                           True, keep_host=tier is not None,
                           device=eng.device)

    with ThreadPoolExecutor(max_workers=loader_threads) as loaders, \
            ThreadPoolExecutor(max_workers=emitter_threads) as emitters:
        pending: List[Tuple[Callable[[], np.ndarray], object, List[int]]] = []
        emit_futures = []

        def drain(entry):
            wait, u8_host, idxs = entry
            with STAGES.stage("d2h"):
                packed_or_full = wait()[: len(idxs)]  # drop the tail's pad
            with STAGES.stage("cleanup"):
                if pack:
                    masks = native.postprocess_packed_batch(packed_or_full,
                                                            size)
                else:
                    masks = native.postprocess_batch(packed_or_full)
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

        for idxs, raws in prefetch_map(loaders, load, batches,
                                       loader_threads + 1):
            # raws are on the device already (a loader-thread copy); in
            # artifact mode the loader also kept the host u8 for the emitter
            host_u8 = None
            if tier is not None:
                host_u8, raws = raws
            t_inf = time.perf_counter()
            masks_dev = device_stage(raws)
            pending.append((eng.to_host(masks_dev), host_u8, idxs))
            if len(pending) > 1:  # overlap: drain k while the device runs k+1
                drain(pending.pop(0))
            inference_s += time.perf_counter() - t_inf
        while pending:
            drain(pending.pop(0))
        _check_emitted(emit_futures)

    wall = time.perf_counter() - t0
    return StudyResult(n_slices=n, wall_s=wall, slices_per_sec=n / wall,
                       inference_s=inference_s, masks=masks_out)


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
                       inference_s=wall,  # the device work is all timed
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
