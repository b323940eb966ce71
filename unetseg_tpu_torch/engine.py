"""Engine lifecycle and the serving pipelines, on PyTorch.

The port of ``unetseg_tpu/engine.py``'s default serving mode, with the
reference's entry points (include/initialize.h:12, include/process.h:29,
include/cleanup.h:7) and its five artifacts per image:
``{base}_normalized.png``, ``{base}_original_sizes.json``,
``{base}_mask.png``, ``{base}_contour_overlay.png`` and ``{base}.json``.

Per slice: host C++ preprocess to 512² u8 -> device u8/255, UNet, first-max
argmax -> host C++ mask cleanup and artifact emission.  In the all-device
mode (``device_postprocess=True``) the mask cleanup runs on the device
instead, inside the pipeline (``ops/postprocess.py``, two K3 CCL launches
per batch), for hosts too poor in cores to keep up.
``process_single_image`` also serves the 8-fold dihedral TTA ensemble
(``tta=True``, :meth:`InferenceEngine.infer_tta`) and sliding windows at
native resolution (``window=``, :meth:`InferenceEngine.infer_tiled`).
Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
without CUDA they fail rather than fall back.  Still to port (ROADMAP.md
queue A): per-class JSON, the confidence cascade, the partition pool and
CUDA-graph capture.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from unetseg_tpu_torch import checkpoint
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.io import native, raw as raw_io
from unetseg_tpu_torch.models import registry as model_registry
from unetseg_tpu_torch.ops import postprocess, preprocess
from unetseg_tpu_torch.parallel import tiles, tta
from unetseg_tpu_torch.utils.logger import GLOBAL_LOG, derive_log_dir

#: Artifact tiers of batched processing: which of the five artifacts a
#: deployment keeps.  The contour JSON is in every tier.
ARTIFACT_TIERS = ("full", "mask_json", "json")
_TIER_BITS = {"full": native.TIER_FULL, "mask_json": native.TIER_MASK_JSON,
              "json": native.TIER_JSON}
#: Artifact writers a caller may name.  Both write through the C++ emitter
#: (csrc/emit.cpp): its PNGs are pixel-equal and its JSONs byte-equal to the
#: JAX package's cv2 path; only the PNG bytes may differ from cv2's.
EMITTERS = ("cv2", "native")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to unetseg_tpu_torch yet (ROADMAP.md queue A, "
        f"{item})")


class InferenceEngine:
    """The model on one device plus the batch sizes already warmed up."""

    def __init__(self, params, cfg: ModelConfig, device: str = "cuda",
                 device_postprocess: bool = False):
        self.cfg = cfg
        self.size = cfg.image_size  # the reference fixes 512 (process.cpp:70)
        self.device = torch.device(device)
        # All-device serving: the mask cleanup runs in the pipeline.
        self.device_postprocess = device_postprocess
        # The JAX-layout tree the model was built from: TTA transforms it.
        self.params = params
        self.model = model_registry.build(params, cfg, self.device)
        self._warm: set = set()
        self._tta = None  # the weight-space ensemble, built at first use
        #: Model passes run (a TTA call makes 8, a tiled image one per
        #: chunk of windows), so a caller can hold kernel launch counts
        #: against them.
        self.forwards = 0

    def _masks(self, u8_batch: torch.Tensor) -> torch.Tensor:
        """(N, S, S) uint8 on the engine's device -> (N, S, S) uint8 class
        masks: u8/255 -> UNet -> first-max argmax (``UNet.masks``: fused
        into the last decoder level for a stem-1 model)."""
        self.forwards += 1
        with torch.inference_mode():
            x = preprocess.model_input_from_u8(u8_batch)[..., None]
            return self.model.masks(x)

    def _pipeline(self, u8_batch: torch.Tensor) -> torch.Tensor:
        """:meth:`_masks`, then the mask cleanup when it runs on the
        device."""
        masks = self._masks(u8_batch)
        if self.device_postprocess:
            with torch.inference_mode():
                masks = postprocess.postprocess_masks(masks)
        return masks

    def compile(self, batch_size: int) -> None:
        """Warm up the pipeline for a batch size (the reference's warm-up
        run, src/process.cpp:92-105)."""
        if batch_size in self._warm:
            return
        self._pipeline(torch.zeros((batch_size, self.size, self.size),
                                   dtype=torch.uint8, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm.add(batch_size)

    def _put(self, host: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device (the copy is
        enqueued, not waited for)."""
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def infer(self, u8_batch: np.ndarray) -> torch.Tensor:
        """Enqueue the pipeline on a host (N, S, S) uint8 batch; returns the
        mask tensor on the device without waiting for it."""
        self.compile(u8_batch.shape[0])
        return self._pipeline(self._put(np.asarray(u8_batch, np.uint8)))

    def infer_tta(self, u8_2d: np.ndarray) -> torch.Tensor:
        """8-fold dihedral TTA on one (S, S) uint8 slice -> (S, S) mask on
        the device (BASELINE config 5), cleaned when the cleanup runs on the
        device.

        The weight-space form, as the JAX engine serves the ``unet`` arch:
        8 passes of the untransposed slice through models whose kernels
        carry the inverse transforms (``parallel/tta.py``), built at the
        first call and kept.  Each pass runs ``UNet.forward``: the logits
        are averaged before the argmax, and the fused last level (K6)
        returns masks only, so a stem-1 model's last level runs in the conv
        kernel here."""
        if self._tta is None:
            self._tta = tta.make_tta_weightspace_pipeline(
                self.params, self.cfg, self.device,
                device_postprocess=self.device_postprocess)
        self.forwards += tta.N_TRANSFORMS
        return self._tta(self._put(np.asarray(u8_2d, np.uint8))[None])[0]

    def infer_tiled(self, u8_2d, window: int,
                    overlap: Optional[int] = None) -> torch.Tensor:
        """Sliding windows at native resolution on one (H, W) uint8 image
        (numpy, or a tensor on the device) -> (H, W) mask on the device
        (BASELINE config 3), cleaned when the cleanup runs on the device.

        As in the JAX engine, the window and overlap are
        :meth:`tile_window`'s: only an image whose shorter side is below the
        alignment is edge-padded, and its logits are cropped back before
        the argmax, so the device cleanup's 6%-of-area threshold sees the
        image's own size.  The windows run ``UNet.forward`` in chunks of
        ``tiles.MODEL_CHUNK``, each chunk one count of :attr:`forwards`:
        their logits are blended before the argmax, so no K6."""
        u8 = (u8_2d.to(self.device) if isinstance(u8_2d, torch.Tensor)
              else self._put(np.asarray(u8_2d, np.uint8)))
        window, overlap = self.tile_window(*u8.shape, window, overlap)
        pipeline = tiles.make_tiled_pipeline(
            self.model, window=window, overlap=overlap,
            device_postprocess=self.device_postprocess,
            on_pass=self._count_pass)
        return pipeline(u8)

    def tile_window(self, h: int, w: int, window: int,
                    overlap: Optional[int] = None) -> Tuple[int, int]:
        """(window, overlap) that :meth:`infer_tiled` runs on an (h, w)
        image: the window clamped to the image, aligned down to a multiple
        of ``stem * 2**depth`` (the UNet's pooling needs it; at least one
        alignment), the overlap half of it by default and below it."""
        align = self.cfg.stem * (2 ** self.cfg.depth)
        window = min(window, h, w)
        window = max(align, window - window % align)
        if overlap is None:
            overlap = window // 2
        return window, min(overlap, window - 1) if window > 1 else 0

    def _count_pass(self) -> None:
        self.forwards += 1

    def to_host(self, masks: torch.Tensor) -> Callable[[], np.ndarray]:
        """Queue the copy of ``masks`` to the host; returns a function that
        waits for that copy alone and gives the numpy array.  Work enqueued
        after this call keeps running while the host waits."""
        if masks.device.type != "cuda":
            host = masks.numpy()
            return lambda: host
        host = torch.empty(masks.shape, dtype=masks.dtype, pin_memory=True)
        host.copy_(masks, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))

        def wait() -> np.ndarray:
            done.synchronize()
            return host.numpy()
        return wait

    def cleanup_masks(self, masks: np.ndarray) -> np.ndarray:
        """Host mask cleanup (C++, reference postprocess.cpp semantics);
        identity when the cleanup already ran on the device."""
        if self.device_postprocess:
            return np.asarray(masks)
        return native.postprocess_batch(np.asarray(masks))


_engine: Optional[InferenceEngine] = None


def get_engine() -> Optional[InferenceEngine]:
    return _engine


def initialize_engine(cache_path: str, log_dir: Optional[str] = None,
                      device: str = "cuda", device_postprocess: bool = False,
                      cascade_ckpt: Optional[str] = None) -> bool:
    """Load the checkpoint, open the log and warm up batch 1.

    ``device_postprocess=True`` runs the mask cleanup on the device, inside
    the pipeline (all-device serving for host-poor deployments).  Returns
    False, with the error in the log, on any failure, including a
    ``device="cuda"`` request on a host without CUDA.
    """
    global _engine
    if cascade_ckpt:
        raise not_ported("the confidence cascade", "P8")
    try:
        if log_dir is None:
            log_dir = derive_log_dir(cache_path)
        if not GLOBAL_LOG.open(log_dir):
            _engine = None
            return False
        GLOBAL_LOG.write("=== Initializing Medical Image Segmentation Engine ===")
        GLOBAL_LOG.write(f"Engine Cache: {cache_path}")
        if not os.path.exists(cache_path):
            GLOBAL_LOG.write(f"Error: engine cache file not found - {cache_path}")
            _engine = None
            return False

        params, cfg = checkpoint.load(cache_path)
        eng = InferenceEngine(params, cfg, device, device_postprocess)
        t0 = time.perf_counter()
        eng.compile(1)
        compile_ms = int((time.perf_counter() - t0) * 1000)
        _engine = eng

        size = cfg.image_size
        GLOBAL_LOG.write("Engine initialized successfully")
        GLOBAL_LOG.write(f"Context compiled for fixed {size}x{size} input")
        GLOBAL_LOG.write(f"  Input size: {size * size * 4} bytes")
        GLOBAL_LOG.write(
            f"  Output size: {cfg.num_classes * size * size * 4} bytes "
            f"(classes={cfg.num_classes})")
        GLOBAL_LOG.record(event="init", cache=cache_path, compile_ms=compile_ms,
                          device=str(eng.device),
                          device_postprocess=device_postprocess)
        return True
    except Exception as e:
        print(f"Initialization error: {e}")
        if GLOBAL_LOG.is_open():
            GLOBAL_LOG.write(f"Initialization error: {e}")
        _engine = None  # never leave a half-initialized engine servable
        return False


def cleanup_resources() -> None:
    """Ordered teardown, parity with src/cleanup.cpp:10-64."""
    global _engine
    if GLOBAL_LOG.is_open():
        GLOBAL_LOG.write("=== Cleaning up resources ===")
    _engine = None
    if GLOBAL_LOG.is_open():
        GLOBAL_LOG.write("Cleanup completed")
    GLOBAL_LOG.close()


def process_single_image(raw_path: str, width: int, height: int,
                         output_dir: str, *, tta: bool = False,
                         window: Optional[int] = None,
                         overlap: Optional[int] = None,
                         per_class: bool = False,
                         eng: Optional[InferenceEngine] = None) -> bool:
    """One RAW -> its five artifacts in ``output_dir``; False on failure.

    As in the reference (src/mask2polygon.cpp:183-188), a mask without
    contours skips the overlay and the contour JSON.  ``tta=True`` serves
    the 8-fold dihedral ensemble (:meth:`InferenceEngine.infer_tta`).
    ``window`` switches to sliding windows at native resolution
    (:meth:`InferenceEngine.infer_tiled`): the RAW is min-max quantized on
    the device without the 512² resample (``preprocess.normalize_u8``), and
    the artifacts are written at the image's own size, so the size JSON's
    scaled size is the original size.  ``window`` takes precedence over
    ``tta``, as in the JAX engine.  ``overlap`` defaults to half the
    window and is ignored without ``window``.  ``eng`` overrides the global
    engine.
    """
    if per_class:
        raise not_ported("per-class JSON", "P6")
    try:
        eng = eng or get_engine()
        if eng is None:
            raise RuntimeError("Engine not initialized")
        base_name = os.path.splitext(os.path.basename(raw_path))[0]
        GLOBAL_LOG.write(
            f"\n=== Processing Image: {os.path.basename(raw_path)} ===")
        os.makedirs(output_dir, exist_ok=True)
        t_total = time.perf_counter()

        raw = raw_io.read_raw(raw_path, width, height)
        if window is not None:
            with torch.inference_mode():
                u8_dev = preprocess.normalize_u8(eng._put(np.array(raw)))
            u8 = u8_dev.cpu().numpy()
        else:
            u8 = native.preprocess_u8(np.asarray(raw), eng.size)

        t_inf = time.perf_counter()
        if window is not None:
            masks = eng.infer_tiled(u8_dev, window, overlap)[None]
        elif tta:
            masks = eng.infer_tta(u8)[None]
        else:
            masks = eng.infer(u8[None])
        mask = eng.to_host(masks)()
        inference_ms = int((time.perf_counter() - t_inf) * 1000)
        GLOBAL_LOG.write(f"Inference time: {inference_ms} ms")

        clean = eng.cleanup_masks(mask)
        n_contours = native.emit_batch(
            u8[None], clean, [output_dir], [base_name],
            [os.path.basename(raw_path)], width, height, native.TIER_FULL)[0]
        if n_contours < 0:
            raise RuntimeError(f"writing the artifacts of {base_name} failed")
        if n_contours == 0:
            print("Warning: No Contours Detected")

        total_ms = int((time.perf_counter() - t_total) * 1000)
        GLOBAL_LOG.write(f"Total processing time: {total_ms} ms")
        GLOBAL_LOG.write(f"Processing completed for: {base_name}")
        GLOBAL_LOG.record(event="image", file=os.path.basename(raw_path),
                          inference_ms=inference_ms, total_ms=total_ms)
        print(f"Total processing time: {total_ms} ms")
        return True
    except Exception as e:
        print(f"Processing error: {e}")
        if GLOBAL_LOG.is_open():
            GLOBAL_LOG.write(f"Processing error: {e}")
        return False


def _prefetch_map(pool, fn, items, depth: int):
    """Run ``fn`` over ``items`` through ``pool`` with at most ``depth``
    futures outstanding, yielding results in order (peak host memory
    O(depth * batch))."""
    items = list(items)
    q: deque = deque()
    idx = 0

    def top_up():
        nonlocal idx
        while idx < len(items) and len(q) < depth:
            q.append(pool.submit(fn, items[idx]))
            idx += 1

    top_up()
    while q:
        fut = q.popleft()
        top_up()
        yield fut.result()


def process_batch(raw_paths: List[str], width: int, height: int,
                  output_dirs: List[str], batch_size: int = 128,
                  eng: Optional[InferenceEngine] = None,
                  emitter: str = "cv2", tier: str = "full",
                  per_class: bool = False) -> Tuple[int, int]:
    """Batched pipeline over same-sized RAW slices; returns (ok, failed).

    Two loader threads read and preprocess the next chunks while the device
    runs; each batch's masks are copied back behind that batch alone, so the
    host cleans and emits batch k while the device runs batch k+1.  A
    ragged tail is padded to the next power-of-two batch (last slice
    repeated, pad rows dropped), so at most log2(batch_size) + 1 batch
    sizes are ever warmed up.  Per-file failures drop only that slice
    (src/main.cpp:159-163).  ``tier`` is one of ARTIFACT_TIERS and
    ``emitter`` one of EMITTERS; ``eng`` overrides the global engine.
    """
    if per_class:
        raise not_ported("per-class JSON", "P6")
    eng = eng or get_engine()
    if eng is None:
        raise RuntimeError("Engine not initialized")
    if tier not in ARTIFACT_TIERS:
        raise ValueError(f"tier must be one of {ARTIFACT_TIERS}, got {tier!r}")
    if emitter not in EMITTERS:
        raise ValueError(f"emitter must be one of {EMITTERS}, got {emitter!r}")
    tier_bits = _TIER_BITS[tier]
    n_ok = n_fail = 0
    pending = []  # (wait for host masks, u8 batch, [(path, out_dir)])

    def drain(entry):
        nonlocal n_ok, n_fail
        wait, u8s, metas = entry
        n = len(metas)
        masks = eng.cleanup_masks(wait()[:n])
        for d in {d for _, d in metas}:
            os.makedirs(d, exist_ok=True)
        counts = native.emit_batch(
            u8s[:n], masks, [d for _, d in metas],
            [os.path.splitext(os.path.basename(p))[0] for p, _ in metas],
            [os.path.basename(p) for p, _ in metas], width, height, tier_bits)
        ok = int(np.sum(counts >= 0))
        n_ok += ok
        n_fail += n - ok

    def load_chunk(cd):
        chunk, dirs = cd
        u8_list, good, n_bad = [], [], 0
        for p, d in zip(chunk, dirs):
            try:
                u8_list.append(native.preprocess_u8(
                    np.asarray(raw_io.read_raw(p, width, height)), eng.size))
                good.append((p, d))
            except Exception as e:
                print(f"Processing error: {e}")
                n_bad += 1
        if not u8_list:
            return None, good, n_bad
        u8s = np.stack(u8_list)
        n = u8s.shape[0]
        if n < batch_size:
            bucket = 1 << (n - 1).bit_length()
            if bucket > n:
                u8s = np.concatenate([u8s, np.repeat(u8s[-1:], bucket - n, 0)])
        return u8s, good, n_bad

    chunks = [(raw_paths[i: i + batch_size], output_dirs[i: i + batch_size])
              for i in range(0, len(raw_paths), batch_size)]
    with ThreadPoolExecutor(max_workers=2) as loaders:
        for u8s, good, n_bad in _prefetch_map(loaders, load_chunk, chunks, 2):
            n_fail += n_bad
            if u8s is None:
                continue
            t_inf = time.perf_counter()
            wait = eng.to_host(eng.infer(u8s))
            GLOBAL_LOG.record(
                event="batch", n=len(good),
                dispatch_ms=round((time.perf_counter() - t_inf) * 1e3, 3))
            pending.append((wait, u8s, good))
            if len(pending) > 1:
                drain(pending.pop(0))
        while pending:
            drain(pending.pop(0))
    return n_ok, n_fail
