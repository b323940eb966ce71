"""Engine lifecycle and the serving pipelines, on PyTorch.

The port of ``unetseg_tpu/engine.py``, with the reference's entry points
(include/initialize.h:12, include/process.h:29, include/cleanup.h:7) and its
five artifacts per image: ``{base}_normalized.png``,
``{base}_original_sizes.json``, ``{base}_mask.png``,
``{base}_contour_overlay.png`` and ``{base}.json``.

Per slice: host C++ preprocess to 512² u8 -> device u8/255, UNet, first-max
argmax -> host C++ mask cleanup and artifact emission.  In the all-device
mode (``device_postprocess=True``) the mask cleanup runs on the device
instead, inside the pipeline (``ops/postprocess.py``, two K3 CCL launches
per batch), for hosts too poor in cores to keep up.
``process_single_image`` also serves the 8-fold dihedral TTA ensemble
(``tta=True``, :meth:`InferenceEngine.infer_tta`) and sliding windows at
native resolution (``window=``, :meth:`InferenceEngine.infer_tiled`).
``per_class=True`` adds ``{base}_classes.json``, every class's contours
from the decoded mask before the cleanup (BASELINE config 2).  With a
confidence cascade attached (``initialize_engine(cascade_ckpt=...)``,
:meth:`InferenceEngine.attach_cascade`) slices the router finds suspect are
served by a stronger fallback model (:meth:`InferenceEngine.infer_cascade`).
An engine may hold a list of devices (``devices=``): one replica of the
model on each, a batch that splits evenly over them split into contiguous
parts in batch order, one per device, the masks gathered back in order (the
JAX engine's dp mesh); :func:`make_partitioned_engines` splits the visible
devices into disjoint engines for concurrent callers (the service's
``--partitions`` pool).  Entry points run on ``device="cuda"`` unless the
caller asks for the CPU; without CUDA they fail rather than fall back.
Image rows split over devices (the spatial split, sp) are served by
``parallel.batch.make_sharded_pipeline(spatial=True)``.  An engine on
one card captures its forward into CUDA graphs when it warms a batch size
(:meth:`InferenceEngine.compile`, the reference's capture at warm-up,
src/process.cpp:90-105) and replays them for batches of that size
(``graphs.py``).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from unetseg_tpu_torch import checkpoint, graphs
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.io import native, raw as raw_io
from unetseg_tpu_torch.models import registry as model_registry
from unetseg_tpu_torch.ops import confidence, postprocess, preprocess
from unetseg_tpu_torch.ops.decode import decode_mask
from unetseg_tpu_torch.parallel import mesh as pmesh, tiles, tta
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
#: Routers of the confidence cascade (:meth:`InferenceEngine.attach_cascade`).
ROUTERS = ("margin", "disagree", "both")


class InferenceEngine:
    """The model on one device, or a replica on each of several, plus the
    batch sizes already warmed up."""

    def __init__(self, params, cfg: ModelConfig, device: str = "cuda",
                 device_postprocess: bool = False,
                 devices: Optional[List] = None):
        """``devices`` (default ``[device]``) pins the engine to a device
        list; with more than one, batches that split evenly over them run
        data-parallel (:meth:`_run`).  A device may repeat: the split is by
        position, and a repeated device shares one replica."""
        self.cfg = cfg
        self.size = cfg.image_size  # the reference fixes 512 (process.cpp:70)
        self.devices = [torch.device(d) for d in (
            [device] if devices is None else devices)]
        if not self.devices:
            raise ValueError("an engine needs at least one device")
        self.device = self.devices[0]
        self.mesh = (pmesh.make_mesh(devices=self.devices)
                     if len(self.devices) > 1 else None)
        # All-device serving: the mask cleanup runs in the pipeline.
        self.device_postprocess = device_postprocess
        # The JAX-layout tree the model was built from: TTA transforms it.
        self.params = params
        self.models = pmesh.replicate(
            lambda d: model_registry.build(params, cfg, d), self.devices)
        self.model = self.models[0]
        self._warm: set = set()
        #: Forward graphs by ``graphs.key`` (the model input's shape, dtype
        #: and device), captured by :meth:`compile`, all in one memory
        #: pool.
        self._graphs: dict = {}
        self._tta = None  # (form, ensemble, passes), built at first use
        #: Model passes run (a TTA call makes 8, a tiled image one per
        #: chunk of windows, a cascade call one per model it runs), so a
        #: caller can hold kernel launch counts against them.
        self.forwards = 0
        #: Forwards of :meth:`_masks_on` a graph replay served (each also
        #: counted in :attr:`forwards`).
        self.graph_replays = 0
        # The confidence cascade (attach_cascade): the fallback, an engine
        # of its own on these devices, and the co-model on each device.
        self._fallback: Optional[InferenceEngine] = None
        self._cascade_co_models = None
        self._cascade_co = (None, None)  # (params, cfg) of the co-model
        self.cascade_router: Optional[str] = None

    def _shards(self, n: int) -> Optional[List[torch.device]]:
        """The devices a batch of ``n`` splits over, or None: the batch runs
        on the first device (one device, or ``n`` not a multiple of their
        count, as the JAX engine's ``_batch_sharding``)."""
        if self.mesh is None or n % self.mesh.shape["dp"]:
            return None
        return pmesh.dp_devices(self.mesh)

    def _run(self, fn: Callable, u8_batch: torch.Tensor,
             x: Optional[torch.Tensor] = None):
        """``fn(i, u8, x)`` (``i`` the device's position) on each device's
        contiguous part of a batch on the first device, the results (a
        tensor, or a tuple of tensors and Nones) gathered back there in
        batch order; the whole batch as part 0 when it does not split."""
        shards = self._shards(u8_batch.shape[0])
        if shards is None:
            return fn(0, u8_batch, x)
        xs = (pmesh.split_batch(x, shards) if x is not None
              else [None] * len(shards))
        outs = [fn(i, u8, xp) for i, (u8, xp) in enumerate(
            zip(pmesh.split_batch(u8_batch, shards), xs))]
        if not isinstance(outs[0], tuple):
            return pmesh.gather_batch(outs, self.device)
        return tuple(None if parts[0] is None
                     else pmesh.gather_batch(parts, self.device)
                     for parts in zip(*outs))

    def _masks_on(self, i: int, u8: torch.Tensor,
                  x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One device's forward: u8/255 -> ``models[i].masks`` (fused into
        the last decoder level for a stem-1 model); a replay of the graph
        :meth:`compile` captured for the model input where there is one
        (:meth:`_graph_for`), else eager."""
        self.forwards += 1
        with torch.inference_mode():
            if x is None:
                x = preprocess.model_input_from_u8(u8)[..., None]
            graph = self._graph_for(x)
            if graph is not None:
                self.graph_replays += 1
                return graph.replay(x)
            return self.models[i].masks(x)

    def _masks(self, u8_batch: torch.Tensor,
               x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, S, S) uint8 on the engine's device -> (N, S, S) uint8 class
        masks: u8/255 -> UNet -> first-max argmax, split over the devices
        when the batch splits.  ``x`` is the model input when the caller
        already has it (``preprocess.preprocess_batch`` gives both)."""
        return self._run(self._masks_on, u8_batch, x)

    def _pipeline(self, u8_batch: torch.Tensor,
                  x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`_masks`, then the mask cleanup when it runs on the
        device: on each part, where it lies (the cleanup is per image)."""
        return self._run(
            lambda i, u8, xp: self._post(self._masks_on(i, u8, xp)),
            u8_batch, x)

    def _post(self, masks: torch.Tensor) -> torch.Tensor:
        """The mask cleanup, when it runs on the device."""
        if not self.device_postprocess:
            return masks
        with torch.inference_mode():
            return postprocess.postprocess_masks(masks)

    def _graph_for(self, x) -> Optional[graphs.ForwardGraph]:
        """The graph that serves the model input ``x``, or None (eager):
        an engine on one device, and ``x`` a plain tensor of a shape, dtype
        and device :meth:`compile` captured (``graphs.lookup``)."""
        if self.mesh is not None:
            return None
        return graphs.lookup(self._graphs, x)

    def _capturable(self) -> bool:
        """Whether :meth:`compile` captures: an engine on one card."""
        return self.mesh is None and self.device.type == "cuda"

    def compile(self, batch_size: int) -> None:
        """Warm up the pipeline for a batch size (the reference's warm-up
        run, src/process.cpp:92-105): one eager run, which also builds the
        kernel libraries; then, on one card, capture the forward at that
        size (:meth:`_capture`)."""
        if batch_size in self._warm:
            return
        u8 = torch.zeros((batch_size, self.size, self.size),
                         dtype=torch.uint8, device=self.device)
        self._pipeline(u8)
        self._synchronize()
        if self._capturable():
            self._capture(u8)
        self._warm.add(batch_size)

    def _capture(self, u8: torch.Tensor) -> None:
        """``model.masks`` on the model input (N, S, S, 1) float32 of
        ``u8``'s batch: what :meth:`_masks_on` makes of a u8 batch, and
        what the study's device preprocess hands :meth:`_pipeline`.  The
        engine's graphs share one memory pool: they replay one at a time."""
        pool = next(iter(self._graphs.values())).pool if self._graphs \
            else None
        with torch.inference_mode():
            x = preprocess.model_input_from_u8(u8)[..., None]
            self._graphs[graphs.key(x)] = graphs.ForwardGraph(
                self.model.masks, x, pool)

    def _synchronize(self) -> None:
        for d in set(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

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
        the first device (BASELINE config 5), cleaned when the cleanup runs
        on the device.  The form is picked at the first call, as the JAX
        engine picks it, and kept:

        * a float family on several devices whose count divides 8: the
          weight-space ensemble over them
          (``tta.make_tta_weightspace_mesh_pipeline``);
        * a float family otherwise: the weight-space ensemble on the first
          device, 8 passes of the untransposed slice through models whose
          kernels carry the inverse transforms;
        * ``unet_w8a8`` (its activation scales are not transform-aware)
          and a family whose forward does not commute with the transforms
          (``registry.Family.equivariant``: TransUNet's attention and
          position embedding): the activation-space ensemble, the 8 views
          over the devices in one pass a device when their count divides
          8, else one pass of the 8 views on the first device.

        Every pass runs the model's ``forward``: the logits are averaged
        before the argmax, and the fused last level (K6) returns masks
        only, so a stem-1 model's last level runs in the conv kernel here."""
        if self._tta is None:
            post = self.device_postprocess
            split = self.mesh is not None and \
                tta.N_TRANSFORMS % self.mesh.shape["dp"] == 0
            if self.cfg.arch == "unet_w8a8" or \
                    not model_registry.get(self.cfg.arch).equivariant:
                self._tta = ("act", tta.make_tta_pipeline(
                    self.models if split else self.model,
                    device_postprocess=post,
                    mesh=self.mesh if split else None),
                    len(self.devices) if split else 1)
            elif split:
                self._tta = ("ws", tta.make_tta_weightspace_mesh_pipeline(
                    self.params, self.cfg, self.mesh,
                    device_postprocess=post), tta.N_TRANSFORMS)
            else:
                self._tta = ("ws", tta.make_tta_weightspace_pipeline(
                    self.params, self.cfg, self.device,
                    device_postprocess=post), tta.N_TRANSFORMS)
        form, ensemble, passes = self._tta
        u8 = self._put(np.asarray(u8_2d, np.uint8))
        self.forwards += passes
        if form == "act":
            return ensemble(u8)
        return ensemble(u8[None])[0]

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
        their logits are blended before the argmax, so no K6.  On several
        devices the windows split over them, as JAX's engine shards them
        over its mesh whatever their count (``tiles.dp_logits``), and
        the blend runs on the first device."""
        u8 = (u8_2d.to(self.device) if isinstance(u8_2d, torch.Tensor)
              else self._put(np.asarray(u8_2d, np.uint8)))
        window, overlap = self.tile_window(*u8.shape, window, overlap)
        pipeline = tiles.make_tiled_pipeline(
            self.model if self.mesh is None else self.models, window=window,
            overlap=overlap, device_postprocess=self.device_postprocess,
            on_pass=self._count_pass, mesh=self.mesh)
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

    def to_host(self, *tensors: torch.Tensor) -> Callable[[], object]:
        """Queue the copy of ``tensors`` to the host; returns a function
        that waits for those copies alone (one event) and gives the numpy
        array, or a tuple of arrays for several tensors.  Work enqueued
        after this call keeps running while the host waits."""
        def result(hosts):
            arrays = [h.numpy() for h in hosts]
            return arrays[0] if len(arrays) == 1 else tuple(arrays)

        if tensors[0].device.type != "cuda":
            got = result(tensors)
            return lambda: got
        hosts = []
        for t in tensors:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))

        def wait():
            done.synchronize()
            return result(hosts)
        return wait

    def cleanup_masks(self, masks: np.ndarray) -> np.ndarray:
        """Host mask cleanup (C++, reference postprocess.cpp semantics);
        identity when the cleanup already ran on the device."""
        if self.device_postprocess:
            return np.asarray(masks)
        return native.postprocess_batch(np.asarray(masks))

    # -- confidence-cascade serving -------------------------------------------
    @property
    def cascade_attached(self) -> bool:
        return self._fallback is not None

    def attach_cascade(self, params, cfg: ModelConfig,
                       threshold: float = 1.5, router: str = "margin",
                       co_params=None, co_cfg: Optional[ModelConfig] = None,
                       margin_threshold: float = 1.5) -> None:
        """Register a stronger fallback model for suspect slices
        (:meth:`infer_cascade` re-runs them through it).  The routers, as
        in the JAX engine:

        * ``"margin"``: the student's mean top-1 minus top-2 logit margin
          over its predicted boundary band (``ops/confidence.py``); slices
          below ``threshold`` route.
        * ``"disagree"``: the count of pixels where the student's and the
          co-model's (``co_params``/``co_cfg``) masks differ; slices above
          ``threshold`` pixels route.
        * ``"both"``: the union: disagreement above ``threshold`` or margin
          below ``margin_threshold``.

        The models are placed as this engine's model is, on each of its
        devices (the fallback is an engine over the same devices), and stay
        there for its life."""
        if router not in ROUTERS:
            raise ValueError(f"router must be 'margin', 'disagree' or "
                             f"'both', got {router!r}")
        if router in ("disagree", "both") and co_params is None:
            raise ValueError(f"router={router!r} needs co_params/co_cfg")
        fallback = InferenceEngine(params, cfg, device_postprocess=(
            self.device_postprocess), devices=self.devices)
        co_models = (pmesh.replicate(
            lambda d: model_registry.build(co_params, co_cfg, d),
            self.devices) if co_params is not None else None)
        self._fallback, self._cascade_co_models = fallback, co_models
        self._cascade_co = (co_params, co_cfg)
        self.cascade_router = router
        self.cascade_threshold = float(threshold)
        self.cascade_margin_threshold = float(margin_threshold)

    def _router_pass(self, u8_batch: torch.Tensor):
        """The student and the router statistic on a device u8 batch ->
        (masks, statistic, margin): the student's masks (cleaned when the
        cleanup runs on the device), the router's statistic per slice
        (float32: the boundary margin for "margin", the disagreeing pixels
        for "disagree" and "both"), and for "both" the margin too.

        The margin needs logits, so the margin and both routers run
        ``UNet.forward`` and the argmax (the JAX engine's
        ``_logits_and_mask``): a stem-1 student's last level then runs in
        the conv kernel, not in K6, which returns masks only.  The disagree
        router needs masks only and runs ``UNet.masks`` for both models.
        The disagreement is counted on the masks before the cleanup.  A
        batch that splits over the devices runs as parts (:meth:`_run`)."""
        return self._run(self._router_on, u8_batch)

    def _router_on(self, i: int, u8_batch: torch.Tensor, _x=None):
        """:meth:`_router_pass` on device ``i``'s part."""
        with torch.inference_mode():
            x = preprocess.model_input_from_u8(u8_batch)[..., None]
            self.forwards += 1
            margin = None
            if self.cascade_router == "disagree":
                masks = self.models[i].masks(x)
            else:
                logits = self.models[i](x)
                masks = decode_mask(logits, self.cfg.num_classes)
                margin = confidence.boundary_margin(logits, masks)
                del logits
            stat = margin
            if self.cascade_router != "margin":
                self.forwards += 1
                co_masks = self._cascade_co_models[i].masks(x)
                stat = (masks != co_masks).reshape(masks.shape[0], -1).sum(
                    1).float()
            return (self._post(masks), stat,
                    margin if self.cascade_router == "both" else None)

    def _fallback_pass(self, u8_batch: torch.Tensor) -> torch.Tensor:
        """The fallback engine's pipeline on a device u8 batch: its masks
        (``UNet.masks``: K6 for a stem-1 model K6 is built for), cleaned
        when the cleanup runs on the device."""
        before = self._fallback.forwards
        masks = self._fallback._pipeline(u8_batch)
        self.forwards += self._fallback.forwards - before
        return masks

    def compile_cascade(self, n: int = 1) -> None:
        """Warm up the cascade's passes at init time: the router pass for
        batch ``n`` and the fallback's single-slice bucket, so the first
        request pays no first-call cost (the reference's warm-up,
        src/process.cpp:92-105)."""
        zeros = torch.zeros((n, self.size, self.size), dtype=torch.uint8,
                            device=self.device)
        key = (self.cascade_router, n)
        if key not in self._warm:
            self._router_pass(zeros)
            self._warm.add(key)
        if ("cascade", 1) not in self._warm:
            self._fallback_pass(zeros[:1])
            self._warm.add(("cascade", 1))
        self._synchronize()

    def infer_cascade(self, u8_batch: np.ndarray,
                      n_valid: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
        """The student and its router on a host (N, S, S) uint8 batch, then
        the fallback on the routed slices -> (masks, statistic, n_routed)
        on the host.

        Routing is a host branch, so this call waits: the masks and the
        statistic come back in one event-waited copy.  The routed slices
        are gathered on the device from the batch already there into a
        bucket of the next power of two (at most N), padded with copies of
        the first routed slice, and the fallback's masks are spliced into
        the returned array in place.  ``n_valid`` restricts routing to the
        first rows (a padded tail is never routed).  Requires
        :meth:`attach_cascade`."""
        if not self.cascade_attached:
            raise RuntimeError("attach_cascade first")
        u8 = np.asarray(u8_batch, np.uint8)
        n = u8.shape[0]
        n_valid = n if n_valid is None else min(int(n_valid), n)
        u8_dev = self._put(u8)
        masks_d, stat_d, margin_d = self._router_pass(u8_dev)
        got = self.to_host(*(t for t in (masks_d, stat_d, margin_d)
                             if t is not None))()
        masks, stat = got[0], got[1]
        sv = stat[:n_valid]
        if self.cascade_router == "disagree":
            routed = np.nonzero(sv > self.cascade_threshold)[0]
        elif self.cascade_router == "both":
            routed = np.nonzero(
                (sv > self.cascade_threshold)
                | (got[2][:n_valid] < self.cascade_margin_threshold))[0]
        else:
            routed = np.nonzero(sv < self.cascade_threshold)[0]
        if routed.size:
            bucket = min(1 << (int(routed.size) - 1).bit_length(), n)
            rows = np.concatenate(
                [routed, np.full(bucket - routed.size, routed[0])])
            sub = u8_dev[torch.as_tensor(rows, device=self.device)]
            fallback = self.to_host(self._fallback_pass(sub))()
            masks[routed] = fallback[:routed.size]
        return masks, stat, int(routed.size)


_engine: Optional[InferenceEngine] = None


def get_engine() -> Optional[InferenceEngine]:
    return _engine


def initialize_engine(cache_path: str, log_dir: Optional[str] = None,
                      device: str = "cuda", device_postprocess: bool = False,
                      cascade_ckpt: Optional[str] = None,
                      cascade_threshold: float = 1.5,
                      cascade_router: str = "margin",
                      cascade_co_ckpt: Optional[str] = None,
                      cascade_margin_threshold: float = 1.5) -> bool:
    """Load the checkpoint, open the log and warm up batch 1.

    ``device_postprocess=True`` runs the mask cleanup on the device, inside
    the pipeline (all-device serving for host-poor deployments).
    ``cascade_ckpt`` attaches a stronger fallback model
    (:meth:`InferenceEngine.attach_cascade`): ``cascade_router="margin"``
    routes slices whose boundary margin is below ``cascade_threshold``;
    ``"disagree"`` those whose mask differs from the co-model
    ``cascade_co_ckpt``'s at more than ``cascade_threshold`` pixels;
    ``"both"`` the union, the margin leg below
    ``cascade_margin_threshold``.  The engine is built into a local first,
    so a failed (re-)initialization leaves no engine servable.  Returns
    False, with the error in the log, on any failure, including a
    ``device="cuda"`` request on a host without CUDA.
    """
    global _engine
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
        if cascade_ckpt:
            if not os.path.exists(cascade_ckpt):
                GLOBAL_LOG.write(
                    f"Error: cascade checkpoint not found - {cascade_ckpt}")
                _engine = None
                return False
            fb_params, fb_cfg = checkpoint.load(cascade_ckpt)
            co_params = co_cfg = None
            if cascade_router in ("disagree", "both"):
                if not (cascade_co_ckpt and os.path.exists(cascade_co_ckpt)):
                    GLOBAL_LOG.write(
                        f"Error: {cascade_router} router needs "
                        f"cascade_co_ckpt - {cascade_co_ckpt}")
                    _engine = None
                    return False
                co_params, co_cfg = checkpoint.load(cascade_co_ckpt)
            eng.attach_cascade(fb_params, fb_cfg, cascade_threshold,
                               router=cascade_router, co_params=co_params,
                               co_cfg=co_cfg,
                               margin_threshold=cascade_margin_threshold)
            GLOBAL_LOG.write(
                f"Cascade fallback attached: {cascade_ckpt} "
                f"(router {cascade_router}, threshold {cascade_threshold}"
                + (f", margin_threshold {cascade_margin_threshold}"
                   if cascade_router == "both" else "") + ")")
        t0 = time.perf_counter()
        eng.compile(1)
        if cascade_ckpt:
            # process_single_image serves through the router pass and the
            # fallback's single-slice bucket: warm those too
            eng.compile_cascade(1)
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
                          device_postprocess=device_postprocess,
                          cascade_router=eng.cascade_router)
        return True
    except Exception as e:
        print(f"Initialization error: {e}")
        if GLOBAL_LOG.is_open():
            GLOBAL_LOG.write(f"Initialization error: {e}")
        _engine = None  # never leave a half-initialized engine servable
        return False


def make_partitioned_engines(n_partitions: int,
                             device_postprocess: bool = False,
                             devices: Optional[List] = None
                             ) -> List[InferenceEngine]:
    """Split the devices into N independent engines for concurrent callers
    (the reference's thread_local-context intent, src/process.cpp:14-19):

        engines = engine.make_partitioned_engines(4)
        # thread i:
        engine.process_single_image(path, w, h, out, eng=engines[i])

    ``devices`` defaults to every visible CUDA device; ``min(n, len(devices))``
    engines each own a disjoint run of them by position, the remainder
    spread round-robin (sizes differ by at most 1), so one card gives one
    engine.  A list that repeats a device (``["cpu"] * 4``) is split by
    position too.  Each partition serves the global engine's model and its
    cascade.  Requires a prior :func:`initialize_engine`."""
    base = get_engine()
    if base is None:
        raise RuntimeError("initialize_engine first")
    devs = [torch.device(d) for d in (
        pmesh.visible_devices() if devices is None else devices)]
    n = max(1, min(int(n_partitions), len(devs)))
    per, extra = divmod(len(devs), n)
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + per + (1 if i < extra else 0))
    engines = [InferenceEngine(base.params, base.cfg,
                               device_postprocess=device_postprocess,
                               devices=devs[bounds[i]:bounds[i + 1]])
               for i in range(n)]
    if base.cascade_attached:
        # a partition that dropped the cascade would serve exactly the
        # masks it was attached to avoid
        co_params, co_cfg = base._cascade_co
        for eng in engines:
            eng.attach_cascade(
                base._fallback.params, base._fallback.cfg,
                base.cascade_threshold, router=base.cascade_router,
                co_params=co_params, co_cfg=co_cfg,
                margin_threshold=base.cascade_margin_threshold)
    return engines


def cleanup_resources() -> None:
    """Ordered teardown, parity with src/cleanup.cpp:10-64."""
    global _engine
    if GLOBAL_LOG.is_open():
        GLOBAL_LOG.write("=== Cleaning up resources ===")
    _engine = None
    if GLOBAL_LOG.is_open():
        GLOBAL_LOG.write("Cleanup completed")
    GLOBAL_LOG.close()


def _emit_per_class_json(decoded_mask: np.ndarray, output_dir: str,
                         base_name: str, original_w: int,
                         original_h: int) -> None:
    """``{base}_classes.json``: labelme shapes for every class region
    (label = class id, labelIndex = its position in the sorted class list),
    traced from the decoded mask before the cleanup: class-1 regions exist
    only there, as the cleanup maps the mask to {0, 2}
    (src/postprocess.cpp:75-76).  BASELINE config 2's per-class contours."""
    scaled_h, scaled_w = decoded_mask.shape
    per_class = native.contours_per_class(decoded_mask)
    labeled = []
    for idx, (cls, contours) in enumerate(sorted(per_class.items())):
        labeled += [(cls, idx, c) for c in contours]
    payload = native.contour_json_bytes_labeled(
        labeled, base_name, original_w, original_h,
        original_w / scaled_w, original_h / scaled_h)
    with open(os.path.join(output_dir, base_name + "_classes.json"),
              "wb") as f:
        f.write(payload)


def _refuse_device_cleanup_per_class(eng: InferenceEngine) -> None:
    if eng.device_postprocess:
        # the pipeline returns cleaned {0, 2} masks: class 1 is gone, so
        # per-class shapes would be silently wrong
        raise ValueError("per_class requires the host postprocess path "
                         "(initialize with device_postprocess=False)")


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
    window and is ignored without ``window``.  With a cascade attached the
    plain mode serves through :meth:`InferenceEngine.infer_cascade`.
    ``per_class`` also writes ``{base}_classes.json`` from the decoded mask
    (in any mode); it refuses an engine that cleans on the device.  ``eng``
    overrides the global engine.
    """
    try:
        eng = eng or get_engine()
        if eng is None:
            raise RuntimeError("Engine not initialized")
        if per_class:
            _refuse_device_cleanup_per_class(eng)
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
            mask = eng.to_host(eng.infer_tiled(u8_dev, window, overlap)[None])()
        elif tta:
            mask = eng.to_host(eng.infer_tta(u8)[None])()
        elif eng.cascade_attached:
            mask, _, n_routed = eng.infer_cascade(u8[None])
            if n_routed:
                GLOBAL_LOG.write("Cascade: routed to fallback model")
        else:
            mask = eng.to_host(eng.infer(u8[None]))()
        inference_ms = int((time.perf_counter() - t_inf) * 1000)
        GLOBAL_LOG.write(f"Inference time: {inference_ms} ms")

        if per_class:
            _emit_per_class_json(mask[0], output_dir, base_name, width,
                                 height)
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

    With a cascade attached each batch goes through
    :meth:`InferenceEngine.infer_cascade`, which waits for its batch (the
    routing is a host branch), and its record counts the routed slices
    (``cascade_routed``).  ``per_class=True`` also writes each slice's
    ``{base}_classes.json`` from the decoded mask; a failure there marks
    the slice failed without holding back its other artifacts.  It refuses
    an engine that cleans on the device.
    """
    eng = eng or get_engine()
    if eng is None:
        raise RuntimeError("Engine not initialized")
    if tier not in ARTIFACT_TIERS:
        raise ValueError(f"tier must be one of {ARTIFACT_TIERS}, got {tier!r}")
    if emitter not in EMITTERS:
        raise ValueError(f"emitter must be one of {EMITTERS}, got {emitter!r}")
    if per_class:
        _refuse_device_cleanup_per_class(eng)
    tier_bits = _TIER_BITS[tier]
    n_ok = n_fail = 0
    pending = []  # (wait for host masks, u8 batch, [(path, out_dir)])

    def drain(entry):
        nonlocal n_ok, n_fail
        wait, u8s, metas = entry
        n = len(metas)
        decoded = wait()[:n]
        bases = [os.path.splitext(os.path.basename(p))[0] for p, _ in metas]
        for d in {d for _, d in metas}:
            os.makedirs(d, exist_ok=True)
        slice_ok = np.ones(n, bool)
        if per_class:
            for k, (_, d) in enumerate(metas):
                try:
                    _emit_per_class_json(decoded[k], d, bases[k], width,
                                         height)
                except Exception as e:
                    print(f"Processing error: {e}")
                    slice_ok[k] = False
        masks = eng.cleanup_masks(decoded)
        counts = native.emit_batch(
            u8s[:n], masks, [d for _, d in metas], bases,
            [os.path.basename(p) for p, _ in metas], width, height, tier_bits)
        ok = int(np.sum((counts >= 0) & slice_ok))
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

    from unetseg_tpu_torch.parallel.pipeline import prefetch_map

    chunks = [(raw_paths[i: i + batch_size], output_dirs[i: i + batch_size])
              for i in range(0, len(raw_paths), batch_size)]
    with ThreadPoolExecutor(max_workers=2) as loaders:
        for _, (u8s, good, n_bad) in prefetch_map(loaders, load_chunk,
                                                  chunks, 2):
            n_fail += n_bad
            if u8s is None:
                continue
            t_inf = time.perf_counter()
            record = {}
            if eng.cascade_attached:
                masks, _, record["cascade_routed"] = eng.infer_cascade(
                    u8s, n_valid=len(good))
                wait = (lambda m: lambda: m)(masks)
            else:
                wait = eng.to_host(eng.infer(u8s))
            GLOBAL_LOG.record(
                event="batch", n=len(good), **record,
                dispatch_ms=round((time.perf_counter() - t_inf) * 1e3, 3))
            pending.append((wait, u8s, good))
            if len(pending) > 1:
                drain(pending.pop(0))
        while pending:
            drain(pending.pop(0))
    return n_ok, n_fail
