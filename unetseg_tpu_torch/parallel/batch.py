"""Sharded batch inference (BASELINE config 2: batches of 512² slices), the
port of ``unetseg_tpu/parallel/batch.py``.

Both functions are a data-parallel :class:`~unetseg_tpu_torch.engine.
InferenceEngine` over the mesh's ``dp`` devices, built at a params tree's
first call and kept for the last tree seen: the engine splits the batch
into contiguous parts (``mesh.split_batch``), runs each on its own replica
of the model, runs the mask cleanup, which is per image, on each part where
it lies, and gathers the parts back on the first device in batch order.  A
batch that does not split runs whole on the first device, as in the engine.
The spatial split (``sp > 1``) is refused (ROADMAP.md queue A, P9c).
"""

from __future__ import annotations

from typing import Callable

import torch

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.parallel import mesh as pmesh


def _engine_per_params(cfg: ModelConfig, mesh: pmesh.Mesh,
                       spatial: bool) -> Callable:
    """params -> the dp engine for that tree (device cleanup on)."""
    from unetseg_tpu_torch.engine import InferenceEngine

    if spatial or mesh.shape["sp"] > 1:
        pmesh.spatial_split()
    devices = pmesh.dp_devices(mesh)
    cache = {}

    def engine(params):
        if cache.get("params") is not params:
            cache["engine"] = InferenceEngine(
                params, cfg, devices=devices, device_postprocess=True)
            cache["params"] = params
        return cache["engine"]
    return engine


def make_sharded_pipeline(cfg: ModelConfig, mesh: pmesh.Mesh,
                          spatial: bool = False) -> Callable:
    """(params, u8 (N, S, S)) -> cleaned {0, 2} masks (N, S, S) on the first
    device.  ``params`` is the JAX-layout tree (``checkpoint.load``)."""
    engine = _engine_per_params(cfg, mesh, spatial)
    return lambda params, u8: engine(params)._pipeline(u8)


def make_sharded_forward(cfg: ModelConfig, mesh: pmesh.Mesh) -> Callable:
    """(params, x (N, H, W, 1) f32) -> logits on the first device, the batch
    split over dp (for TTA and tiling to compose with)."""
    engine = _engine_per_params(cfg, mesh, False)

    def fwd(params, x: torch.Tensor) -> torch.Tensor:
        eng = engine(params)

        def part(i, xp, _):
            eng._count_pass()
            with torch.inference_mode():
                return eng.models[i](xp)
        return eng._run(part, x)
    return fwd
