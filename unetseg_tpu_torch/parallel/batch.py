"""Sharded batch inference (BASELINE config 2: batches of 512² slices), the
port of ``unetseg_tpu/parallel/batch.py``.

``make_sharded_forward`` and ``make_sharded_pipeline(spatial=False)`` are a
data-parallel :class:`~unetseg_tpu_torch.engine.InferenceEngine` over the
mesh's ``dp`` devices (JAX's ``P("dp")``: a mesh with ``sp > 1`` is
replicated over sp), built at a params tree's first call and kept for the
last tree seen: the engine splits the batch into contiguous parts
(``mesh.split_batch``), runs each on its own replica of the model, runs the
mask cleanup, which is per image, on each part where it lies, and gathers
the parts back on the first device in batch order.  A batch that does not
split runs whole on the first device, as in the engine.

``make_sharded_pipeline(spatial=True)`` is JAX's ``P("dp", "sp")``: the
batch over dp, each part's rows over its sp row of devices
(``mesh.spatial_split``), the model and the argmax on the row bands with a
halo exchange around every 3x3 conv (``parallel/spatial.py``), the masks'
rows gathered on the part's dp device and cleaned there, the parts gathered
on the first device in batch order.  Every family is served so, the w8a8
UNet included: its 3x3 convs run in K7 on int8 halo slabs.
"""

from __future__ import annotations

from typing import Callable

import torch

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.ops import postprocess, preprocess
from unetseg_tpu_torch.parallel import mesh as pmesh, spatial as pspatial


def _per_params(build: Callable) -> Callable:
    """params -> ``build(params)``, rebuilt when the tree changes."""
    cache = {}

    def get(params):
        if cache.get("params") is not params:
            cache["built"] = build(params)
            cache["params"] = params
        return cache["built"]
    return get


def _dp_engine(cfg: ModelConfig, mesh: pmesh.Mesh) -> Callable:
    """params -> the dp engine for that tree (device cleanup on)."""
    from unetseg_tpu_torch.engine import InferenceEngine

    devices = pmesh.dp_devices(mesh)
    return _per_params(lambda params: InferenceEngine(
        params, cfg, devices=devices, device_postprocess=True))


def _spatial_pipeline(cfg: ModelConfig, mesh: pmesh.Mesh) -> Callable:
    devices = pmesh.dp_devices(mesh)
    models = _per_params(lambda params: pmesh.replicate(
        lambda d: registry.build(params, cfg, d), devices))
    unit = pspatial.row_unit(cfg)

    def pipeline(params, u8: torch.Tensor) -> torch.Tensor:
        replicas = models(params)
        pspatial.check_rows(cfg, *u8.shape)
        out = []
        with torch.inference_mode():
            for i, parts in enumerate(pmesh.spatial_split(u8, mesh, unit)):
                x = preprocess.model_input_from_u8(
                    pspatial.Bands.of(parts))[..., None]
                masks = pspatial.gather(replicas[i].masks(x), devices[i])
                out.append(postprocess.postprocess_masks(masks))
        return pmesh.gather_batch(out, devices[0])
    return pipeline


def make_sharded_pipeline(cfg: ModelConfig, mesh: pmesh.Mesh,
                          spatial: bool = False) -> Callable:
    """(params, u8 (N, S, S)) -> cleaned {0, 2} masks (N, S, S) on the first
    device.  ``params`` is the JAX-layout tree (``checkpoint.load``).
    ``spatial=True`` also splits each image's rows over the mesh's sp axis
    (the batch must then split over dp, as JAX's sharding requires)."""
    if spatial:
        return _spatial_pipeline(cfg, mesh)
    engine = _dp_engine(cfg, mesh)
    return lambda params, u8: engine(params)._pipeline(u8)


def make_sharded_forward(cfg: ModelConfig, mesh: pmesh.Mesh) -> Callable:
    """(params, x (N, H, W, 1) f32) -> logits on the first device, the batch
    split over dp (for TTA and tiling to compose with)."""
    engine = _dp_engine(cfg, mesh)

    def fwd(params, x: torch.Tensor) -> torch.Tensor:
        eng = engine(params)

        def part(i, xp, _):
            eng._count_pass()
            with torch.inference_mode():
                return eng.models[i](xp)
        return eng._run(part, x)
    return fwd
