"""The 8-fold dihedral test-time-augmentation ensemble (BASELINE config 5;
the port of ``unetseg_tpu.parallel.tta``).

The 8 dihedral transforms (4 rotations, each with and without a horizontal
flip) of a slice go through the model, the logits are transformed back and
averaged, and the mean is decoded.  Two forms, with equal masks but at near
ties:

* activation space (:func:`make_tta_pipeline`, :func:`make_tta_batch_pipeline`):
  the 8 views as one batch through one model, or with ``mesh=`` split over
  the mesh's dp devices, a replica of the model on each (the engine serves
  this form for ``unet_w8a8`` over its devices when their count divides 8);
* weight space (:func:`make_tta_weightspace_pipeline`): conv, pool, concat,
  space-to-depth and depth-to-space are dihedral-equivariant, so 8 models
  whose kernels carry the inverse transform (:func:`transform_params_dihedral`)
  run on the same, untransposed input.  The engine serves this form for the
  float families, over its devices when it has several
  (:func:`make_tta_weightspace_mesh_pipeline`), and the activation-space
  form for the quantized ``unet_w8a8``, whose scales are not
  transform-aware.

Both run ``UNet.forward`` (logits): the fused last level (K6) returns masks,
so it cannot serve an ensemble of logits.
"""

from __future__ import annotations

import functools
from typing import Callable, List

import numpy as np
import torch
from torch import nn

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.ops import postprocess
from unetseg_tpu_torch.ops.decode import decode_mask
from unetseg_tpu_torch.parallel import mesh as pmesh
from unetseg_tpu_torch.parallel.tiles import Models, dp_logits

N_TRANSFORMS = 8


def dihedral(img: torch.Tensor, k: int) -> torch.Tensor:
    """k in [0, 8): rot90 by k % 4, then a horizontal flip if k >= 4, on the
    leading two (H, W) axes."""
    out = torch.rot90(img, k % 4, dims=(0, 1))
    if k >= 4:
        out = torch.flip(out, dims=(1,))
    return out


def dihedral_inverse(img: torch.Tensor, k: int) -> torch.Tensor:
    if k >= 4:
        img = torch.flip(img, dims=(1,))
    return torch.rot90(img, -(k % 4), dims=(0, 1))


def _kernel_dihedral_inv(w: np.ndarray, k: int) -> np.ndarray:
    """Inverse dihedral on an HWIO kernel's spatial dims: the conv
    equivariance partner of :func:`dihedral` on NHWC activations."""
    if k >= 4:
        w = np.flip(w, axis=1)
    return np.rot90(w, -(k % 4), axes=(0, 1))


def _np_dihedral(a: np.ndarray, k: int) -> np.ndarray:
    out = np.rot90(a, k % 4, axes=(0, 1))
    if k >= 4:
        out = np.flip(out, axis=1)
    return out


def _np_dihedral_inv(a: np.ndarray, k: int) -> np.ndarray:
    if k >= 4:
        a = np.flip(a, axis=1)
    return np.rot90(a, -(k % 4), axes=(0, 1))


def _np_s2d(x: np.ndarray, r: int) -> np.ndarray:
    h, w, c = x.shape
    x = x.reshape(h // r, r, w // r, r, c)
    return x.transpose(0, 2, 1, 3, 4).reshape(h // r, w // r, r * r * c)


def _np_d2s(x: np.ndarray, r: int) -> np.ndarray:
    h, w, c = x.shape
    x = x.reshape(h, w, r, r, c // (r * r))
    return x.transpose(0, 2, 1, 3, 4).reshape(h * r, w * r, c // (r * r))


@functools.lru_cache(maxsize=None)
def _s2d_perm(r: int, k: int):
    """perm with s2d(dihedral(x, k))[..., i] == dihedral(s2d(x, r), k)[..., perm[i]]."""
    h = 4 * r
    x = np.arange(h * h, dtype=np.float32).reshape(h, h, 1)
    a = _np_s2d(_np_dihedral(x, k), r)
    b = _np_dihedral(_np_s2d(x, r), k)
    perm = []
    for i in range(r * r):
        js = [j for j in range(r * r) if np.array_equal(a[..., i], b[..., j])]
        if len(js) != 1:
            raise AssertionError(f"s2d perm r={r} k={k}: slot {i} -> {js}")
        perm.append(js[0])
    return tuple(perm)


@functools.lru_cache(maxsize=None)
def _d2s_perm(r: int, c: int, k: int):
    """perm with dihedral_inverse(d2s(dihedral-frame y)) == d2s(y[..., perm])."""
    rng = np.random.default_rng(12345)
    y = rng.standard_normal((4, 4, c * r * r)).astype(np.float32)
    perm = []
    for i in range(c * r * r):
        yi = np.zeros_like(y)
        yi[..., i] = y[..., i]
        ai = _np_dihedral_inv(_np_d2s(_np_dihedral(yi, k), r), k)
        js = []
        for j in range(c * r * r):
            yj = np.zeros_like(y)
            yj[..., j] = y[..., i]
            if np.allclose(_np_d2s(yj, r), ai):
                js.append(j)
        if len(js) != 1:
            raise AssertionError(f"d2s perm r={r} c={c} k={k}: {i} -> {js}")
        perm.append(js[0])
    return tuple(perm)


def transform_params_dihedral(params: dict, cfg: ModelConfig, k: int) -> dict:
    """θ_k with ``apply(θ_k, x) == dihedral_inverse(apply(θ, dihedral(x)))``.

    ``params`` is the JAX-layout tree of numpy arrays (``checkpoint.load``):
    every dict holding a rank-4 ``w`` is a conv site (3x3 convs, the 2x2
    up-convs, the 1x1 head) whose spatial dims get the inverse dihedral.
    It must be transformed before ``checkpoint.params_from_jax`` packs the
    up-conv into a matmul weight.  A stem > 1 model also permutes the first
    conv's input channels (space-to-depth slots move under rotation) and
    the head's output channels (the inverse of depth-to-space's).  The
    arrays may be strided views; ``registry.build`` copies them."""
    def walk(node):
        if isinstance(node, dict):
            if "w" in node and getattr(node["w"], "ndim", 0) == 4:
                return {**node, "w": _kernel_dihedral_inv(node["w"], k)}
            return {name: walk(v) for name, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    out = walk(params)
    if cfg.stem > 1:
        # Gather with the inverse perms: the first conv reads the channel
        # that lands in each s2d slot under rotation, and the head emits
        # into the slot d2s reads for each subpixel.
        perm_in = np.argsort(_s2d_perm(cfg.stem, k))
        conv1 = out["encoder"][0]["conv1"]
        out["encoder"][0]["conv1"] = {**conv1, "w": conv1["w"][:, :, perm_in, :]}
        perm_out = np.argsort(_d2s_perm(cfg.stem, cfg.num_classes, k))
        out["head"] = {"w": out["head"]["w"][..., perm_out],
                       "b": np.asarray(out["head"]["b"])[perm_out]}
    return out


def weight_variants(params: dict, cfg: ModelConfig, device) -> List[nn.Module]:
    """The 8 models of the weight-space ensemble, built once: model k holds
    ``transform_params_dihedral(params, cfg, k)``."""
    return [registry.build(transform_params_dihedral(params, cfg, k), cfg,
                           device) for k in range(N_TRANSFORMS)]


def _finish(logits: torch.Tensor, num_classes: int,
            device_postprocess: bool) -> torch.Tensor:
    mask = decode_mask(logits, num_classes)
    if device_postprocess:
        mask = postprocess.postprocess_masks(mask.contiguous())
    return mask


def make_tta_weightspace_pipeline(params: dict, cfg: ModelConfig, device,
                                  device_postprocess: bool = False
                                  ) -> Callable:
    """(N, H, W) uint8 on ``device`` -> (N, H, W) masks: the ensemble as 8
    passes of the same input through :func:`weight_variants`, which are
    built here, once.  The logits are summed in k order, then divided by 8,
    as in JAX."""
    variants = weight_variants(params, cfg, device)

    @torch.inference_mode()
    def pipeline(u8b: torch.Tensor) -> torch.Tensor:
        x = (u8b.to(torch.float32) / 255.0)[..., None]
        acc = None
        for model in variants:
            logits = model(x)
            acc = logits if acc is None else acc + logits
        return _finish(acc / N_TRANSFORMS, cfg.num_classes,
                       device_postprocess)

    return pipeline


def make_tta_weightspace_mesh_pipeline(params: dict, cfg: ModelConfig,
                                       mesh, device_postprocess: bool = False
                                       ) -> Callable:
    """The weight-space ensemble over a mesh's dp devices (BASELINE config
    5, "across a slice"): (N, H, W) uint8 on the first device -> (N, H, W)
    masks there.  Needs ``N_TRANSFORMS % dp == 0``; variant k is built on
    dp device ``k // (8 / dp)``, here, once, and each device runs its
    variants on the same untransposed input.  The logits are added on the
    first device in variant order, so the masks are bit-equal to
    :func:`make_tta_weightspace_pipeline`'s (JAX sums per device, then
    across: another order of the f32 sum)."""
    devices = pmesh.dp_devices(mesh)
    if N_TRANSFORMS % len(devices):
        raise ValueError(f"{N_TRANSFORMS} weight variants do not split "
                         f"over dp={len(devices)}")
    local = N_TRANSFORMS // len(devices)
    variants = [registry.build(transform_params_dihedral(params, cfg, k),
                               cfg, devices[k // local])
                for k in range(N_TRANSFORMS)]
    first = devices[0]

    @torch.inference_mode()
    def pipeline(u8b: torch.Tensor) -> torch.Tensor:
        x = (u8b.to(torch.float32) / 255.0)[..., None]
        inputs = {d: x.to(d, non_blocking=True) for d in set(devices)}
        logits = [model(inputs[devices[k // local]])
                  for k, model in enumerate(variants)]
        acc = None
        for lg in logits:
            lg = lg.to(first, non_blocking=True)
            acc = lg if acc is None else acc + lg
        return _finish(acc / N_TRANSFORMS, cfg.num_classes,
                       device_postprocess)

    return pipeline


def make_tta_pipeline(model: Models, device_postprocess: bool = True,
                      mesh=None) -> Callable:
    """(H, W) uint8 -> (H, W) mask: the 8 views of one slice as one batch
    through ``model``, transformed back and averaged.  ``mesh`` (JAX's
    keyword; needs ``N_TRANSFORMS % dp == 0``): the views split over its dp
    devices in contiguous parts, ``model`` one replica a dp device
    (``tiles.dp_logits``); the logits are gathered on the slice's device in
    view order before the inverse transforms and the mean, so the masks are
    the one-device form's."""
    if mesh is not None and N_TRANSFORMS % mesh.shape["dp"]:
        raise ValueError(f"{N_TRANSFORMS} views do not split over "
                         f"dp={mesh.shape['dp']}")
    logits_of, cfg = dp_logits(model, mesh, pmesh.split_batch)

    @torch.inference_mode()
    def pipeline(u8: torch.Tensor) -> torch.Tensor:
        x = u8.to(torch.float32) / 255.0
        batch = torch.stack([dihedral(x, k)
                             for k in range(N_TRANSFORMS)])[..., None]
        logits = logits_of(batch)
        undone = torch.stack([dihedral_inverse(logits[k], k)
                              for k in range(N_TRANSFORMS)])
        return _finish(undone.mean(dim=0)[None], cfg.num_classes,
                       device_postprocess)[0]

    return pipeline


def make_tta_batch_pipeline(model: Models, device_postprocess: bool = False,
                            mesh=None) -> Callable:
    """(N, H, W) uint8 -> (N, H, W) masks: the N * 8 views of a batch
    through ``model`` (in chunks of ``tiles.MODEL_CHUNK``), each slice's 8
    transformed back and averaged.  ``mesh``: the N * 8 rows split over its
    dp devices in contiguous parts (a dp that does not divide them raises),
    ``model`` one replica a dp device (``tiles.dp_logits``)."""
    logits_of, cfg = dp_logits(model, mesh, pmesh.split_batch)

    @torch.inference_mode()
    def pipeline(u8b: torch.Tensor) -> torch.Tensor:
        x = (u8b.to(torch.float32) / 255.0).permute(1, 2, 0)   # (H, W, N)
        views = torch.stack([dihedral(x, k).permute(2, 0, 1)
                             for k in range(N_TRANSFORMS)], dim=1)
        n, t, h, w = views.shape
        logits = logits_of(views.reshape(n * t, h, w)[..., None])
        logits = logits.reshape(n, t, h, w, -1)
        undone = torch.stack([
            dihedral_inverse(logits[:, k].permute(1, 2, 0, 3), k)
            .permute(2, 0, 1, 3) for k in range(N_TRANSFORMS)], dim=1)
        return _finish(undone.mean(dim=1), cfg.num_classes,
                       device_postprocess)

    return pipeline
