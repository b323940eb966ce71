"""Model-family registry of the port: ``arch="unet"`` only so far."""

from __future__ import annotations

import torch
from torch import nn

from unetseg_tpu_torch.checkpoint import params_from_jax
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models.unet import UNet

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(params: dict, cfg: ModelConfig, device: str = "cuda") -> nn.Module:
    """The model for ``cfg`` with the JAX param pytree ``params`` loaded,
    cast to the compute dtype and placed on ``device``."""
    if cfg.arch != "unet":
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (ROADMAP.md queue A, P10)")
    if cfg.compute_dtype not in _DTYPES:
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r} is not ported")
    device = torch.device(device)
    if device.type == "cuda" and cfg.compute_dtype == "float32":
        raise NotImplementedError(
            "compute_dtype 'float32' has no conv kernel on CUDA yet "
            "(ROADMAP.md queue A, P13: the float32 conv kernel); serve "
            "bfloat16, or pass device='cpu'")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "explicitly to run on the CPU")
    model = UNet(cfg)
    model.load_state_dict(params_from_jax(params))
    return model.to(device=device, dtype=_DTYPES[cfg.compute_dtype]).eval()
