"""Model-family registry of the port (``unetseg_tpu/models/registry.py``).

Checkpoints name their family in ``ModelConfig.arch``; every pipeline
builds its model through :func:`build`, so the engine, TTA, windows, the
study runner and the cascade serve any registered family.  The three float
families are registered here: ``unet``, ``attention_unet`` and ``unetpp``;
the quantized ``unet_w8a8`` registers itself from ``quantize.py`` at its
first lookup.  A
family is the module that holds its weights (made from the config and the
parameter tree, whose head count UNet++ keeps) and its ``init``; one
mapping, ``checkpoint.params_from_jax``, names every family's conv sites
by their path in the JAX tree.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch
from torch import nn

from unetseg_tpu_torch.checkpoint import params_from_jax
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import attention_unet, unet, unetpp

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Family(NamedTuple):
    #: (cfg, JAX-layout params) -> the module, weights not yet loaded.
    module: Callable[[ModelConfig, dict], nn.Module]
    #: (cfg, torch.Generator) -> a fresh JAX-layout tree of float32 numpy.
    init: Callable[[ModelConfig, torch.Generator], dict]
    #: A float family, cast to the config's compute dtype when built; the
    #: quantized family keeps its stored int8 and f32 tensors.
    cast: bool = True


_REGISTRY: Dict[str, Family] = {}


def register(name: str, module: Callable, init_fn: Callable,
             cast: bool = True) -> None:
    _REGISTRY[name] = Family(module, init_fn, cast)


register("unet", lambda cfg, params: unet.UNet(cfg), unet.init)
register("attention_unet",
         lambda cfg, params: attention_unet.AttentionUNet(cfg),
         attention_unet.init)
register("unetpp",
         lambda cfg, params: unetpp.UNetPP(cfg, len(params["heads"])),
         unetpp.init)


def get(name: str) -> Family:
    if name == "unet_w8a8" and name not in _REGISTRY:
        # importing the module registers the quantized family
        from unetseg_tpu_torch import quantize

        quantize.register_arch()
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model arch '{name}'; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """A fresh parameter tree for ``cfg.arch``, drawn from ``generator``."""
    return get(cfg.arch).init(cfg, generator)


def build(params: dict, cfg: ModelConfig, device: str = "cuda") -> nn.Module:
    """The model for ``cfg`` with the JAX param pytree ``params`` loaded and
    placed on ``device``: a float family cast to the compute dtype, the
    quantized ``unet_w8a8`` as stored (int8 weights, f32 scales and biases;
    its convs are int8, so the float32 refusal is not its)."""
    family = get(cfg.arch)
    if cfg.compute_dtype not in _DTYPES:
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r} is not ported")
    device = torch.device(device)
    if device.type == "cuda" and cfg.compute_dtype == "float32" and \
            family.cast:
        raise NotImplementedError(
            "compute_dtype 'float32' has no conv kernel on CUDA yet "
            "(ROADMAP.md queue A, P13: the float32 conv kernel); serve "
            "bfloat16, or pass device='cpu'")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "explicitly to run on the CPU")
    model = family.module(cfg, params)
    model.load_state_dict(params_from_jax(params))
    if not family.cast:
        return model.to(device=device).eval()
    return model.to(device=device, dtype=_DTYPES[cfg.compute_dtype]).eval()
