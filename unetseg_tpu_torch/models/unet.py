"""UNet forward pass, the port of ``unetseg_tpu/models/unet.py::apply``.

NHWC end to end, as in the JAX package, so space-to-depth and depth-to-space
are the same reshapes and the conv kernel reads channels-last.  The ten (for
depth 2) 3x3 conv+ReLU stages go through ``ops.conv.conv3x3_bias_act``; the
2x2 stride-2 up-conv and the 1x1 head stay matmuls, as JAX leaves them to
``lax`` outside any Pallas kernel.  :meth:`UNet.masks`, the class map the
engine serves, runs a stem-1 model's last decoder level, head and argmax in
one kernel instead (``ops.dec1.dec1_fused_masks``, K6) when K6 is built for
its width and classes; the route is fixed from the config when the model is
built (:attr:`UNet.route`), the same on the CPU and on the card.
The other float families reuse these modules: ``models/attention_unet.py``
subclasses :class:`UNet` with a gated decoder stage, ``models/unetpp.py``
nests :class:`DoubleConv`, :class:`UpConv` and :class:`Conv1x1` nodes.

The engine's modules hold their weights in the compute dtype, cast once
when ``registry.build`` moves them (``module.to(dtype=...)``); JAX casts
them per call, and both round each stored value once.  A module built for
training (``registry.trainable``) holds float32 parameters and each op casts
them to the compute dtype per call, as ``unet.apply`` does, so their
gradients flow back through the cast; its 3x3 convs then run under
autograd (``ops.conv.conv3x3_bias_act_train``), and with ``cfg.remat`` each
encoder and decoder stage is recomputed in the backward pass
(``torch.utils.checkpoint``), as JAX wraps them in ``jax.checkpoint``.
Bias adds of the up-conv and the head run in the compute dtype, and logits
become float32 only at the end (unet.py:53-62, 224-227).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.ops.conv import conv3x3_bias_act_train
from unetseg_tpu_torch.ops.dec1 import dec1_fused_masks, kernel_takes, up_conv
from unetseg_tpu_torch.ops.decode import decode_mask


#: ``ModelConfig.compute_dtype`` -> torch dtype (the ported ones).
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r} is not ported")
    return COMPUTE_DTYPES[cfg.compute_dtype]


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward pass when ``cfg.remat`` and
    gradients are being recorded (JAX's ``jax.checkpoint`` of a stage)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def stage_channels(cfg: ModelConfig) -> Sequence[int]:
    """Encoder channel widths, e.g. (64, 128, 256, 512) for depth 4."""
    return tuple(cfg.base_channels * (2 ** i) for i in range(cfg.depth))


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/r, W/r, r*r*C), channels ordered (dy, dx, c)
    as in JAX (not ``pixel_unshuffle``'s (c, dy, dx))."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H, W, r*r*C) -> (N, H*r, W*r, C), inverse of space_to_depth."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class Conv3x3(nn.Module):
    """3x3 SAME conv + bias + ReLU; weight HWIO (3, 3, C, D)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, cin, cout),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3_bias_act_train(x, self.weight.to(x.dtype),
                                      self.bias.to(x.dtype), relu=True)


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv3x3(cin, cout)
        self.conv2 = Conv3x3(cout, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class UpConv(nn.Module):
    """2x2 stride-2 transposed conv as one matmul + reshape; weight
    (C, 2*2*O) laid out (c, a, b, o) by checkpoint.params_from_jax."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, 4 * cout),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return up_conv(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv1x1(nn.Module):
    """1x1 conv as a product: (..., C) @ (C, O) + (O,), in the inputs'
    dtype, rounded after the product and again after the bias add, as
    ``lax.conv`` followed by the bias add in JAX (unet.py:53-62)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.to(x.dtype) + self.bias.to(x.dtype)


class DecoderStage(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = UpConv(cin, cout)
        self.conv1 = Conv3x3(2 * cout, cout)
        self.conv2 = Conv3x3(cout, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.cat([skip, self.up(x)], dim=-1)  # [skip, up] (unet.py:205)
        return self.conv2(self.conv1(x))


def last_level_route(cfg: ModelConfig) -> str:
    """How :meth:`UNet.masks` runs the last decoder level, head and argmax:
    "fused" in K6, for plain (``arch="unet"``) bf16 stem-1 models whose
    width and class count K6 is built for (``ops.dec1.kernel_takes``); else
    "unfused": the level's convs in the conv kernel, the head a plain
    product, then the argmax.  K6 computes the plain UNet's level only, in
    bf16 only, so the other families and float32 models always take the
    unfused route."""
    if cfg.arch == "unet" and cfg.stem == 1 and \
            cfg.compute_dtype == "bfloat16" and \
            kernel_takes(cfg.base_channels, cfg.num_classes):
        return "fused"
    return "unfused"


class UNet(nn.Module):
    """NHWC input in [0, 1] -> float32 logits (N, H, W, num_classes)."""

    #: The decoder's stage: called as ``stage(x, skip)``.
    decoder_stage = DecoderStage

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        chans = stage_channels(cfg)
        bottleneck = cfg.base_channels * (2 ** cfg.depth)
        cin = cfg.in_channels * cfg.stem * cfg.stem
        self.encoder = nn.ModuleList()
        for cout in chans:
            self.encoder.append(DoubleConv(cin, cout))
            cin = cout
        self.bottleneck = DoubleConv(chans[-1], bottleneck)
        self.decoder = nn.ModuleList()
        cin = bottleneck
        for cout in reversed(chans):
            self.decoder.append(self.decoder_stage(cin, cout))
            cin = cout
        self.route = last_level_route(cfg)
        n_out = cfg.num_classes * cfg.stem * cfg.stem
        self.head_weight = nn.Parameter(torch.zeros(chans[0], n_out),
                                        requires_grad=False)
        self.head_bias = nn.Parameter(torch.zeros(n_out), requires_grad=False)

    def _trunk(self, x: torch.Tensor):
        """Everything before the last decoder level: (its input, its
        skip)."""
        x = x.to(compute_dtype(self.cfg))
        if self.cfg.stem > 1:
            x = space_to_depth(x, self.cfg.stem)
        skips = []
        for stage in self.encoder:
            x = remat(self.cfg, stage, x)
            skips.append(x)
            x = max_pool_2x2(x)
        x = self.bottleneck(x)  # not rematerialized, as in JAX
        for stage, skip in zip(self.decoder[:-1], reversed(skips[1:])):
            x = remat(self.cfg, stage, x, skip)
        return x, skips[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = remat(self.cfg, self.decoder[-1], *self._trunk(x))
        logits = x @ self.head_weight.to(x.dtype) + self.head_bias.to(x.dtype)
        if self.cfg.stem > 1:
            logits = depth_to_space(logits, self.cfg.stem)
        return logits.float()

    def masks(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input in [0, 1] -> uint8 (N, H, W) first-max class map.

        On the "fused" route (a stem-1 model K6 is built for) the last
        decoder level, head and argmax run in K6 (``ops.dec1``); otherwise
        (a stem-s model, s > 1, whose head is followed by depth-to-space, or
        a width or class count K6 does not take) the logits are argmaxed.
        """
        if self.route == "unfused":
            return decode_mask(self(x), self.cfg.num_classes)
        x, skip = self._trunk(x)
        last = self.decoder[-1]
        return dec1_fused_masks(
            x, skip, last.up.weight, last.up.bias, last.conv1.weight,
            last.conv1.bias, last.conv2.weight, last.conv2.bias,
            self.head_weight, self.head_bias)


def _he_normal(gen: torch.Generator, shape, fan_in: int) -> np.ndarray:
    std = math.sqrt(2.0 / fan_in)
    return (torch.randn(shape, generator=gen) * std).numpy()


def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int
               ) -> dict:
    return {"w": _he_normal(gen, (kh, kw, cin, cout), kh * kw * cin),
            "b": np.zeros((cout,), np.float32)}


def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """A fresh UNet parameter tree, the counterpart of
    ``unetseg_tpu/models/unet.py::init``: the JAX tree layout (HWIO convs,
    (2, 2, Ci, O) up-convs, (1, 1, C, K) head), He-normal weights and zero
    biases, as float32 numpy arrays.  The numbers come from ``generator``,
    so they differ from ``jax.random``'s for the same seed."""
    chans = stage_channels(cfg)
    bottleneck = cfg.base_channels * (2 ** cfg.depth)
    params: dict = {"encoder": [], "decoder": []}
    cin = cfg.in_channels * cfg.stem * cfg.stem
    for cout in chans:
        params["encoder"].append({
            "conv1": _conv_init(generator, 3, 3, cin, cout),
            "conv2": _conv_init(generator, 3, 3, cout, cout)})
        cin = cout
    params["bottleneck"] = {
        "conv1": _conv_init(generator, 3, 3, chans[-1], bottleneck),
        "conv2": _conv_init(generator, 3, 3, bottleneck, bottleneck)}
    cin = bottleneck
    for cout in reversed(chans):
        params["decoder"].append({
            "up": _conv_init(generator, 2, 2, cin, cout),
            "conv1": _conv_init(generator, 3, 3, cout * 2, cout),
            "conv2": _conv_init(generator, 3, 3, cout, cout)})
        cin = cout
    params["head"] = _conv_init(generator, 1, 1, chans[0],
                                cfg.num_classes * cfg.stem * cfg.stem)
    return params


def param_count(params) -> int:
    """Number of weights in a parameter tree of any family."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return int(np.asarray(params).size)
