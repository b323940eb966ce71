"""Attention U-Net, the port of ``unetseg_tpu/models/attention_unet.py``.

The plain UNet (:class:`models.unet.UNet`) with an additive attention gate
on each skip before the decoder concat (Oktay et al., arXiv:1804.03999),
computed at skip resolution after the stage's up-conv, as JAX does:

    g     = up(x)
    a     = sigmoid(psi(relu(W_x skip + W_g g)))      # (N, H, W, 1)
    x     = conv2(conv1([skip * a, g]))

The 3x3 convs run in the conv kernel (K1/K2, ``ops.conv``); the up-conv
and the three 1x1 gate products stay plain products, as JAX computes them
in ``lax`` outside any Pallas kernel.  Every product and bias add rounds to
the compute dtype where JAX's ``_conv`` does, and the sigmoid rounds after
each of its steps, as JAX's ``1 / (1 + exp(-x))`` does in bf16.  K6 fuses
the plain UNet's last level only, so :meth:`UNet.masks` takes the unfused
route here (``models.unet.last_level_route``).  ``stem > 1`` works as in
the plain UNet: space-to-depth in, a depth-to-space head out.
"""

from __future__ import annotations

import torch
from torch import nn

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models.unet import (Conv1x1, Conv3x3, UNet, UpConv,
                                           _conv_init, param_count,
                                           stage_channels)

__all__ = ["AttentionStage", "AttentionUNet", "init", "param_count"]


class AttentionStage(nn.Module):
    """One gated decoder stage: ``up``, the gate ``att_x``, ``att_g``,
    ``att_psi`` (F_int = cout // 2 channels between them), ``conv1`` over
    ``[skip * a, up]`` and ``conv2``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        f_int = max(cout // 2, 1)
        self.up = UpConv(cin, cout)
        self.att_x = Conv1x1(cout, f_int)
        self.att_g = Conv1x1(cout, f_int)
        self.att_psi = Conv1x1(f_int, 1)
        self.conv1 = Conv3x3(2 * cout, cout)
        self.conv2 = Conv3x3(cout, cout)

    def gate(self, skip: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """``skip * a``, the skip modulated by the gate on ``g``."""
        a = torch.relu(self.att_x(skip) + self.att_g(g))
        # sigmoid as JAX computes it: 1 / (1 + exp(-x)), each step rounded
        # to the compute dtype (torch.sigmoid rounds once)
        a = 1 / (1 + torch.exp(-self.att_psi(a)))
        return skip * a

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        g = self.up(x)
        x = torch.cat([self.gate(skip, g), g], dim=-1)
        return self.conv2(self.conv1(x))


class AttentionUNet(UNet):
    """NHWC input in [0, 1] -> float32 logits (N, H, W, num_classes)."""

    decoder_stage = AttentionStage


def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """A fresh parameter tree in the JAX layout of
    ``attention_unet.init``: the plain UNet's sites plus ``att_x``,
    ``att_g`` (1, 1, cout, F_int) and ``att_psi`` (1, 1, F_int, 1) in each
    decoder stage; He-normal weights from ``generator``, zero biases,
    float32 numpy arrays."""
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
        f_int = max(cout // 2, 1)
        params["decoder"].append({
            "up": _conv_init(generator, 2, 2, cin, cout),
            "att_x": _conv_init(generator, 1, 1, cout, f_int),
            "att_g": _conv_init(generator, 1, 1, cout, f_int),
            "att_psi": _conv_init(generator, 1, 1, f_int, 1),
            "conv1": _conv_init(generator, 3, 3, cout * 2, cout),
            "conv2": _conv_init(generator, 3, 3, cout, cout)})
        cin = cout
    params["head"] = _conv_init(generator, 1, 1, chans[0],
                                cfg.num_classes * cfg.stem * cfg.stem)
    return params
