"""PyTorch state-dict import, the port of ``unetseg_tpu/models/import_torch.py``.

The reference's model travels PyTorch -> ONNX -> TensorRT; here a
``.pt`` state dict of the canonical torch UNet becomes the JAX-layout
parameter tree (float32 numpy) that ``checkpoint.save`` writes and every
engine serves.  OIHW conv weights transpose to HWIO, ConvTranspose2d
(IOHW) weights flip their taps and transpose to HWIO, and a BatchNorm that
follows a conv folds into it (:func:`fold_batchnorm`, inference mode).

Canonical torch module naming (see :func:`build_torch_unet`):

    encoder.{i}.conv1 / conv2      Conv2d 3x3
    bottleneck.conv1 / conv2       Conv2d 3x3
    decoder.{i}.up                 ConvTranspose2d 2x2 stride 2
    decoder.{i}.conv1 / conv2      Conv2d 3x3
    head                           Conv2d 1x1
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from unetseg_tpu_torch.config import ModelConfig


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _conv(sd: Dict, prefix: str) -> dict:
    w = _np(sd[prefix + ".weight"])  # OIHW
    b = _np(sd[prefix + ".bias"])
    return {"w": np.transpose(w, (2, 3, 1, 0)).copy(), "b": b.copy()}


def _conv_transpose(sd: Dict, prefix: str) -> dict:
    w = _np(sd[prefix + ".weight"])  # ConvTranspose2d: (in, out, kh, kw)
    b = _np(sd[prefix + ".bias"])
    # lax.conv_transpose places the kernel rotated by 180 degrees against
    # torch's scatter, so the taps flip before the HWIO transpose.
    w = np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
    return {"w": w, "b": b.copy()}


def fold_batchnorm(conv: dict, gamma, beta, mean, var, eps: float = 1e-5
                   ) -> dict:
    """Fuse ``y = BN(conv(x))`` into one HWIO conv (inference mode)."""
    gamma, beta, mean, var = map(_np, (gamma, beta, mean, var))
    scale = gamma / np.sqrt(var + eps)
    return {"w": conv["w"] * scale[None, None, None, :],
            "b": (conv["b"] - mean) * scale + beta}


def _float32(tree):
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float32(v) for v in tree]
    return np.asarray(tree, np.float32)


def convert_state_dict(state_dict: Dict, cfg: ModelConfig = ModelConfig()
                       ) -> dict:
    """The canonical torch UNet state dict -> the JAX-layout parameter
    tree, every array float32 numpy.  Keys outside the canonical names
    (BatchNorm statistics, say) are not read."""
    sd = dict(state_dict)
    params: dict = {"encoder": [], "decoder": []}
    for i in range(cfg.depth):
        params["encoder"].append({"conv1": _conv(sd, f"encoder.{i}.conv1"),
                                  "conv2": _conv(sd, f"encoder.{i}.conv2")})
    params["bottleneck"] = {"conv1": _conv(sd, "bottleneck.conv1"),
                            "conv2": _conv(sd, "bottleneck.conv2")}
    for i in range(cfg.depth):
        params["decoder"].append({
            "up": _conv_transpose(sd, f"decoder.{i}.up"),
            "conv1": _conv(sd, f"decoder.{i}.conv1"),
            "conv2": _conv(sd, f"decoder.{i}.conv2")})
    params["head"] = _conv(sd, "head")
    return _float32(params)


class _DoubleConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)

    def forward(self, x):
        return torch.relu(self.conv2(torch.relu(self.conv1(x))))


class _Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 2, stride=2)
        self.conv1 = nn.Conv2d(cout * 2, cout, 3, padding=1)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)

    def forward(self, x, skip):
        x = torch.cat([skip, self.up(x)], dim=1)
        return torch.relu(self.conv2(torch.relu(self.conv1(x))))


class TorchUNet(nn.Module):
    """The canonical torch UNet, NCHW (for tests and for users exporting
    a ``.pt``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        chans = [cfg.base_channels * (2 ** i) for i in range(cfg.depth)]
        bott = cfg.base_channels * (2 ** cfg.depth)
        self.encoder = nn.ModuleList()
        cin = cfg.in_channels
        for c in chans:
            self.encoder.append(_DoubleConv(cin, c))
            cin = c
        self.bottleneck = _DoubleConv(chans[-1], bott)
        self.decoder = nn.ModuleList()
        cin = bott
        for c in reversed(chans):
            self.decoder.append(_Up(cin, c))
            cin = c
        self.head = nn.Conv2d(chans[0], cfg.num_classes, 1)
        self.pool = nn.MaxPool2d(2)

    def forward(self, x):
        skips = []
        for enc in self.encoder:
            x = enc(x)
            skips.append(x)
            x = self.pool(x)
        x = self.bottleneck(x)
        for dec, skip in zip(self.decoder, reversed(skips)):
            x = dec(x, skip)
        return self.head(x)


def build_torch_unet(cfg: ModelConfig = ModelConfig()) -> TorchUNet:
    """The canonical torch module for ``cfg`` (PyTorch's default init)."""
    return TorchUNet(cfg)
