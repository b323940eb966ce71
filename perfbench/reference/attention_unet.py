"""Attention U-Net, in float32 PyTorch, as the program's ``attention_unet``
family computes it.

Oktay et al., Attention U-Net (arXiv:1804.03999): the plain UNet of
``unet.py`` (its stem, encoder, bottleneck, up-convs, head and helpers)
with an additive attention gate on each skip before the decoder's concat.
At decoder level ``j``, with ``c`` channels at the skip:

    g = up(x)                                   # the level's 2x2 up-conv
    a = sigmoid(psi(relu(W_x skip + W_g g)))    # (N, 1, H, W)
    x = conv2(conv1([skip * a, g]))

Departures from the paper, each the program's:

* the gating signal is the level's up-conv output, at the skip's
  resolution, not the coarser level's features: ``W_x`` has no stride and
  the coefficients need no resampling;
* ``F_int = max(c // 2, 1)`` channels between ``W_x``/``W_g`` and ``psi``;
* biases and no batch normalisation, in the gate and in every conv;
* the unet module's: SAME padding, the stem, 3 classes, a 1x1 head.

The gate's three 1x1 products are ``F.conv2d`` in float32 with TF32 off,
and under ``quant="fp8"`` (the control) each takes its input and weights
in float8 e4m3, as every other conv does.  The tree is the program's
checkpoint layout: each decoder level holds ``up``, ``att_x``, ``att_g``
(1, 1, c, F_int), ``att_psi`` (1, 1, F_int, 1), ``conv1``, ``conv2``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from perfbench import counts
from perfbench.reference import unet


def sites(cfg: dict) -> List[Tuple[str, tuple]]:
    """The plain UNet's weights, each up-conv followed by its level's
    gate."""
    out: List[Tuple[str, tuple]] = []
    for name, shape in unet.sites(cfg):
        out.append((name, shape))
        if name.endswith(".up"):
            level, c = name[: -len(".up")], shape[-1]
            f = max(c // 2, 1)
            out += [(level + ".att_x", (1, 1, c, f)),
                    (level + ".att_g", (1, 1, c, f)),
                    (level + ".att_psi", (1, 1, f, 1))]
    return out


#: the plain UNet's 1x1 head, and its bias in the same place
centre = unet.centre


def init(cfg: dict, generator: torch.Generator, device) -> dict:
    return unet.draw(sites(cfg), generator, device)


def flops_per_slice(cfg: dict) -> float:
    """The plain UNet's, plus each gate's three 1x1 products at its
    level's resolution (the sigmoid and the skip's product are
    elementwise, and counted no more than the ReLUs are)."""
    side = cfg["image_size"] // cfg["stem"]
    total = counts.model_flops_per_slice(cfg)
    for i in range(cfg["depth"]):
        c = cfg["base_channels"] * 2 ** i
        f = max(c // 2, 1)
        px = (side >> i) ** 2
        total += 2.0 * px * (2 * c * f + f)
    return total


class Weights(unet.Weights):
    def __init__(self, params: dict, device, quant):
        super().__init__(params, device, quant)
        self.gates = [(self.conv(s["att_x"]), self.conv(s["att_g"]),
                       self.conv(s["att_psi"])) for s in params["decoder"]]


def gated_stage(wt: Weights, j: int, x: torch.Tensor, skip: torch.Tensor
                ) -> torch.Tensor:
    (uw, ub), c1, c2 = wt.decoder[j]
    (wx, bx), (wg, bg), (wp, bp) = wt.gates[j]
    q = wt.q
    g = F.conv_transpose2d(q(x), uw, ub, stride=2)
    a = F.relu(F.conv2d(q(skip), wx, bx) + F.conv2d(q(g), wg, bg))
    a = torch.sigmoid(F.conv2d(q(a), wp, bp))
    x = torch.cat([skip * a, g], dim=1)
    return unet.double((c1, c2), x, q)


class Reference(unet.Reference):
    weights = Weights
    stage = staticmethod(gated_stage)
