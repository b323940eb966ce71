"""UNet++ (nested UNet), the port of ``unetseg_tpu/models/unetpp.py``.

Zhou et al., arXiv:1807.10165: the plain skips become dense nested decoder
nodes X(i, j) on a backbone of depth + 1 levels,

    X(i, 0) = the backbone (a max-pool chain)
    X(i, j) = conv2(conv1(concat(X(i, 0..j-1), up(X(i+1, j-1)))))

and the head reads X(0, depth); with ``deep_supervision`` every X(0, j >= 1)
has a head and the float32 logits are averaged.  The 3x3 convs run in the
conv kernel (K1/K2, ``ops.conv``): 30 per forward at depth 4, the widest
input 5 * base channels at level 0.  The up-convs and heads stay plain
products, as JAX computes them in ``lax``.  K6 fuses the plain UNet's last
level only, so :meth:`UNetPP.masks` is the argmax of the logits.  As in
JAX, ``init`` refuses ``stem != 1`` and the forward ignores ``stem``.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models.unet import (Conv1x1, Conv3x3, DoubleConv,
                                           UpConv, _conv_init, max_pool_2x2,
                                           param_count)
from unetseg_tpu_torch.ops.decode import decode_mask

__all__ = ["NestedNode", "UNetPP", "init", "param_count", "level_channels"]


def level_channels(cfg: ModelConfig) -> List[int]:
    """Channels of backbone levels 0..depth, e.g. (64, ..., 1024)."""
    return [cfg.base_channels * (2 ** i) for i in range(cfg.depth + 1)]


class NestedNode(nn.Module):
    """X(i, j): ``up`` from level i + 1, ``conv1`` over the j earlier nodes
    of level i and the up-conv's output ((j + 1) * c_i channels), ``conv2``."""

    def __init__(self, c_below: int, c: int, j: int):
        super().__init__()
        self.up = UpConv(c_below, c)
        self.conv1 = Conv3x3((j + 1) * c, c)
        self.conv2 = Conv3x3(c, c)

    def forward(self, earlier: List[torch.Tensor],
                below: torch.Tensor) -> torch.Tensor:
        x = torch.cat([*earlier, self.up(below)], dim=-1)
        return self.conv2(self.conv1(x))


class UNetPP(nn.Module):
    """NHWC input in [0, 1] -> float32 logits (N, H, W, num_classes).

    ``n_heads`` is the head count of the weights it will hold (the
    checkpoint's); the forward refuses one that does not match
    ``cfg.deep_supervision``, as JAX's ``apply`` does."""

    #: K6 takes the plain UNet's last level only (``last_level_route``).
    route = "unfused"

    def __init__(self, cfg: ModelConfig, n_heads: int):
        super().__init__()
        self.cfg = cfg
        chans = level_channels(cfg)
        self.backbone = nn.ModuleList()
        cin = cfg.in_channels
        for c in chans:
            self.backbone.append(DoubleConv(cin, c))
            cin = c
        self.nodes = nn.ModuleDict({
            f"{i}_{j}": NestedNode(chans[i + 1], chans[i], j)
            for j in range(1, cfg.depth + 1)
            for i in range(cfg.depth + 1 - j)})
        self.heads = nn.ModuleList(Conv1x1(chans[0], cfg.num_classes)
                                   for _ in range(n_heads))

    def head_inputs(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The nodes the heads read, in head order: X(0, 1..depth) with
        deep supervision, else X(0, depth)."""
        depth = self.cfg.depth
        want = depth if self.cfg.deep_supervision else 1
        if len(self.heads) != want:
            raise ValueError(
                f"unetpp: checkpoint has {len(self.heads)} head(s) but "
                f"deep_supervision={self.cfg.deep_supervision} expects {want}")
        x = x.to(self.heads[0].weight.dtype)
        grid = {}
        for i, stage in enumerate(self.backbone):
            x = stage(x)
            grid[i, 0] = x
            if i < depth:
                x = max_pool_2x2(x)
        for j in range(1, depth + 1):
            for i in range(depth + 1 - j):
                grid[i, j] = self.nodes[f"{i}_{j}"](
                    [grid[i, k] for k in range(j)], grid[i + 1, j - 1])
        if self.cfg.deep_supervision:
            return [grid[0, j] for j in range(1, depth + 1)]
        return [grid[0, depth]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = [head(f).float()
                  for head, f in zip(self.heads, self.head_inputs(x))]
        if len(logits) == 1:
            return logits[0]
        total = logits[0]
        for l in logits[1:]:  # summed in head order, then divided (jnp.mean)
            total = total + l
        return total / len(logits)

    def masks(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input in [0, 1] -> uint8 (N, H, W) first-max class map."""
        return decode_mask(self(x), self.cfg.num_classes)


def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """A fresh parameter tree in the JAX layout of ``unetpp.init``
    (``backbone`` list, ``nodes`` keyed ``"i_j"``, ``heads`` list);
    He-normal weights from ``generator``, zero biases, float32 numpy."""
    if cfg.stem != 1:
        raise ValueError("ModelConfig.stem is only supported by arch='unet'")
    chans = level_channels(cfg)
    params: dict = {"backbone": [], "nodes": {}, "heads": []}
    cin = cfg.in_channels
    for c in chans:
        params["backbone"].append({
            "conv1": _conv_init(generator, 3, 3, cin, c),
            "conv2": _conv_init(generator, 3, 3, c, c)})
        cin = c
    for j in range(1, cfg.depth + 1):
        for i in range(cfg.depth + 1 - j):
            c = chans[i]
            params["nodes"][f"{i}_{j}"] = {
                "up": _conv_init(generator, 2, 2, chans[i + 1], c),
                "conv1": _conv_init(generator, 3, 3, (j + 1) * c, c),
                "conv2": _conv_init(generator, 3, 3, c, c)}
    for _ in range(cfg.depth if cfg.deep_supervision else 1):
        params["heads"].append(_conv_init(generator, 1, 1, chans[0],
                                          cfg.num_classes))
    return params
