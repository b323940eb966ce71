"""The plain UNet of the benchmark's configurations, in float32 PyTorch.

Ronneberger et al., U-Net (arXiv:1505.04597) with this repository's
departures, which each configuration file lists: SAME padding, a
space-to-depth stem of ``stem`` (the input's ``stem x stem`` blocks become
channels, ordered (dy, dx, c)), 3 classes and a 1x1 head followed by
depth-to-space.  The weights are the JAX-layout tree the benchmark made or
read itself: 3x3 convs HWIO ``(3, 3, C, D)``, 2x2 up-convs ``(2, 2, C, D)``
applied as ``lax.conv_transpose`` does (the kernel mirrored: output pixel
``(2i + a, 2j + b)`` takes ``w[1 - a, 1 - b]``), the head ``(1, 1, C, K)``.

Every conv is ``F.conv2d`` / ``F.conv_transpose2d`` in float32 with TF32
off.  ``quant="fp8"`` is the control: each conv's input and weights rounded
to float8 e4m3 with one scale per tensor, the products summed in float32.

The family's interface (``perfbench/reference/__init__.py``): ``init``,
``centre``, ``Reference``, ``flops_per_slice``.  ``sites``, ``draw``,
``Weights`` and ``decoder_stage`` are the pieces another family of the
same trunk builds on (``attention_unet.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import counts


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    onto 448, the format's largest finite value), back in float32."""
    amax = t.abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


# ----------------------------------------------------------------- weights

def sites(cfg: dict) -> List[Tuple[str, tuple]]:
    """Every weight of the tree as (dotted path, shape), in the order
    drawn: the encoder, the bottleneck, the decoder, the head."""
    stem, d = cfg["stem"], cfg["depth"]
    chans = [cfg["base_channels"] * 2 ** i for i in range(d)]
    bott = cfg["base_channels"] * 2 ** d
    shapes: List[Tuple[str, tuple]] = []
    cin = cfg.get("in_channels", 1) * stem * stem
    for i, c in enumerate(chans):
        shapes += [(f"encoder.{i}.conv1", (3, 3, cin, c)),
                   (f"encoder.{i}.conv2", (3, 3, c, c))]
        cin = c
    shapes += [("bottleneck.conv1", (3, 3, chans[-1], bott)),
               ("bottleneck.conv2", (3, 3, bott, bott))]
    cin = bott
    for j, c in enumerate(reversed(chans)):
        shapes += [(f"decoder.{j}.up", (2, 2, cin, c)),
                   (f"decoder.{j}.conv1", (3, 3, 2 * c, c)),
                   (f"decoder.{j}.conv2", (3, 3, c, c))]
        cin = c
    shapes.append(("head", (1, 1, chans[0], cfg["num_classes"] * stem * stem)))
    return shapes


def _put(tree: dict, name: str, site: dict) -> None:
    """``site`` at the dotted ``name`` of ``tree``; a numeric part indexes a
    list, filled in order."""
    parts = [int(p) if p.isdigit() else p for p in name.split(".")]
    node = tree
    for i, part in enumerate(parts):
        last = i == len(parts) - 1
        child = site if last else ([] if isinstance(parts[i + 1], int) else {})
        if isinstance(node, list):
            if part == len(node):
                node.append(child)
            node = node[part]
        else:
            node = node.setdefault(part, child)


def draw(shapes: List[Tuple[str, tuple]], gen: torch.Generator,
         device) -> dict:
    """He-normal weights for ``shapes`` and zero biases in the JAX layout,
    drawn in one call on ``device`` and rounded to bfloat16, the type the
    program serves them in."""
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=gen, device=device)
    tree: dict = {}
    pos = 0
    for name, shape in shapes:
        n = math.prod(shape)
        fan_in = shape[0] * shape[1] * shape[2]
        w = (flat[pos: pos + n].reshape(shape) * math.sqrt(2.0 / fan_in))
        pos += n
        _put(tree, name, {"w": w.bfloat16().float().cpu().numpy(),
                          "b": np.zeros(shape[-1], np.float32)})
    return tree


def init(cfg: dict, generator: torch.Generator, device) -> dict:
    return draw(sites(cfg), generator, device)


def centre(tree: dict, bias: np.ndarray) -> None:
    """The head's bias set to ``bias`` (one value a class) at each of the
    head's ``stem ** 2`` outputs of a class, in its (dy, dx, k) order,
    rounded to bfloat16."""
    reps = tree["head"]["w"].shape[-1] // len(bias)
    tree["head"]["b"] = torch.tensor(np.tile(bias, reps)).bfloat16() \
        .float().numpy()


def flops_per_slice(cfg: dict) -> float:
    return counts.model_flops_per_slice(cfg)


# ------------------------------------------------------------------- model

class Weights:
    """The tree's arrays as float32 tensors on ``device``, converted once."""

    def __init__(self, params: dict, device, quant: Optional[str]):
        self.q = _fp8 if quant == "fp8" else (lambda t: t)
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.device = device
        self.encoder = [(self.conv(s["conv1"]), self.conv(s["conv2"]))
                        for s in params["encoder"]]
        bn = params["bottleneck"]
        self.bottleneck = (self.conv(bn["conv1"]), self.conv(bn["conv2"]))
        self.decoder = [(self.up(s["up"]), self.conv(s["conv1"]),
                         self.conv(s["conv2"])) for s in params["decoder"]]
        hw = self.t(params["head"]["w"])[0, 0]  # (C, K)
        self.head = (self.q(hw.t().contiguous()[:, :, None, None]),
                     self.t(params["head"]["b"]))

    def t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def conv(self, site):  # HWIO -> OIHW
        return self.q(self.t(site["w"]).permute(3, 2, 0, 1).contiguous()), \
            self.t(site["b"])

    def up(self, site):  # (2, 2, C, D) mirrored -> (C, D, 2, 2)
        return self.q(self.t(site["w"]).flip(0, 1).permute(2, 3, 0, 1)
                      .contiguous()), self.t(site["b"])


def conv_relu(w, x, q):
    return F.relu(F.conv2d(q(x), w[0], w[1], padding=1))


def double(ws, x, q):
    return conv_relu(ws[1], conv_relu(ws[0], x, q), q)


def decoder_stage(wt: Weights, j: int, x: torch.Tensor, skip: torch.Tensor
                  ) -> torch.Tensor:
    """Decoder level ``j``: the up-conv, ``[skip, up]``, two 3x3 convs."""
    (uw, ub), c1, c2 = wt.decoder[j]
    x = F.conv_transpose2d(wt.q(x), uw, ub, stride=2)
    x = torch.cat([skip, x], dim=1)
    return double((c1, c2), x, wt.q)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/r, W/r, r*r*C), channels ordered (dy, dx, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


def forward(wt: Weights, u8: torch.Tensor, stem: int,
            stage=decoder_stage) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, H, W, K) float32 logits; ``stage`` runs each
    decoder level."""
    q = wt.q
    x = (u8.float() / 255.0)[..., None]
    if stem > 1:
        x = space_to_depth(x, stem)
    x = x.permute(0, 3, 1, 2)
    skips = []
    for ws in wt.encoder:
        x = double(ws, x, q)
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = double(wt.bottleneck, x, q)
    for j in range(len(wt.decoder)):
        x = stage(wt, j, x, skips.pop())
    logits = F.conv2d(q(x), wt.head[0], wt.head[1]).permute(0, 2, 3, 1)
    if stem > 1:
        logits = depth_to_space(logits, stem)
    return logits.contiguous()


class Reference:
    """The reference model of one configuration: ``logits(u8)`` in blocks
    of ``block`` images, so that it fits beside nothing else."""

    weights = Weights
    stage = staticmethod(decoder_stage)

    def __init__(self, params: dict, cfg: dict, device, quant=None,
                 block: int = 4):
        tf32_off()
        self.stem = cfg["stem"]
        self.device = torch.device(device)
        self.block = block
        self.w = self.weights(params, self.device, quant)

    @torch.no_grad()
    def logits(self, u8: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(u8), self.block):
            x = torch.as_tensor(np.ascontiguousarray(u8[i: i + self.block]),
                                device=self.device)
            out.append(forward(self.w, x, self.stem, self.stage)
                       .cpu().numpy())
        return np.concatenate(out)
