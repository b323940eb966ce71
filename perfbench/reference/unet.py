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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    onto 448, the format's largest finite value), back in float32."""
    amax = t.abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class _Weights:
    """The tree's arrays as float32 tensors on ``device``, converted once."""

    def __init__(self, params: dict, device, quant: Optional[str]):
        self.q = _fp8 if quant == "fp8" else (lambda t: t)
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def conv(site):  # HWIO -> OIHW
            return self.q(t(site["w"]).permute(3, 2, 0, 1).contiguous()), \
                t(site["b"])

        def up(site):  # (2, 2, C, D) mirrored -> (C, D, 2, 2)
            return self.q(t(site["w"]).flip(0, 1).permute(2, 3, 0, 1)
                          .contiguous()), t(site["b"])

        self.encoder = [(conv(s["conv1"]), conv(s["conv2"]))
                        for s in params["encoder"]]
        bn = params["bottleneck"]
        self.bottleneck = (conv(bn["conv1"]), conv(bn["conv2"]))
        self.decoder = [(up(s["up"]), conv(s["conv1"]), conv(s["conv2"]))
                        for s in params["decoder"]]
        hw = t(params["head"]["w"])[0, 0]  # (C, K)
        self.head = (self.q(hw.t().contiguous()[:, :, None, None]),
                     t(params["head"]["b"]))


def _conv_relu(w, x, q):
    return F.relu(F.conv2d(q(x), w[0], w[1], padding=1))


def _double(ws, x, q):
    return _conv_relu(ws[1], _conv_relu(ws[0], x, q), q)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/r, W/r, r*r*C), channels ordered (dy, dx, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


def forward(wt: _Weights, u8: torch.Tensor, stem: int) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, H, W, K) float32 logits."""
    q = wt.q
    x = (u8.float() / 255.0)[..., None]
    if stem > 1:
        x = space_to_depth(x, stem)
    x = x.permute(0, 3, 1, 2)
    skips = []
    for ws in wt.encoder:
        x = _double(ws, x, q)
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = _double(wt.bottleneck, x, q)
    for (uw, ub), c1, c2 in wt.decoder:
        x = F.conv_transpose2d(q(x), uw, ub, stride=2)
        x = torch.cat([skips.pop(), x], dim=1)
        x = _double((c1, c2), x, q)
    logits = F.conv2d(q(x), wt.head[0], wt.head[1]).permute(0, 2, 3, 1)
    if stem > 1:
        logits = depth_to_space(logits, stem)
    return logits.contiguous()


class Reference:
    """The reference model of one configuration: ``logits(u8)`` in blocks
    of ``block`` images, so that it fits beside nothing else."""

    def __init__(self, params: dict, stem: int, device, quant=None,
                 block: int = 4):
        tf32_off()
        self.stem = stem
        self.device = torch.device(device)
        self.block = block
        self.w = _Weights(params, self.device, quant)

    @torch.no_grad()
    def logits(self, u8: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(u8), self.block):
            x = torch.as_tensor(np.ascontiguousarray(u8[i: i + self.block]),
                                device=self.device)
            out.append(forward(self.w, x, self.stem).cpu().numpy())
        return np.concatenate(out)


def first_max(logits: np.ndarray) -> np.ndarray:
    """The class of each pixel: the first of equal maxima, as the
    reference's running CMP_GT decode keeps it."""
    return np.argmax(logits, axis=-1).astype(np.uint8)


def widest_gap(logits: np.ndarray, classes: np.ndarray) -> float:
    """How far below the reference's best logit the chosen class lies, at
    the worst pixel of one image, over that image's logit scale (the root
    mean square of the logits about their per-pixel mean)."""
    lg = np.asarray(logits, np.float64)
    chosen = np.take_along_axis(lg, classes[..., None].astype(np.int64),
                                axis=-1)[..., 0]
    gap = lg.max(axis=-1) - chosen
    centred = lg - lg.mean(axis=-1, keepdims=True)
    scale = float(np.sqrt(np.mean(centred * centred)))
    return float(gap.max() / max(scale, 1e-30))
