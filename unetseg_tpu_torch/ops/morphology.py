"""Binary morphology as max pooling (``unetseg_tpu.ops.morphology``).

OpenCV's ``morphologyEx(MORPH_OPEN)`` with a 3x3 rect kernel
(``src/postprocess.cpp:57-60``) is erosion followed by dilation.  Border
semantics follow OpenCV's defaults: erosion treats the outside as True (the
image edge erodes nothing), dilation treats it as False.  ``F.max_pool2d``
pads with -inf, so ``dilate = max_pool(x)`` and ``erode = 1 - max_pool(1 -
x)`` give exactly that.  Plain PyTorch, as the JAX version is plain XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _max_window(x: torch.Tensor, size: int) -> torch.Tensor:
    """size x size max over the last two dims of a (..., H, W) float mask,
    with the outside of the image as -inf."""
    if size < 1 or size % 2 == 0:
        # size//2 padding keeps the shape only for odd sizes
        raise ValueError(f"morphology window size must be odd >= 1, "
                         f"got {size}")
    h, w = x.shape[-2:]
    y = F.max_pool2d(x.reshape(-1, 1, h, w), size, stride=1,
                     padding=size // 2)
    return y.reshape(x.shape)


def dilate(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Binary dilation; (..., H, W) bool -> bool."""
    return _max_window(mask.to(torch.float32), size) > 0


def erode(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Binary erosion; (..., H, W) bool -> bool."""
    return _max_window((~mask.bool()).to(torch.float32), size) <= 0


def open_(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Morphological opening (erode then dilate), OpenCV MORPH_OPEN parity."""
    return dilate(erode(mask, size), size)
