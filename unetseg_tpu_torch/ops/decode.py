"""Argmax decode of UNet logits to a class mask (``unetseg_tpu.ops.decode``).

The reference compares classes with strict ``>`` against a running max
(``src/process.cpp:157-171``), so ties go to the lowest class index.
``torch.argmax`` is documented to return the first maximal index, which is
the same rule (pinned by tests/test_torch_port_ops.py).
"""

from __future__ import annotations

import numpy as np
import torch

_LUT = np.zeros(256, np.uint8)
_LUT[1], _LUT[2] = 128, 255


def decode_mask(logits: torch.Tensor, num_classes: int = 3) -> torch.Tensor:
    """(..., H, W, C) logits -> (..., H, W) uint8 label mask; only the first
    ``num_classes`` channels take part (src/process.cpp:162)."""
    return torch.argmax(logits[..., :num_classes], dim=-1).to(torch.uint8)


def mask_to_image_np(mask) -> np.ndarray:
    """Visualization LUT 0->0, 1->128, 2->255 (src/process.cpp:178-185)."""
    return _LUT[np.asarray(mask, np.uint8)]
