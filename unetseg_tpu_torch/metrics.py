"""Segmentation metrics (numpy): the foreground IoU of
``unetseg_tpu.metrics.foreground_iou``, which bench.py gates on."""

from __future__ import annotations

import numpy as np


def foreground_iou(pred: np.ndarray, target: np.ndarray,
                   foreground: int = 2) -> float:
    """Binary IoU of the clinically relevant class (reference FG=2); 1.0
    when neither side has any foreground."""
    p = np.asarray(pred) == foreground
    t = np.asarray(target) == foreground
    union = int(np.sum(p | t))
    if union == 0:
        return 1.0
    return int(np.sum(p & t)) / union
