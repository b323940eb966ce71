"""How a class map is judged against reference logits, for any family."""

from __future__ import annotations

import numpy as np


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
