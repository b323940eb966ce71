"""Synthetic CT-like slices and model-ready batches, a copy of
``unetseg_tpu.data.synth_slice``, ``synth_batch`` and ``training_batch``
(numpy only).

A noisy background with a bright soft-edged ellipse "organ" (class 2) and a
dimmer distractor blob (class 1), mirroring the reference's class semantics
(src/postprocess.cpp:5-7).  Same generator calls in the same order, so the
same seed gives the same slices as the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synth_slice(rng: np.random.Generator, size: int = 512,
                r_range: Tuple[float, float] = (0.12, 0.3),
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (raw uint16 (size,size), labels uint8 (size,size) in {0,1,2}).

    ``r_range`` bounds the organ's semi-axes as a fraction of ``size``.
    """
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)

    cy, cx = rng.uniform(0.3, 0.7, 2) * size
    ry, rx = rng.uniform(*r_range, 2) * size
    theta = rng.uniform(0, np.pi)
    ct, st = np.cos(theta), np.sin(theta)
    u = ((xx - cx) * ct + (yy - cy) * st) / rx
    v = (-(xx - cx) * st + (yy - cy) * ct) / ry
    organ = (u * u + v * v) <= 1.0

    dcy, dcx = rng.uniform(0.1, 0.9, 2) * size
    dr = rng.uniform(0.04, 0.08) * size
    distract = ((xx - dcx) ** 2 + (yy - dcy) ** 2) <= dr * dr

    img = rng.normal(12000, 1500, (size, size))
    img += organ * rng.uniform(18000, 26000)
    img += distract * rng.uniform(6000, 9000)
    img = np.clip(img, 0, 65535).astype(np.uint16)

    labels = np.zeros((size, size), np.uint8)
    labels[distract] = 1
    labels[organ] = 2
    return img, labels


def synth_batch(rng: np.random.Generator, n: int, size: int = 512):
    """(raws (n,s,s) u16, labels (n,s,s) u8)."""
    raws = np.empty((n, size, size), np.uint16)
    labels = np.empty((n, size, size), np.uint8)
    for i in range(n):
        raws[i], labels[i] = synth_slice(rng, size)
    return raws, labels


def training_batch(rng: np.random.Generator, n: int, size: int = 512):
    """Model-ready (imgs (n,s,s,1) f32 in [0,1], labels (n,s,s) i32), a copy
    of ``unetseg_tpu.data.training_batch``: each slice goes through the
    serving pipeline's per-slice min-max + u8 quantize and /255, so the
    calibration (and training) distribution is the served one."""
    from unetseg_tpu_torch.ops.preprocess import preprocess_oracle_u8

    imgs = np.empty((n, size, size, 1), np.float32)
    labels = np.empty((n, size, size), np.int32)
    for i in range(n):
        raw, lab = synth_slice(rng, size)
        u8 = preprocess_oracle_u8(raw, size)  # same size: a pure quantize
        imgs[i, ..., 0] = u8.astype(np.float32) / 255.0
        labels[i] = lab
    return imgs, labels
