"""What a run feeds the program, made from its seed: synthetic CT-like
slices, the RAW files of a study, and a configuration's
seeded weights (drawn on the card by its reference module, their head bias
centred by its reference)."""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from perfbench.reference import host


def synth_slice(rng: np.random.Generator, size: int) -> np.ndarray:
    """One (size, size) uint16 slice: a bright elliptical organ, a fainter
    disc and noise; a copy of ``unetseg_tpu_torch.data.synth_slice``'s
    image, the same numbers for the same generator."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    cy, cx = rng.uniform(0.3, 0.7, 2) * size
    ry, rx = rng.uniform(0.12, 0.3, 2) * size
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
    return np.clip(img, 0, 65535).astype(np.uint16)


def slices(seed: int, n: int, size: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([synth_slice(rng, size) for _ in range(n)])


def write_files(raws: np.ndarray, directory: str, n_files: int) -> List[str]:
    """``n_files`` headerless little-endian RAW files, file k holding slice
    ``k % len(raws)``.  The first ``len(raws)`` are written; the rest are
    hard links to them (the same bytes, read through their own names)."""
    os.makedirs(directory, exist_ok=True)
    size = raws.shape[-1]
    paths = []
    for k in range(n_files):
        p = os.path.join(directory, f"slice_{k:03d}_{size}_{size}.raw")
        if os.path.exists(p):
            os.remove(p)
        if k < len(raws):
            raws[k].astype("<u2").tofile(p)
        else:
            try:
                os.link(paths[k % len(raws)], p)
            except OSError:
                raws[k % len(raws)].astype("<u2").tofile(p)
        paths.append(p)
    return paths


def seeded_params(cfg: dict, seed: int, raws: np.ndarray, device,
                  family) -> dict:
    """The configuration's seeded weights, drawn by its reference module
    ``family`` on ``device``, and the head bias set to minus the median
    logit of each class that the reference computes on ``raws`` (so random
    weights paint every class, and masks have contours)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tree = family.init(cfg, gen, device)
    u8 = np.stack([host.preprocess_u8(r, cfg["image_size"]) for r in raws])
    logits = family.Reference(tree, cfg, device).logits(u8)
    family.centre(tree, -np.median(logits.reshape(-1, cfg["num_classes"]),
                                   axis=0))
    return tree
