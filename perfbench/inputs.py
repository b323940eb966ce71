"""What a run feeds the program, made from its seed: synthetic CT-like
slices, the RAW files of a study, and a configuration's
weights (read from a checkpoint, or drawn on the card and their head bias
centred by the reference)."""

from __future__ import annotations

import math
import os
from typing import List, Tuple

import numpy as np
import torch

from perfbench.reference import host
from perfbench.reference.unet import Reference


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


def _he_tree(cfg: dict, gen: torch.Generator, device) -> dict:
    """He-normal 3x3, up- and head weights and zero biases in the JAX
    layout, drawn in one call on ``device`` and rounded to bfloat16, the
    type the program serves them in."""
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
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=gen, device=device)
    tree: dict = {"encoder": [{} for _ in chans], "bottleneck": {},
                  "decoder": [{} for _ in chans]}
    pos = 0
    for name, shape in shapes:
        n = math.prod(shape)
        fan_in = shape[0] * shape[1] * shape[2]
        w = (flat[pos: pos + n].reshape(shape) * math.sqrt(2.0 / fan_in))
        pos += n
        site = {"w": w.bfloat16().float().cpu().numpy(),
                "b": np.zeros(shape[-1], np.float32)}
        parts = name.split(".")
        if parts[0] == "head":
            tree["head"] = site
        elif parts[0] == "bottleneck":
            tree["bottleneck"][parts[1]] = site
        else:
            tree[parts[0]][int(parts[1])][parts[2]] = site
    return tree


def seeded_params(cfg: dict, seed: int, raws: np.ndarray, device) -> dict:
    """The configuration's seeded weights, the head bias set to minus the
    median logit of each class that the reference computes on ``raws``
    (so random weights paint every class, and masks have contours)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tree = _he_tree(cfg, gen, device)
    u8 = np.stack([host.preprocess_u8(r, cfg["image_size"]) for r in raws])
    logits = Reference(tree, cfg["stem"], device).logits(u8)
    bias = -np.median(logits.reshape(-1, cfg["num_classes"]), axis=0)
    bias = np.tile(bias, cfg["stem"] ** 2)  # the head's (dy, dx, k) order
    tree["head"]["b"] = torch.tensor(bias).bfloat16().float().numpy()
    return tree
