"""Mask cleanup on the device (``unetseg_tpu.ops.postprocess``).

Exact reimplementation of the reference's ``src/postprocess.cpp``:

1. **hole fill** (postprocess.cpp:13-44): 8-connected components of the
   *inverse* of the foreground (mask == 2); any component that touches no
   image border AND whose area < ``int(w*h*0.06f)`` is filled to 2,
2. **binarize + 3x3 MORPH_OPEN** (postprocess.cpp:57-60),
3. **component area filter** (postprocess.cpp:63-72): keep 8-connected
   components with area >= the same threshold,
4. **remap to {0, 2}** (postprocess.cpp:75-76).

:func:`postprocess_mask` is the readable per-image oracle over the plain
``cc.cc_label``.  :func:`postprocess_masks` is the batched serving path: two
K3 calls per batch (``ops/cc_kernel.cc_label_stats``; the plain version on a
CPU tensor), each returning the labels and every component's area and
border touch, then one gather per pixel; no scatter on the card and no host
synchronisation, so the engine keeps overlapping batches while it runs.
"""

from __future__ import annotations

import numpy as np
import torch

from unetseg_tpu_torch.ops import cc, cc_kernel, morphology

FOREGROUND_VALUE = 2
MORPH_KERNEL_SIZE = 3
MIN_AREA_RATIO = np.float32(0.06)


def min_area_threshold(h: int, w: int) -> int:
    """int(w * h * 0.06f) with C++ float32 semantics (postprocess.cpp:30,66)."""
    return int(np.float32(w * h) * MIN_AREA_RATIO)


def fill_holes_inside_foreground(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 label mask -> mask with interior holes set to 2 (plain
    ``cc.cc_label``; the oracle of :func:`postprocess_masks`'s hole fill)."""
    h, w = mask.shape
    inv = mask != FOREGROUND_VALUE
    lbl, stats = cc.connected_components_with_stats(inv)
    is_hole = ((stats.min_col > 0) & (stats.min_row > 0)
               & (stats.max_col < w - 1) & (stats.max_row < h - 1)
               & (stats.area < min_area_threshold(h, w)))
    fill = is_hole[lbl.reshape(-1).long()].reshape(h, w) & inv
    return torch.where(fill, FOREGROUND_VALUE, mask).to(torch.uint8)


def postprocess_mask(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 class mask -> cleaned {0, 2} uint8 mask (the oracle)."""
    h, w = mask.shape
    mask = fill_holes_inside_foreground(mask)
    fg = morphology.open_(mask == FOREGROUND_VALUE, MORPH_KERNEL_SIZE)
    lbl = cc.cc_label(fg)
    keep_seg = cc.cc_area(fg, lbl) >= min_area_threshold(h, w)
    keep = keep_seg[lbl.reshape(-1).long()].reshape(h, w) & fg
    return torch.where(keep, FOREGROUND_VALUE, 0).to(torch.uint8)


def _region_predicate(lbl: torch.Tensor, stats: torch.Tensor,
                      region: torch.Tensor, min_area: int, hole: bool
                      ) -> torch.Tensor:
    """Per-pixel component predicate of a batch, from K3's per-root table.

    ``lbl`` (N, H, W) holds roots in [0, H*W] (H*W off the region) and
    ``stats`` each root's area and border touch, packed, with image b's root
    r at slot b*(H*W+1) + r (``cc_kernel.cc_label_stats``).  One gather: a
    hole has no touch bit (a non-negative slot) and an area below the
    threshold; a kept component an area at or above it.
    """
    n, h, w = lbl.shape
    offsets = torch.arange(n, device=lbl.device).reshape(n, 1, 1) * (h * w + 1)
    v = stats[(lbl.long() + offsets).reshape(-1)].reshape(n, h, w)
    if hole:
        return (v >= 0) & (v < min_area) & region
    return (cc_kernel.stats_area(v) >= min_area) & region


def postprocess_masks(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) uint8 class masks -> cleaned {0, 2} uint8 masks, with the
    semantics of :func:`postprocess_mask` on each; the labelling runs in K3
    on a CUDA tensor."""
    n, h, w = masks.shape
    min_area = min_area_threshold(h, w)
    inv = masks != FOREGROUND_VALUE
    fill = _region_predicate(*cc_kernel.cc_label_stats(inv), inv, min_area,
                             hole=True)
    masks = torch.where(fill, FOREGROUND_VALUE, masks)
    fg = morphology.open_(masks == FOREGROUND_VALUE, MORPH_KERNEL_SIZE)
    keep = _region_predicate(*cc_kernel.cc_label_stats(fg), fg, min_area,
                             hole=False)
    return torch.where(keep, FOREGROUND_VALUE, 0).to(torch.uint8)
