"""Connected components with stats, plain PyTorch (``unetseg_tpu.ops.cc``).

The reference calls ``cv::connectedComponentsWithStats`` (8-connectivity)
twice per image (``src/postprocess.cpp:26,64``).  This module is the
readable version of the same labelling, the JAX package's label propagation
written out in PyTorch:

1. every foreground pixel starts labelled with its own flat index within
   its image (background carries the sentinel ``H*W``),
2. **hook**: each pixel takes the min label over its 8 foreground
   neighbours and scatter-mins that value into its current root,
3. **compress**: pointer jumping (``lbl = lbl[lbl]``, log2(H*W) times)
   flattens every chain to its root,
4. repeat until nothing changes (at most ``max_iters`` rounds).

At the fixed point every foreground pixel carries the minimum flat index of
its component.  It is the plain version of the K3 kernel
(``ops/cc_kernel.py``), which the tests and ``chip_smoke.py`` hold bit for
bit against it.  The loop's stop test reads the device, so this version
synchronises once per round; the serving path never calls it on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class CCStats(NamedTuple):
    """Per-segment stats indexed by root label (length H*W + 1).

    Entry ``H*W`` is the background sentinel.  Non-root labels have
    area == 0 and inverted bboxes.
    """

    area: torch.Tensor  # int32 (L+1,)
    min_row: torch.Tensor
    min_col: torch.Tensor
    max_row: torch.Tensor
    max_col: torch.Tensor


def _neighbor_min8(lbl: torch.Tensor, fg: torch.Tensor,
                   sentinel: int) -> torch.Tensor:
    """(B, H, W): min label over each pixel and its 8 foreground neighbours."""
    h, w = lbl.shape[1:]
    p = F.pad(torch.where(fg, lbl, sentinel), (1, 1, 1, 1), value=sentinel)
    m = lbl
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy != 1 or dx != 1:
                m = torch.minimum(m, p[:, dy:dy + h, dx:dx + w])
    return m


def cc_label(fg: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """Label the 8-connected components of a (H, W) or (B, H, W) bool mask.

    Returns int32 of the same shape: each foreground pixel gets its
    component's root, the minimum flat index within its image; background
    gets the sentinel ``H*W``.
    """
    squeeze = fg.dim() == 2
    fg = (fg[None] if squeeze else fg).bool()
    b, h, w = fg.shape
    size = h * w
    idx = torch.arange(size, dtype=torch.int32, device=fg.device).reshape(h, w)
    lbl = torch.where(fg, idx, size)
    sentinel_col = torch.full((b, 1), size, dtype=torch.int32, device=fg.device)
    n_jumps = max(1, (size - 1).bit_length())
    for _ in range(max_iters):
        m = torch.where(fg, torch.minimum(lbl, _neighbor_min8(lbl, fg, size)),
                        size)
        # Hook: root(p) <- min(root(p), m(p)), one scatter-min per image,
        # with a sentinel slot appended so background lands harmlessly.
        flat = torch.cat([lbl.reshape(b, -1), sentinel_col], 1)
        flat.scatter_reduce_(1, lbl.reshape(b, -1).long(), m.reshape(b, -1),
                             "amin")
        f = flat[:, :-1]
        for _ in range(n_jumps):  # compress by pointer jumping
            f = torch.cat([f, sentinel_col], 1).gather(1, f.long())
        new = f.reshape(b, h, w)
        changed = bool((new != lbl).any())
        lbl = new
        if not changed:
            break
    return lbl[0] if squeeze else lbl


def cc_stats(fg: torch.Tensor, lbl: torch.Tensor) -> CCStats:
    """Area and bbox per root label of a (H, W) mask (OpenCV CC_STAT_*)."""
    h, w = fg.shape
    size = h * w
    flat = lbl.reshape(-1).long()
    fgf = fg.reshape(-1).bool()
    dev = fg.device
    rows = torch.arange(h, dtype=torch.int32, device=dev).repeat_interleave(w)
    cols = torch.arange(w, dtype=torch.int32, device=dev).repeat(h)

    def reduce(init, values, fill, how):
        out = torch.full((size + 1,), init, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, flat, torch.where(fgf, values, fill), how)

    return CCStats(cc_area(fg, lbl), reduce(size, rows, size, "amin"),
                   reduce(size, cols, size, "amin"), reduce(-1, rows, -1, "amax"),
                   reduce(-1, cols, -1, "amax"))


def cc_area(fg: torch.Tensor, lbl: torch.Tensor) -> torch.Tensor:
    """Per-root areas only (one scatter-add), for the area filter."""
    size = fg.shape[-2] * fg.shape[-1]
    return torch.zeros(size + 1, dtype=torch.int32, device=fg.device
                       ).scatter_add_(0, lbl.reshape(-1).long(),
                                      fg.reshape(-1).to(torch.int32))


def connected_components_with_stats(fg: torch.Tensor):
    """Labels and stats of a (H, W) bool mask."""
    lbl = cc_label(fg)
    return lbl, cc_stats(fg, lbl)
