"""8-connected CCL, component stats and region-min propagation: the K3 kernel.

The port's counterpart of ``unetseg_tpu/ops/cc_pallas.py`` (the Pallas
kernel ``_propagate_min`` with its entries ``cc_label_pallas`` and
``propagate_min_pallas``).  On a CUDA tensor :func:`cc_label`,
:func:`cc_label_stats` and :func:`propagate_min` launch the hand-written
block-based union-find in ``unetseg_tpu_torch/csrc/cc_label.cu`` (built with
nvcc for sm_90a at first use, bound with ctypes) or raise; they never fall
back.  On a CPU tensor they run the plain versions, :func:`cc.cc_label`,
:func:`cc_label_stats_plain` and :func:`propagate_min_plain`, which the
tests and ``chip_smoke.py`` hold the kernel against bit for bit.

The kernel's tiling is decided here, in :func:`tile_plan`, and passed to
it, so the CPU tests cover the plan: tiles of at most ``TILE_CAP`` pixels of
one image, ``th`` rows by ``tw`` columns, ``tw`` a power of two.

:func:`cc_label_stats` packs each component's area and border touch into
one int32 slot per root (:func:`stats_area`, :func:`stats_touch`): image
b's root r has slot ``b * (H*W + 1) + r``, the indexing of
``postprocess._region_predicate``.  Only root slots and each image's
background slot (``H*W``, 0) are defined; the kernel writes no other.

Union-find is exact, so unlike ``propagate_min_pallas`` there is no
``max_passes``: only a pass-capped JAX call can differ.  ``LAUNCHES`` counts
wrapper calls that launched the kernel (each runs three ``__global__``
passes, four for ``propagate_min``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from unetseg_tpu_torch import graphs
from unetseg_tpu_torch._build import Library, check, cuda
from unetseg_tpu_torch.ops import cc

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "cc_label.cu")

#: The source's tile limits: columns (a power of two) and pixels per tile.
TILE_W = 128
TILE_CAP = 4096
#: Bit 31 of a stats slot: the component touches the image border.
TOUCH_BIT = -2 ** 31

LIBRARY = Library("libcc_label", cuda("-Xptxas", "-v"), [SOURCE], functions={
    "utcc_label": (ctypes.c_int, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p]),
    "utcc_propagate_min": (ctypes.c_int,
                           [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p] + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])})

#: Kernel launches per entry since the last ``graphs.reset_launches``;
#: ``cc_label`` counts both labelling entries (with and without stats).
LAUNCHES: Dict[str, int] = graphs.counts_launches(
    {"cc_label": 0, "propagate_min": 0})


class TilePlan(NamedTuple):
    """How the kernel cuts a (B, H, W) batch: see :func:`tile_plan`."""
    th: int       # tile rows
    tw: int       # tile columns, a power of two <= TILE_W
    tiles_h: int
    tiles_w: int
    grid: int     # blocks of each pass: B * tiles_h * tiles_w


def tile_plan(B: int, H: int, W: int,
              tile: Optional[Tuple[int, int]] = None) -> TilePlan:
    """The kernel's tiling of a (B, H, W) batch.

    By default a tile is ``tw = min(TILE_W, next power of two >= W)``
    columns by ``th = min(H, TILE_CAP // max(tw, 32))`` rows (32 x 128 at
    512²), so an image narrower than ``TILE_W`` is one tile column whose
    last columns lie outside it, and a ragged last tile row or column is
    masked by the kernel.  The kernel holds a tile row as 32-pixel
    segments (one segment when ``tw < 32``), at most ``TILE_CAP // 32`` of
    them.  ``tile = (th, tw)`` picks another tile (tests use small ones, to
    cross many tile edges); the kernel refuses ``tw`` not a power of two,
    ``tw > TILE_W`` and ``th * max(tw, 32) > TILE_CAP``, and so does
    this."""
    if min(B, H, W) < 1:
        raise ValueError(f"cc tile plan: empty batch B={B} H={H} W={W}")
    if tile is None:
        tw = min(TILE_W, 1 << (W - 1).bit_length())
        th = min(H, TILE_CAP // max(tw, 32))
    else:
        th, tw = tile
    if th < 1 or tw < 1 or tw > TILE_W or tw & (tw - 1) or \
            th * max(tw, 32) > TILE_CAP:
        raise ValueError(f"cc tile plan: tile {th} x {tw} not taken (tw a "
                         f"power of two <= {TILE_W}, th * max(tw, 32) <= "
                         f"{TILE_CAP})")
    tiles_h, tiles_w = -(-H // th), -(-W // tw)
    return TilePlan(th, tw, tiles_h, tiles_w, B * tiles_h * tiles_w)


def resources() -> list:
    """Per kernel of the library, what ``nvcc -Xptxas -v`` reported when it
    was built: dicts with keys ``kernel``, ``registers``, ``spill_bytes``,
    ``smem_static``."""
    return [{"kernel": name, **info}
            for name, info in sorted(LIBRARY.ptxas().items())
            if info["registers"] is not None]


def stats_area(stats: torch.Tensor) -> torch.Tensor:
    """Areas of a packed stats table (bits 0-30)."""
    return stats & (2 ** 31 - 1)


def stats_touch(stats: torch.Tensor) -> torch.Tensor:
    """Border touches of a packed stats table (bit 31)."""
    return stats < 0


def cc_label_stats_plain(fg: torch.Tensor) -> tuple:
    """Plain version of :func:`cc_label_stats`: :func:`cc.cc_label`, then one
    scatter-add of the foreground into each root's slot for the areas and
    one fill of the border pixels' roots for the touches; every slot is
    defined (0 off the roots)."""
    lbl = cc.cc_label(fg)
    x = lbl[None] if lbl.dim() == 2 else lbl
    n, h, w = x.shape
    size = h * w
    offsets = torch.arange(n, device=x.device).reshape(n, 1, 1) * (size + 1)
    slots = (x.long() + offsets).reshape(-1)
    area = torch.zeros(n * (size + 1), dtype=torch.int32, device=x.device)
    area.scatter_add_(0, slots, fg.reshape(-1).to(torch.int32))
    edges = torch.cat([x[:, 0], x[:, -1], x[:, :, 0], x[:, :, -1]],
                      1).long() + offsets.reshape(n, 1)
    touch = torch.zeros(n * (size + 1), dtype=torch.bool, device=x.device)
    touch.index_fill_(0, edges.reshape(-1), True)
    stats = torch.where(touch, area | TOUCH_BIT, area)
    stats.view(n, size + 1)[:, size] = 0
    return lbl, stats


def propagate_min_plain(init: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Plain version of :func:`propagate_min`: label the non-sentinel cells,
    scatter-min each seed into its root's slot, gather it back."""
    region = init != sentinel
    lbl = cc.cc_label(region).long()
    size = init.shape[-2] * init.shape[-1]
    flat_lbl = lbl.reshape(-1, size)
    seeds = init.reshape(-1, size)
    roots = torch.cat([seeds, torch.full_like(seeds[:, :1], sentinel)], 1)
    roots.scatter_reduce_(1, flat_lbl, seeds, "amin")
    return torch.where(region, roots.gather(1, flat_lbl).reshape(init.shape),
                       init)


def _batch(x: torch.Tensor, what: str, dtype: torch.dtype) -> torch.Tensor:
    """Validate a (H, W) or (B, H, W) input; returns it as (B, H, W)."""
    if x.dim() not in (2, 3) or x.dtype != dtype:
        raise ValueError(f"{what} takes (H, W) or (B, H, W) {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    # The kernel indexes pixels, and stats slots within an image, in int.
    if x.numel() >= 2 ** 31 - 1:
        raise ValueError(f"{what}: more than 2**31 pixels")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x[None] if x.dim() == 2 else x


def _launch(fn, x: torch.Tensor, plan: TilePlan, *args) -> None:
    b, h, w = x.shape
    with torch.cuda.device(x.device):  # the launch goes to x's card
        err = fn(*args, b, h, w, plan.th, plan.tw,
                 torch.cuda.current_stream(x.device).cuda_stream)
    check(err, fn.__name__)


def _label(fg: torch.Tensor, what: str, stats: bool,
           tile: Optional[Tuple[int, int]]):
    x = _batch(fg, what, torch.bool).contiguous()
    b, h, w = x.shape
    lbl = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    table = torch.empty(b * (h * w + 1) if stats else 0, dtype=torch.int32,
                        device=x.device)
    if x.numel():
        _launch(LIBRARY.load().utcc_label, x, tile_plan(b, h, w, tile),
                x.data_ptr(), lbl.data_ptr(),
                table.data_ptr() if stats else None)
        LAUNCHES["cc_label"] += 1
    return lbl.reshape(fg.shape), table


def cc_label(fg: torch.Tensor, tile: Optional[Tuple[int, int]] = None
             ) -> torch.Tensor:
    """(H, W) or (B, H, W) bool -> int32 labels: each foreground pixel gets
    the minimum flat index within its image of its 8-connected component,
    background the sentinel ``H*W`` (``cc_label_pallas``'s contract).
    ``tile`` overrides :func:`tile_plan`'s tile on the card."""
    if _batch(fg, "cc_label", torch.bool).device.type == "cpu":
        return cc.cc_label(fg)
    return _label(fg, "cc_label", False, tile)[0]


def cc_label_stats(fg: torch.Tensor, tile: Optional[Tuple[int, int]] = None
                   ) -> tuple:
    """:func:`cc_label`'s labels and the packed per-root stats table: int32
    of length ``B * (H*W + 1)``, image b's root r at ``b * (H*W + 1) + r``
    with the component's area in bits 0-30 and bit 31 set when it touches
    the image border (:func:`stats_area`, :func:`stats_touch`).  Only root
    slots and each image's slot ``H*W`` (0) are defined on the card."""
    if _batch(fg, "cc_label_stats", torch.bool).device.type == "cpu":
        return cc_label_stats_plain(fg)
    return _label(fg, "cc_label_stats", True, tile)


def propagate_min(init: torch.Tensor, sentinel: int,
                  tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(H, W) or (B, H, W) int32 seeds -> for each 8-connected region of
    non-sentinel cells, the minimum seed over the region; sentinel cells stay
    (``propagate_min_pallas``'s contract, without ``max_passes``).  Seeds are
    taken below the sentinel, as in every JAX caller."""
    x = _batch(init, "propagate_min", torch.int32)
    if x.device.type == "cpu":
        return propagate_min_plain(init, sentinel)
    x = x.contiguous()
    b, h, w = x.shape
    lbl = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    out = torch.empty_like(lbl)
    if x.numel():
        _launch(LIBRARY.load().utcc_propagate_min, x, tile_plan(b, h, w, tile),
                x.data_ptr(), int(sentinel), lbl.data_ptr(), out.data_ptr())
        LAUNCHES["propagate_min"] += 1
    return out.reshape(init.shape)
