"""K3's tile plan (ops/cc_kernel.py ``tile_plan``) and its three passes, on
the CPU.

The kernel (``csrc/cc_label.cu``) runs only on the card; what it does with
a plan is emulated here in numpy, pass by pass: (a) union-find of each tile
on tile-local indices, over the runs of its 32-pixel row segments (a run
unites with the run continuing it from the left segment and with each run
of the row above it touches), the tile's area,
border touch and seed minimum per local component, labels out with members
coded ``-(local root) - 1``; (b) the top row and left column of each tile
united with their neighbours in other tiles; (c) each local root's global
root, its stats added into the global root's slot, members relabelled.  The
union order cannot change the result (the smaller root always wins), so a
sequential emulation gives the kernel's labels.  The emulation's labels,
areas, touches and region minima must equal the plain versions and the JAX
package's CCL bit for bit, on every plan tried, and pass (b) must unite
each foreground edge between two tiles exactly once and no other.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unetseg_tpu.ops import cc as jax_cc
from unetseg_tpu.ops import postprocess as jax_pp
from unetseg_tpu.ops.cc_pallas import cc_label_pallas, propagate_min_pallas
from unetseg_tpu_torch import graphs
from unetseg_tpu_torch.ops import cc, cc_kernel, postprocess

POISON = 0x5A5A5A5A  # a stats slot the kernel never writes
TOUCH = -2 ** 31


def _source_constants():
    with open(cc_kernel.SOURCE) as f:
        src = f.read()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (THREADS|TILE_W|TILE_CAP) = (\d+);", src)}


def test_tile_plan_matches_the_source():
    k = _source_constants()
    assert (k["TILE_W"], k["TILE_CAP"]) == (cc_kernel.TILE_W,
                                            cc_kernel.TILE_CAP)
    assert k["TILE_CAP"] % k["THREADS"] == 0  # PER_THREAD labels a thread
    assert cc_kernel.tile_plan(128, 512, 512) == (32, 128, 16, 4, 8192)


@pytest.mark.parametrize("b,h,w", [(1, 1, 1), (1, 64, 1), (1, 17, 15),
                                   (3, 70, 63), (2, 33, 90), (2, 70, 300),
                                   (1, 1, 300), (2, 300, 1), (128, 512, 512),
                                   (1, 4097, 3), (1, 2, 5000)])
def test_tile_plan_invariants(b, h, w):
    p = cc_kernel.tile_plan(b, h, w)
    assert p.tw & (p.tw - 1) == 0 and p.tw <= cc_kernel.TILE_W
    assert p.th * max(p.tw, 32) <= cc_kernel.TILE_CAP and p.th <= h
    # The tiles cover the image, and no tile lies wholly outside it.
    assert (p.tiles_h - 1) * p.th < h <= p.tiles_h * p.th
    assert (p.tiles_w - 1) * p.tw < w <= p.tiles_w * p.tw
    assert p.grid == b * p.tiles_h * p.tiles_w
    if w <= cc_kernel.TILE_W:  # narrow images: one tile column
        assert p.tiles_w == 1


@pytest.mark.parametrize("tile", [(3, 48), (1, 256), (64, 128), (0, 8),
                                  (8, 0), (129, 16)])
def test_tile_plan_refuses_what_the_kernel_refuses(tile):
    with pytest.raises(ValueError, match="tile"):
        cc_kernel.tile_plan(1, 64, 64, tile)


def test_tile_plan_refuses_empty_batches():
    with pytest.raises(ValueError, match="empty"):
        cc_kernel.tile_plan(0, 8, 8)


# ---------------------------------------------------------------------------
# The emulation.


class _Emulation:
    """K3's passes on one (B, H, W) mask (or seeds) under one tile."""

    def __init__(self, fg, th, tw, seeds=None):
        self.fg = fg
        self.b, self.h, self.w = fg.shape
        self.th, self.tw = th, tw
        self.lg = tw.bit_length() - 1
        self.hw = self.h * self.w
        self.seeds = seeds
        self.L = np.zeros((self.b, self.hw), np.int64)
        self.stats = np.full((self.b, self.hw + 1), POISON, np.int64)
        self.out = np.full((self.b, self.hw), POISON, np.int64)
        self.tiles = [(i, ty * th, tx * tw)
                      for i in range(self.b)
                      for ty in range(-(-self.h // th))
                      for tx in range(-(-self.w // tw))]
        self.border_edges = []
        self.local_roots = np.zeros((self.b, self.hw + 1), bool)
        self.local_roots[:, self.hw] = True  # the background slot

    def _pixel(self, y0, x0, i):
        return y0 + (i >> self.lg), x0 + (i & (self.tw - 1))

    def local_pass(self, b, y0, x0):
        """Pass (a) on 32-pixel row segments, as the kernel runs it."""
        th, tw, h, w = self.th, self.tw, self.h, self.w
        ww = min(32, tw)
        nw = tw // ww
        bits = []  # segment masks, row-major
        for row in range(th):
            for wx in range(nw):
                y, xs = y0 + row, x0 + wx * ww
                m = 0
                for j in range(ww):
                    if y < h and xs + j < w and self.fg[b, y, xs + j]:
                        m |= 1 << j
                bits.append(m)

        def starts(m):
            return m & ~(m << 1)

        def run_start(m, q):
            return (starts(m) & ((2 << q) - 1)).bit_length() - 1

        def runs(m):
            r = starts(m)
            while r:
                a = (r & -r).bit_length() - 1
                e = a
                while m >> (e + 1) & 1:
                    e += 1
                yield a, e
                r &= r - 1

        lab = {}
        for seg, m in enumerate(bits):
            node0 = (seg // nw) * tw + (seg % nw) * ww
            for a, _ in runs(m):
                lab[node0 + a] = node0 + a

        def find(x):
            while lab[x] != x:
                x = lab[x]
            return x

        def unite(p, q):
            p, q = find(p), find(q)
            if p != q:
                lab[max(p, q)] = min(p, q)

        for seg, m in enumerate(bits):
            row, wx = divmod(seg, nw)
            node0 = row * tw + wx * ww
            for a, e in runs(m):
                node = node0 + a
                if a == 0 and wx > 0 and bits[seg - 1] >> (ww - 1) & 1:
                    unite(node, node - ww + run_start(bits[seg - 1], ww - 1))
                if row == 0:
                    continue
                up = bits[seg - nw]
                lo, hi = max(a - 1, 0), min(e + 1, ww - 1)
                hits = up & ((2 << hi) - 1) & ~((1 << lo) - 1)
                f = hits & ~(hits << 1)
                while f:
                    q = (f & -f).bit_length() - 1
                    unite(node, node0 - tw + run_start(up, q))
                    f &= f - 1
                ul = bits[seg - nw - 1] if wx > 0 else 0
                if a == 0 and wx > 0 and not up & 1 and ul >> (ww - 1) & 1:
                    unite(node, node0 - tw - ww + run_start(ul, ww - 1))
                ur = bits[seg - nw + 1] if wx + 1 < nw else 0
                if e == ww - 1 and wx + 1 < nw and not up >> (ww - 1) & 1 \
                        and ur & 1:
                    unite(node, node0 - tw + ww)

        area, touch, smin = {}, {}, {}
        out = [-1] * (th * tw)
        for seg, m in enumerate(bits):
            row, wx = divmod(seg, nw)
            node0 = row * tw + wx * ww
            y, xs = y0 + row, x0 + wx * ww
            for a, e in runs(m):
                root = find(node0 + a)
                area[root] = area.get(root, 0) + e - a + 1
                touch[root] = (touch.get(root, False) or y in (0, h - 1)
                               or xs + a == 0 or xs + e == w - 1)
                for j in range(a, e + 1):
                    out[node0 + j] = root
                    if self.seeds is not None:
                        smin[root] = min(smin.get(root, 2 ** 31),
                                         self.seeds[b, y, xs + j])
        for i, r in enumerate(out):
            y, x = self._pixel(y0, x0, i)
            if y >= h or x >= w:
                continue
            q = y * w + x
            if r < 0:
                self.L[b, q] = self.hw
            elif r == i:
                self.L[b, q] = q
                self.local_roots[b, q] = True
                self.stats[b, q] = area[r] + (TOUCH if touch[r] else 0)
                if self.seeds is not None:
                    self.out[b, q] = smin[r]
            else:
                self.L[b, q] = -r - 1
        if y0 == 0 and x0 == 0:
            self.stats[b, self.hw] = 0

    def _parent(self, b, q):
        v = self.L[b, q]
        if v >= 0:
            return int(v)
        lr = -v - 1
        y, x = divmod(q, self.w)
        return ((y - y % self.th + (lr >> self.lg)) * self.w
                + (x & ~(self.tw - 1)) + (lr & (self.tw - 1)))

    def _find(self, b, x):
        while self.L[b, x] != x:
            x = int(self.L[b, x])
        return x

    def border_pass(self, b, y0, x0):
        th, tw, h, w = self.th, self.tw, self.h, self.w
        y_end = min(y0 + th, h)
        for k in range(tw + th):
            top = k < tw
            y, x = (y0, x0 + k) if top else (y0 + k - tw, x0)
            if (y0 == 0 if top else x0 == 0) or y >= h or x >= w:
                continue
            p = y * w + x
            if self.L[b, p] == self.hw:
                continue
            a = self._parent(b, p)

            def link(q):
                if self.L[b, q] == self.hw:
                    return
                self.border_edges.append((b, min(p, q), max(p, q)))
                r1 = self._find(b, a)
                r2 = self._find(b, self._parent(b, q))
                if r1 != r2:
                    self.L[b, max(r1, r2)] = min(r1, r2)

            if top:
                link(p - w)
                if x > 0:
                    link(p - w - 1)
                if x + 1 < w:
                    link(p - w + 1)
            else:
                link(p - 1)
                if y > y0:
                    link(p - w - 1)
                if y + 1 < y_end:
                    link(p + w - 1)

    def compress_pass(self, b, y0, x0):
        cells = []
        for i in range(self.th * self.tw):
            y, x = self._pixel(y0, x0, i)
            if y < self.h and x < self.w:
                q = y * self.w + x
                cells.append((i, q, int(self.L[b, q])))
        groot = {}
        for i, q, v in cells:
            if v < 0 or v == self.hw:
                continue
            g = self._find(b, v)
            groot[i] = g
            if g == q:
                continue
            self.L[b, q] = g
            s = self.stats[b, q]
            t = self.stats[b, g]
            area = (t & 0x7FFFFFFF) + (s & 0x7FFFFFFF)
            self.stats[b, g] = area + (TOUCH if (s < 0 or t < 0) else 0)
            if self.seeds is not None:
                self.out[b, g] = min(self.out[b, g], self.out[b, q])
        for i, q, v in cells:
            if v < 0:
                self.L[b, q] = groot[-v - 1]

    def run(self):
        for t in self.tiles:
            self.local_pass(*t)
        if len(self.tiles) > self.b:
            for t in self.tiles:
                self.border_pass(*t)
        for t in self.tiles:
            self.compress_pass(*t)
        labels = self.L.reshape(self.b, self.h, self.w)
        if self.seeds is not None:  # (d): each cell its root's minimum
            flat = self.L
            sentinel = self.hw
            region = flat != self.hw
            gathered = np.take_along_axis(self.out,
                                          np.where(region, flat, 0), 1)
            self.region_min = np.where(region, gathered, sentinel).reshape(
                labels.shape)
        return labels

    def cross_tile_edges(self):
        """Every foreground 8-edge whose pixels lie in two tiles."""
        out = set()
        h, w = self.h, self.w
        for b in range(self.b):
            ys, xs = np.nonzero(self.fg[b])
            on = set(zip(ys.tolist(), xs.tolist()))
            for y, x in on:
                for dy, dx in ((0, 1), (1, -1), (1, 0), (1, 1)):
                    y2, x2 = y + dy, x + dx
                    if (y2, x2) in on and ((y // self.th, x // self.tw)
                                           != (y2 // self.th, x2 // self.tw)):
                        p, q = y * w + x, y2 * w + x2
                        out.add((b, min(p, q), max(p, q)))
        return out


def _plans(shape):
    """The default tile and small ragged ones for a (B, H, W) shape."""
    p = cc_kernel.tile_plan(*shape)
    return sorted({(p.th, p.tw), (4, 8), (3, 4), (1, 16), (5, 1)})


def _check(fg, tile):
    fg = fg if fg.ndim == 3 else fg[None]
    th, tw = tile or cc_kernel.tile_plan(*fg.shape)[:2]
    emu = _Emulation(fg, th, tw)
    labels = emu.run()
    t = torch.from_numpy(fg)
    want_l, want_s = cc_kernel.cc_label_stats_plain(t)
    np.testing.assert_array_equal(labels, want_l.numpy())
    np.testing.assert_array_equal(labels, np.stack(
        [np.asarray(jax_cc.cc_label(jnp.asarray(f))) for f in fg]))
    # The stats table: root slots and background slots equal the plain
    # version's; only local roots' slots (a superset) are written.
    hw = fg.shape[1] * fg.shape[2]
    want_s = want_s.numpy().reshape(len(fg), hw + 1).astype(np.int64)
    is_root = np.zeros_like(want_s, bool)
    is_root[:, :hw] = labels.reshape(len(fg), hw) == np.arange(hw)
    is_root[:, hw] = True
    np.testing.assert_array_equal(emu.stats[is_root], want_s[is_root])
    np.testing.assert_array_equal(emu.stats != POISON, emu.local_roots)
    assert not (is_root & ~emu.local_roots).any()
    # Pass (b) united each foreground edge between tiles once, and no other.
    assert len(emu.border_edges) == len(set(emu.border_edges))
    assert set(emu.border_edges) == emu.cross_tile_edges()
    return labels


@pytest.mark.parametrize("case", [n for n, _ in chip_smoke.cc_cases(np)])
def test_emulation_matches_plain_and_pallas_on_every_plan(case):
    fg = dict(chip_smoke.cc_cases(np))[case]
    want = np.asarray(cc_label_pallas(jnp.asarray(fg), interpret=True))
    for tile in _plans((1, *fg.shape)):
        np.testing.assert_array_equal(_check(fg, tile)[0], want,
                                      err_msg=str(tile))


@pytest.mark.parametrize("case", [n for n, _, _ in
                                  chip_smoke.cc_edge_cases(np)])
def test_emulation_on_the_tiling_edge_cases(case):
    _, fg, tile = next(c for c in chip_smoke.cc_edge_cases(np)
                       if c[0] == case)
    labels = _check(fg, tile)
    if case.startswith("serpentine"):
        assert (labels[fg] == 0).all()


def test_corner_links_join_their_tiles():
    """Diagonal pairs on tile corners: each pair is one component."""
    _, fg, _ = chip_smoke.cc_edge_cases(np)[1]
    labels = _check(fg, (8, 16))
    for y0 in range(8, fg.shape[1], 8):
        for x0 in range(16, fg.shape[2], 16):
            for b in range(len(fg)):
                if fg[b, y0 - 1, x0 - 1] and fg[b, y0, x0]:
                    assert labels[b, y0, x0] == labels[b, y0 - 1, x0 - 1]
                if fg[b, y0 - 1, x0] and fg[b, y0, x0 - 1]:
                    assert labels[b, y0, x0 - 1] == labels[b, y0 - 1, x0]


@pytest.mark.parametrize("tile", [None, (4, 8), (1, 1)])
def test_emulated_propagate_min_matches_pallas(tile):
    rng = np.random.default_rng(4)
    fg = rng.random((2, 40, 48)) > 0.45
    sentinel = 40 * 48
    seeds = np.where(fg, rng.integers(0, sentinel, fg.shape), sentinel
                     ).astype(np.int32)
    th, tw = tile or cc_kernel.tile_plan(*fg.shape)[:2]
    emu = _Emulation(fg, th, tw, seeds=seeds)
    emu.run()
    want = np.asarray(propagate_min_pallas(jnp.asarray(seeds),
                                           sentinel=sentinel, interpret=True))
    np.testing.assert_array_equal(emu.region_min, want)
    np.testing.assert_array_equal(cc_kernel.propagate_min_plain(
        torch.from_numpy(seeds), sentinel).numpy(), want)


def _jax_exact_tables(lbl, region):
    """``_region_predicate_exact``'s area and touch tables of one image."""
    h, w = lbl.shape
    size = h * w
    flat = lbl.reshape(-1)
    area = jnp.zeros((size + 1,), jnp.int32).at[flat].add(
        region.reshape(-1).astype(jnp.int32))
    border = jnp.concatenate([lbl[0], lbl[-1], lbl[:, 0], lbl[:, -1]])
    touch = jnp.zeros((size + 1,), jnp.bool_).at[border].set(True)
    return np.asarray(area[:size]), np.asarray(touch[:size])


@pytest.mark.parametrize("case", ["organ", "speckle", "ring", "many-blobs"])
def test_stats_plain_tables_match_jax_exact_tables(case):
    from test_torch_port_postprocess import _case_mask

    masks = np.stack([_case_mask(case, 64), _case_mask("organ", 64)])
    h, w = masks.shape[1:]
    min_area = postprocess.min_area_threshold(h, w)
    for region in (masks != 2, masks == 2):
        lbl, stats = cc_kernel.cc_label_stats_plain(torch.from_numpy(region))
        stats = stats.reshape(len(masks), h * w + 1)
        for b in range(len(masks)):
            jl = jax_cc.cc_label(jnp.asarray(region[b]))
            np.testing.assert_array_equal(lbl[b].numpy(), np.asarray(jl))
            area, touch = _jax_exact_tables(jl, jnp.asarray(region[b]))
            np.testing.assert_array_equal(
                cc_kernel.stats_area(stats[b, :-1]).numpy(), area)
            np.testing.assert_array_equal(
                cc_kernel.stats_touch(stats[b, :-1]).numpy(), touch)
        # The port's one-gather predicate is JAX's, in both modes.
        for hole, mode in ((True, "hole"), (False, "keep")):
            got = postprocess._region_predicate(
                lbl, stats.reshape(-1), torch.from_numpy(region), min_area,
                hole)
            want = np.stack([np.asarray(jax_pp._region_predicate_exact(
                jnp.asarray(lbl[b].numpy()), jnp.asarray(region[b]),
                min_area, mode)) for b in range(len(masks))])
            np.testing.assert_array_equal(got.numpy(), want)


def test_stats_wrapper_on_cpu_runs_plain_and_counts_nothing():
    fg = torch.from_numpy(np.random.default_rng(3).random((2, 20, 30)) > 0.5)
    graphs.reset_launches()
    got_l, got_s = cc_kernel.cc_label_stats(fg)
    want_l, want_s = cc_kernel.cc_label_stats_plain(fg)
    assert torch.equal(got_l, want_l) and torch.equal(got_s, want_s)
    assert torch.equal(got_l, cc.cc_label(fg))
    assert got_s.shape == (2 * (600 + 1),) and got_s.dtype == torch.int32
    assert cc_kernel.LAUNCHES == {"cc_label": 0, "propagate_min": 0}
    with pytest.raises(ValueError, match="bool"):
        cc_kernel.cc_label_stats(fg.to(torch.uint8))
