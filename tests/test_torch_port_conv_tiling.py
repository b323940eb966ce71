"""The conv kernel's tile plan (ops/conv.py ``tile_plan``), on the CPU.

The kernel itself runs only on the card; what it does with a plan is
emulated here in plain torch: walk the plan's tiles, for each tile the 9
taps and the channel boxes, read each box as TMA does (zeros outside the
tensor, negative coordinates included; with the dx fold one box of wt + 2
columns per row of taps, read as three views one column apart),
multiply-add in f32, then bias, ReLU and the masked store.  The emulation
must equal the plain conv in f32 to 1e-5 on ragged shapes, and the plan
must hold its invariants on every conv shape the port serves or
``chip_smoke.py`` checks.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from unetseg_tpu_torch import _build
from unetseg_tpu_torch.ops import conv

# (H, W, C, D) of every shape the card sees: slim4, the flagship (C = 1 and
# a stem-2 C = 4 reach the kernel padded to 16), UNet++ and Attention U-Net
# at full width, the extra and edge parity shapes of chip_smoke.py.
SHAPES = sorted({(h, w, c + -c % 16, d) for h, w, c, d in (
    chip_smoke.SLIM4_CONVS + chip_smoke.FLAGSHIP_CONVS
    + chip_smoke.UNETPP_CONVS + chip_smoke.ATTENTION_CONVS
    + [chip_smoke.STEM2_CONV] + chip_smoke.EXTRA_CONVS
    + chip_smoke.EDGE_CONVS)})
BATCHES = (1, 3, 32, 128)


def _box(x, b, h, w, c0, rt, wt, bkc):
    """x[b, h:h+rt, w:w+wt, c0:c0+bkc] with zeros wherever the box leaves
    the tensor, as a TMA tiled load fills them."""
    _, H, W, _ = x.shape
    out = x.new_zeros((rt, wt, bkc))
    hs, he, ws, we = max(h, 0), min(h + rt, H), max(w, 0), min(w + wt, W)
    if hs < he and ws < we:
        out[hs - h:he - h, ws - w:we - w] = x[b, hs:he, ws:we, c0:c0 + bkc]
    return out


def emulate(x, w, bias, relu, plan):
    """The kernel's arithmetic under ``plan``, tile by tile, in x's dtype."""
    B, H, W, C = x.shape
    D = w.shape[3]
    wk = w.reshape(9 * C, D)
    out = torch.full((B, H, W, D), float("nan"), dtype=x.dtype)
    for b in range(B):
        for th in range(plan.tiles_h):
            for tw in range(plan.tiles_w):
                for tn in range(plan.tiles_n):
                    h0, w0, n0 = th * plan.rt, tw * plan.wt, tn * plan.bn
                    acc = x.new_zeros((conv.TILE_PIXELS, plan.bn))
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        for c0 in range(0, C, plan.bkc):
                            if plan.fold:  # the dy row's box, dx's view
                                a = _box(x, b, h0 + dy - 1, w0 - 1, c0,
                                         plan.rt, plan.wt + 2, plan.bkc
                                         )[:, dx:dx + plan.wt]
                            else:
                                a = _box(x, b, h0 + dy - 1, w0 + dx - 1, c0,
                                         plan.rt, plan.wt, plan.bkc)
                            wb = x.new_zeros((plan.bkc, plan.bn))
                            cols = wk[tap * C + c0:tap * C + c0 + plan.bkc,
                                      n0:n0 + plan.bn]
                            wb[:, :cols.shape[1]] = cols
                            acc += a.reshape(-1, plan.bkc) @ wb
                    bb = x.new_zeros(plan.bn)
                    bb[:min(plan.bn, D - n0)] = bias[n0:n0 + plan.bn]
                    y = (acc + bb).reshape(plan.rt, plan.wt, plan.bn)
                    if relu:
                        y = torch.relu(y)
                    he, we = min(h0 + plan.rt, H), min(w0 + plan.wt, W)
                    ne = min(n0 + plan.bn, D)
                    out[b, h0:he, w0:we, n0:ne] = \
                        y[:he - h0, :we - w0, :ne - n0]
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_invariants(shape):
    h, w, c, d = shape
    for batch in BATCHES:
        p = conv.tile_plan(batch, h, w, c, d)
        assert p.rt * p.wt == conv.TILE_PIXELS
        assert p.wt & (p.wt - 1) == 0 and (p.wt >= w or p.wt == 128)
        assert c % p.bkc == 0 and p.bkc in (16, 32, 64)
        assert p.swizzle == 2 * p.bkc  # one swizzle row per pixel
        assert p.bn in (64, 128, 256) and d % 16 == 0
        assert p.bn != 256 or p.bkc == 64
        # The fold's warpgroup halves (64 pixels) each lie in one image row.
        assert p.fold == (p.wt >= 64 and p.bn <= 128)
        # TMA: box dims <= 256, global strides multiples of 16 bytes.
        assert max(p.bkc, p.wt + 2 * p.fold, p.rt, 64) <= 256
        assert (2 * c) % 16 == 0 and (2 * d) % 16 == 0
        # Tiles cover each axis exactly once, with no empty tile.
        for n, t, size in ((h, p.tiles_h, p.rt), (w, p.tiles_w, p.wt),
                           (d, p.tiles_n, p.bn)):
            assert (t - 1) * size < n <= t * size
        assert p.grid == batch * p.tiles_h * p.tiles_w * p.tiles_n < 2 ** 31


@pytest.mark.parametrize("shape", [(3, 7, 32, 48, 112), (2, 19, 300, 16, 48),
                                   (3, 3, 20, 80, 64), (1, 1, 1, 16, 16),
                                   (2, 37, 53, 96, 144)], ids=str)
def test_tiles_cover_each_output_once(shape):
    B, H, W, C, D = shape
    p = conv.tile_plan(B, H, W, C, D)
    count = torch.zeros((B, H, W, D), dtype=torch.int32)
    for t in range(p.grid):  # the kernel's blockIdx.x decomposition
        tn, t = t % p.tiles_n, t // p.tiles_n
        tw, t = t % p.tiles_w, t // p.tiles_w
        th, b = t % p.tiles_h, t // p.tiles_h
        count[b, th * p.rt:(th + 1) * p.rt, tw * p.wt:(tw + 1) * p.wt,
              tn * p.bn:(tn + 1) * p.bn] += 1
    assert torch.equal(count, torch.ones_like(count))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [
    (3, 7, 32, 48, 112),   # H = 7 over two 4-row tiles; C = 48 -> bkc 16
    (3, 3, 20, 80, 64),    # H below rt; W < wt; C = 80
    (3, 5, 150, 96, 80),   # two column tiles, the second ragged; C = 96
    (3, 9, 13, 16, 144),   # D not a multiple of bn; C = 16
    (1, 2, 1, 128, 16),    # W = 1: wt = 1, rt = 128; two C chunks
    (2, 3, 100, 64, 256),  # fold at wt = 128, bn = 256
    (2, 5, 40, 128, 80),   # fold at wt = 64, rt = 2, ragged W; two chunks
    (2, 6, 20, 192, 272),  # no fold (wt = 32), bn = 256, D ragged
    # the model zoo's new K1 shapes, cut in H and W: D = 64 (bn = 64) with
    # the fold at wt = 128 over 3 and 5 64-channel slices (C = 192, 320);
    # C = 384 and 768 at bn = 128 and 256
    (1, 3, 130, 192, 64),
    (1, 2, 128, 320, 64),
    (1, 5, 70, 384, 128),
    (1, 4, 12, 768, 256),
], ids=str)
def test_emulated_plan_equals_plain(shape, relu):
    B, H, W, C, D = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, C, D))
                          / np.sqrt(9 * C)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(D).astype(np.float32) * 0.1)
    got = emulate(x, w, b, relu, conv.tile_plan(B, H, W, C, D))
    want = conv.conv3x3_bias_act_plain(x, w, b, relu=relu)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("args", [(1, 4, 4, 8, 16), (1, 4, 4, 16, 24),
                                  (0, 4, 4, 16, 16)], ids=str)
def test_plan_rejects_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        conv.tile_plan(*args)


def test_parse_ptxas():
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120"
        "conv3x3_wgmma_kernelILi64ELi128EEEv14CUtensorMap_stS1_' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_120conv3x3"
        "_wgmma_kernelILi64ELi128EEEv14CUtensorMap_stS1_\n"
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 112 registers, 16 bytes smem, 900 bytes cmem[0]\n")
    (name, info), = _build.parse_ptxas(log).items()
    assert "ILi64ELi128E" in name
    assert info == {"registers": 112, "spill_bytes": 12, "smem_static": 16}
