"""The K6 kernel's tile plan (ops/dec1.py ``tile_plan``), on the CPU.

The kernel itself runs only on the card; what it does with a plan is
emulated here in plain torch, tile by tile: the skip and x planes as TMA
lands them (zeros outside the tensor; the slack rows past each plane are
NaN, so a valid output that read them would show it), the up-GEMM with its
sub-pixel scatter into the up plane (zero outside the image), conv1 and
conv2 on the flat IN_W-wide grid with each tap a row offset into the flat
plane and the wrap columns dropped (NaN in c1: no kept output reads
them), c1 zeroed outside the image, then the
f32 head and the first-max argmax.  In float32 the emulation must give the
plain version's classes bit for bit; in bf16, rounding at the kernel's
points, the same classes except near ties (``dec1.near_tie``).
"""

import os
import re

import numpy as np
import pytest
import torch

from unetseg_tpu_torch.ops import dec1
from unetseg_tpu_torch.ops.decode import decode_mask

SIZES = [(512, 512), (50, 38), (34, 66), (64, 96), (8, 6), (2, 2)]


def _plane(img, b, r0, c0, rows, cols, total):
    """img[b, r0:r0+rows, c0:c0+cols] flattened to (total, C) rows: zeros
    where the box leaves the tensor (TMA's fill), NaN past rows * cols."""
    _, H, W, C = img.shape
    box = img.new_zeros((rows, cols, C))
    rs, rt = max(r0, 0), min(r0 + rows, H)
    cs, ct = max(c0, 0), min(c0 + cols, W)
    if rs < rt and cs < ct:
        box[rs - r0:rt - r0, cs - c0:ct - c0] = img[b, rs:rt, cs:ct]
    out = img.new_full((total, C), float("nan"))
    out[:rows * cols] = box.reshape(-1, C)
    return out


def _conv_flat(plane, w, rows, in_w):
    """sum over taps of plane[q + dy * in_w + dx] @ w[dy, dx] for q < rows:
    the kernel's taps as row offsets into the flat plane, in f32."""
    acc = torch.zeros((rows, w.shape[3]))
    for dy in range(3):
        for dx in range(3):
            s = dy * in_w + dx
            acc += plane[s:s + rows].float() @ w[dy, dx].float()
    return acc


def emulate(x, skip, up_w, up_b, w1, b1, w2, b2, wh, bh, plan):
    """The kernel's arithmetic under ``plan``, rounding to skip's dtype at
    its points; returns the uint8 classes (N, H, W)."""
    N, H, W, C = skip.shape
    dt = skip.dtype
    g = dec1.geometry(C, plan.th, plan.tw, plan.stages)
    in_w, in_h = g["in_w"], g["in_h"]
    x_w, x_h = in_w // 2, in_h // 2
    in_rows, c1_rows = in_h * in_w + 2, g["m1"] + 2  # two rows of slack
    out = torch.full((N, H, W), 255, dtype=torch.uint8)
    for b in range(N):
        for th in range(plan.tiles_h):
            for tw in range(plan.tiles_w):
                h0, w0 = th * plan.th, tw * plan.tw
                # The x plane and the up-GEMM.
                xp = _plane(x, b, h0 // 2 - 1, w0 // 2 - 1, x_h, x_w,
                            g["mx"])
                acc = xp.float() @ up_w.float()
                up = torch.full((in_rows, C), float("nan"), dtype=dt)
                for m in range(g["mx"]):
                    xi, xj = divmod(m, x_w)
                    for q in range(4):
                        ui, uj = 2 * xi + q // 2, 2 * xj + q % 2
                        r, c = h0 - 2 + ui, w0 - 2 + uj
                        v = acc[m, q * C:(q + 1) * C] + up_b.float()
                        up[ui * in_w + uj] = (v if 0 <= r < H and 0 <= c < W
                                              else 0 * v).to(dt)
                sk = _plane(skip, b, h0 - 2, w0 - 2, in_h, in_w, in_rows)
                # conv1 on the (th + 2) x in_w grid, c1 zero outside.
                a1 = _conv_flat(torch.cat([sk, up], 1), w1, g["m1"], in_w)
                c1 = torch.full((c1_rows, C), float("nan"), dtype=dt)
                for q in range(g["m1"]):
                    r1, cc = divmod(q, in_w)
                    r, c = h0 - 1 + r1, w0 - 1 + cc
                    if cc >= plan.tw + 2:  # wrap columns: the kernel's are
                        continue           # left as computed; NaN here
                    ok = 0 <= r < H and 0 <= c < W
                    c1[q] = (torch.relu(a1[q] + b1.float()) if ok
                             else torch.zeros(C)).to(dt)
                # conv2 on the th x in_w grid, the head and the argmax.
                a2 = _conv_flat(c1, w2, g["m2"], in_w)
                c2 = torch.relu(a2 + b2.float()).to(dt)
                logits = c2.float() @ wh.float() + bh.float()
                cls = decode_mask(logits, wh.shape[1])
                for q in range(g["m2"]):
                    r2, cc = divmod(q, in_w)
                    r, c = h0 + r2, w0 + cc
                    if cc < plan.tw and r < H and c < W:
                        out[b, r, c] = cls[q]
    return out


def _operands(n, h, w, c, k, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, relu=False):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(np.maximum(a, 0) if relu else a).to(dtype)

    return [t(n, h // 2, w // 2, 2 * c, relu=True), t(n, h, w, c, relu=True),
            t(2 * c, 4 * c, scale=(2 * c) ** -0.5), t(c, scale=0.1),
            t(3, 3, 2 * c, c, scale=(1 / (9 * c)) ** 0.5), t(c, scale=0.1),
            t(3, 3, c, c, scale=(2 / (9 * c)) ** 0.5), t(c, scale=0.1),
            t(c, k, scale=c ** -0.5), t(k, scale=0.1)]


@pytest.mark.parametrize("c", dec1.KERNEL_CHANNELS)
def test_plan_invariants(c):
    for h, w in SIZES:
        for batch in (1, 3, 32):
            p = dec1.tile_plan(batch, h, w, c)
            g = dec1.geometry(c, p.th, p.tw, p.stages)
            assert p.th % 2 == 0 and p.tw % 2 == 0 and p.th >= 2
            assert p.in_w == p.tw + 4 and p.in_w <= 256 and p.th + 4 <= 256
            assert p.smem == g["smem"] <= dec1.SMEM_LIMIT
            assert 2 <= p.stages <= dec1.MAX_STAGES
            assert c % p.bkc == 0 and (2 * c) % p.bkx == 0
            assert p.bkc in (16, 32, 64) and p.bkx in (16, 32, 64)
            assert p.n_pad % 64 == 0 and c <= p.n_pad < c + 64
            # wgmma N: the two warpgroups split each conv grid; N <= 256 in
            # multiples of 8, and each thread's accumulators fit 128 floats.
            assert 2 * p.n_c1 == (p.th + 2) * p.in_w
            assert 2 * p.n_c2 == p.th * p.in_w
            assert p.n_x == (p.th + 4) * p.in_w // 4
            for n in (p.n_c1, p.n_c2, p.n_x):
                assert n % 8 == 0 and n <= 256
            assert p.n_pad // 64 * p.n_c1 // 2 <= dec1.ACC_FLOATS
            pieces = -(-4 * c // 64 // dec1.CONSUMERS)
            assert pieces * p.n_x // 2 <= dec1.ACC_FLOATS
            # Tiles cover each axis, with no empty tile.
            for n, t, size in ((h, p.tiles_h, p.th), (w, p.tiles_w, p.tw)):
                assert (t - 1) * size < n <= t * size
            assert p.grid == batch * p.tiles_h * p.tiles_w < 2 ** 31


def test_flagship_plan():
    """C = 64 at 512²: 12 x 28 tiles on 32-pixel planes, four 8 KB slots;
    conv1 on 448 and conv2 on 384 grid rows per 336 outputs, m64n224 and
    m64n192 per warpgroup, the up-GEMM m64n128."""
    p = dec1.tile_plan(32, 512, 512, 64)
    assert (p.th, p.tw, p.in_w, p.stages, p.n_x, p.n_c1, p.n_c2) == \
        (12, 28, 32, 4, 128, 224, 192)
    assert p.smem == 228208 and p.grid == 32 * 43 * 19


def test_kernel_tile_table_is_the_plan():
    """dec1_fused.cu's TILES table, which its entry point holds every plan
    to, is what tile_plan chooses for each C."""
    src = open(os.path.join(os.path.dirname(dec1.SOURCE),
                            "dec1_fused.cu")).read()
    table = src[src.index("TILES[6][4] = {"):src.index("};", src.index(
        "TILES[6][4] = {"))]
    rows = {int(c): (int(th), int(tw), int(st)) for c, th, tw, st in
            re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\}", table)}
    assert rows == {c: dec1._tile_shape(c) for c in dec1.KERNEL_CHANNELS}


@pytest.mark.parametrize("c", dec1.KERNEL_CHANNELS)
@pytest.mark.parametrize("hw", [(50, 38), (8, 6)], ids=str)
def test_tiles_cover_each_output_once(c, hw):
    h, w = hw
    p = dec1.tile_plan(2, h, w, c)
    count = torch.zeros((2, h, w), dtype=torch.int32)
    for t in range(p.grid):  # the kernel's blockIdx.x decomposition
        tw, t = t % p.tiles_w, t // p.tiles_w
        th, b = t % p.tiles_h, t // p.tiles_h
        count[b, th * p.th:(th + 1) * p.th, tw * p.tw:(tw + 1) * p.tw] += 1
    assert torch.equal(count, torch.ones_like(count))


@pytest.mark.parametrize("case", [
    (1, 50, 38, 64, 3),   # ragged last tile both ways
    (2, 8, 6, 16, 5),     # H and W smaller than one tile
    (1, 34, 66, 96, 2),   # C = 96: N padded to 128, 32-channel rows
    (1, 30, 30, 48, 8),   # C = 48: 16-channel rows, 8 classes
    (3, 14, 28, 32, 1),   # B = 3, K = 1, one whole tile per image
    (1, 26, 20, 80, 4),   # C = 80
], ids=str)
def test_emulated_walk_equals_plain_f32(case):
    n, h, w, c, k = case
    ops = _operands(n, h, w, c, k, torch.float32, sum(case))
    got = emulate(*ops, dec1.tile_plan(n, h, w, c))
    want = dec1.dec1_fused_plain(*ops)
    if k > 1:
        assert len(torch.unique(want)) > 1  # not vacuous
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [(1, 50, 38, 64, 3), (2, 10, 34, 16, 3)],
                         ids=str)
def test_emulated_walk_equals_plain_bf16(case):
    n, h, w, c, k = case
    ops = _operands(n, h, w, c, k, torch.bfloat16, sum(case) + 1)
    got = emulate(*ops, dec1.tile_plan(n, h, w, c))
    want = dec1.dec1_fused_plain(*ops)
    tie = dec1.near_tie(dec1.dec1_head_input_plain(*ops[:8]), ops[8], ops[9])
    differ = got != want
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    assert differ.float().mean() < 0.01


@pytest.mark.parametrize("args", [(1, 8, 8, 8), (1, 8, 8, 112), (1, 9, 8, 64),
                                  (1, 8, 7, 64), (0, 8, 8, 64)], ids=str)
def test_plan_rejects_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError, match="dec1 tile plan"):
        dec1.tile_plan(*args)
