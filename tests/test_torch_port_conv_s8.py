"""K7's tiling (``ops/conv_s8.tile_plan_s8``), a numpy emulation of its walk
and of its two epilogues (``csrc/conv3x3_s8.cu``), and the int8 flow's
identities, on the CPU.

The emulation follows the wrapper and the kernel: C zero-padded to a
multiple of 32; tiles of 128 pixels (``rt`` image rows x ``wt`` columns) by
``bn`` channels; per A box (one tap, or with the dx fold one row of taps) a
TMA load that fills zeros outside the tensor; each warpgroup's 64 pixel
rows read as a view that starts ``row0 + dx`` rows into the box; the
K-major weights read as the kernel's 3-D tensor map over (C, D, 9), zeros
past D; products in k32 slices
into int32 sums; the masked store.  Its sums must equal the plain version's
bit for bit (integer arithmetic leaves no tolerance).  The epilogues'
arithmetic (``float(acc) * scale + bias``, ReLU, then ``rint(y / s)``
clipped to +-127) is emulated with numpy's IEEE float32 operations and held
bit for bit against ``conv3x3_s8_q_plain`` and JAX's ``_quant_act`` of
``_conv_w8a8``, on inputs built to land on exact .5 quotients and on both
clamps.  The kernel itself runs only on the card (``chip_smoke.py`` phase
21)."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unetseg_tpu import quantize as jq
from unetseg_tpu_torch import graphs
from unetseg_tpu_torch.models.unet import max_pool_2x2
from unetseg_tpu_torch.ops import conv, conv_s8


def _box(x, b, h, w, c0, rows, cols, bkc):
    """x[b, h:h+rows, w:w+cols, c0:c0+bkc] with zeros wherever the box
    leaves the tensor, as a TMA tiled load fills them."""
    _, H, W, _ = x.shape
    out = np.zeros((rows, cols, bkc), np.int64)
    hs, he, ws, we = max(h, 0), min(h + rows, H), max(w, 0), min(w + cols, W)
    if hs < he and ws < we:
        out[hs - h:he - h, ws - w:we - w] = x[b, hs:he, ws:we, c0:c0 + bkc]
    return out


def _emulate_acc(x, wk):
    """The wrapper's padding and the kernel's int32 sums under
    ``tile_plan_s8``, tile by tile: x (B,H,W,C) and K-major wk (3,3,D,C)
    int8 numpy arrays."""
    extra = -x.shape[3] % 32  # the wrapper's zero channels
    x = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, extra)))
    wk = np.pad(wk, ((0, 0), (0, 0), (0, 0), (0, extra)))
    B, H, W, C = x.shape
    D = wk.shape[2]
    p = conv_s8.tile_plan_s8(B, H, W, C, D)
    wmap = wk.reshape(9, D, C)  # the (C, D, 9) tensor map, innermost first
    taps, chunks = (3 if p.fold else 1), C // p.bkc
    # Box row where warpgroup g's 64 pixels start (dx = 0).
    row0 = [64 * g // p.wt * (p.wt + 2) + 64 * g % p.wt if p.fold
            else 64 * g for g in (0, 1)]
    out = np.zeros((B, H, W, D), np.int64)
    seen = np.zeros((B, H, W, D), bool)
    for t in range(p.grid):  # the kernel's blockIdx.x decomposition
        tn, t = t % p.tiles_n, t // p.tiles_n
        tw, t = t % p.tiles_w, t // p.tiles_w
        th, b = t % p.tiles_h, t // p.tiles_h
        h0, w0, n0 = th * p.rt, tw * p.wt, tn * p.bn
        n = min(p.bn, D - n0)
        acc = np.zeros((128, p.bn), np.int64)
        for ia in range(9 // taps * chunks):
            tap0, c0 = ia // chunks * taps, ia % chunks * p.bkc
            box = _box(x, b, h0 + tap0 // 3 - 1,
                       w0 - 1 + (0 if p.fold else tap0 % 3), c0, p.rt,
                       p.wt + (2 if p.fold else 0), p.bkc).reshape(-1, p.bkc)
            for dx in range(taps):
                rows = np.concatenate([np.arange(r + dx, r + dx + 64)
                                       for r in row0])
                a = box[rows]
                bt = np.zeros((p.bn, p.bkc), np.int64)
                bt[:n] = wmap[tap0 + dx, n0:n0 + n, c0:c0 + p.bkc]
                for k in range(0, p.bkc, 32):  # one wgmma k32 slice each
                    acc += a[:, k:k + 32] @ bt[:, k:k + 32].T
        assert (np.abs(acc) < 2 ** 31).all()  # int32 accumulators
        y = acc[:, :n].reshape(p.rt, p.wt, n)
        he, we = min(h0 + p.rt, H), min(w0 + p.wt, W)
        out[b, h0:he, w0:we, n0:n0 + n] = y[:he - h0, :we - w0]
        seen[b, h0:he, w0:we, n0:n0 + n] = True
    assert seen.all()  # every output written by a tile
    return out


def _epilogue(acc, scale, bias, relu, out_scales):
    """The kernel's epilogues in numpy float32: y = float(acc) * scale +
    bias (two roundings, no FMA), ReLU; then per scale rint(y / s), a true
    division rounded half to even, clipped to +-127."""
    y = acc.astype(np.float32) * scale + bias
    if relu:
        y = np.maximum(y, np.float32(0))
    return y, [np.clip(np.rint(y / np.float32(s)), -127, 127).astype(np.int8)
               for s in out_scales]


def _operands(shape, seed, lo=-127, hi=128):
    B, H, W, C, D = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(lo, hi, (B, H, W, C)).astype(np.int8)
    wk = rng.integers(lo, hi, (3, 3, D, C)).astype(np.int8)
    return x, wk


@pytest.mark.parametrize("shape", [
    (2, 5, 37, 16, 80),      # C = 16, padded to 32; fold at wt = 64
    (1, 3, 4, 48, 16),       # wt = 4, rt = 32; C 48 padded to 64
    (3, 9, 14, 64, 112),     # bkc 64, bn 128, D ragged in the tile; unfolded
    (2, 11, 12, 128, 64),    # bkc 128, bn 64; ragged H
    (1, 3, 150, 32, 144),    # fold at wt = 128, 2 column tiles, D 144
    (1, 6, 20, 256, 256),    # bn 256 (unfolded), 2 chunks of 128
    (2, 4, 64, 80, 48),      # fold at wt = 64 exactly; C 80 -> 3 x 32
    (1, 2, 1, 192, 16),      # W = 1: wt = 1, rt = 128; bkc 64
])
def test_k7_walk_matches_the_plain_sums(shape):
    """The emulated walk (padded channels, boxes, fold views, K-major B,
    k32 slices, ragged edges) gives the plain version's int32 sums bit for
    bit, on full-range int8 operands."""
    x, wk = _operands(shape, sum(shape))
    want = conv_s8.conv3x3_s8_acc_plain(torch.from_numpy(x),
                                        torch.from_numpy(wk)).numpy()
    np.testing.assert_array_equal(_emulate_acc(x, wk), want)


def _tie_case():
    """Operands and scales whose quotients y / s land on exact .5 values
    and past both clamps: small integer operands, power-of-two channel
    scales, biases of .25 and .5 (every product and sum exact in float32),
    and out scales 1, 0.5 and 0.01 (the last saturates)."""
    shape = (2, 6, 7, 16, 32)
    x, wk = _operands(shape, 7, -3, 4)
    d = shape[4]
    scale = (np.float32(2.0) ** -(np.arange(d) % 3)).astype(np.float32)
    bias = np.where(np.arange(d) % 2, 0.5, -0.25).astype(np.float32)
    return x, wk, scale, bias, [np.float32(1.0), np.float32(0.5),
                                np.float32(0.01)]


@pytest.mark.parametrize("relu", [True, False])
def test_q_epilogue_bit_equal_on_ties_and_clamps(relu):
    """``conv3x3_s8_q_plain`` against the numpy model of the kernel's int8
    epilogue and against JAX's ``_quant_act(_conv_w8a8(...))`` (act scale
    1, so JAX's quantize of the int8 input is the identity), bit for bit,
    on quotients that are exact .5 ties (rounded half to even) and on
    values past both clamps."""
    x, wk, scale, bias, out_scales = _tie_case()
    acc = _emulate_acc(x, wk)
    y, want = _epilogue(acc, scale, bias, relu, out_scales)
    quot = np.stack([y / s for s in out_scales])
    assert ((quot - np.floor(quot)) == 0.5).sum() > 100  # ties exercised
    assert (quot > 127.5).any()
    if not relu:
        assert (quot < -127.5).any()
    t = torch.from_numpy
    got = conv_s8.conv3x3_s8_q_plain(t(x), t(wk), t(scale), t(bias),
                                     [torch.tensor(s) for s in out_scales],
                                     relu)
    site = {"w_q": jnp.asarray(wk.transpose(0, 1, 3, 2)),
            "w_scale": jnp.asarray(scale), "b": jnp.asarray(bias),
            "act_scale": jnp.float32(1.0)}
    y_jax = jq._conv_w8a8(jnp.asarray(x, jnp.float32), site, relu=relu)
    np.testing.assert_array_equal(np.asarray(y_jax), y)
    for s, g, w in zip(out_scales, got, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(
            np.asarray(jq._quant_act(y_jax, jnp.float32(s))), w)
    # The f32 epilogue is the same y.
    np.testing.assert_array_equal(conv_s8.conv3x3_s8_plain(
        t(x), t(wk), t(scale), t(bias), relu).numpy(), y)


def test_q_plain_matches_jax_on_random_operands():
    """Full-range operands and calibrated-size scales: one and two out
    scales, each JAX's quantize of JAX's conv output, bit for bit."""
    shape = (2, 8, 9, 48, 32)
    x, wk = _operands(shape, 3)
    rng = np.random.default_rng(4)
    scale = (rng.random(shape[4]) * 1e-3 + 1e-5).astype(np.float32)
    bias = rng.standard_normal(shape[4]).astype(np.float32)
    t = torch.from_numpy
    y = conv_s8.conv3x3_s8_plain(t(x), t(wk), t(scale), t(bias))
    amax = float(y.abs().max())
    scales = [torch.tensor(np.float32(amax / 127)),
              torch.tensor(np.float32(amax / 300))]
    site = {"w_q": jnp.asarray(wk.transpose(0, 1, 3, 2)),
            "w_scale": jnp.asarray(scale), "b": jnp.asarray(bias),
            "act_scale": jnp.float32(1.0)}
    y_jax = jq._conv_w8a8(jnp.asarray(x, jnp.float32), site)
    for n in (1, 2):
        got = conv_s8.conv3x3_s8_q_plain(t(x), t(wk), t(scale), t(bias),
                                         scales[:n])
        assert len(got) == n
        for s, g in zip(scales, got):
            want = np.asarray(jq._quant_act(y_jax, jnp.float32(s.item())))
            np.testing.assert_array_equal(g.numpy(), want)
            assert torch.equal(g, conv_s8.quant_act(y, s))


def _rn32(v):
    """The Fraction ``v`` rounded to the nearest float32, ties to even
    (normal range), as a Fraction."""
    if v == 0:
        return Fraction(0)
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    while a >= Fraction(2) ** (e + 1):
        e += 1
    while a < Fraction(2) ** e:
        e -= 1
    scaled = a / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    n = scaled.numerator // scaled.denominator
    rem = scaled - n
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2):
        n += 1
    return (1 if v > 0 else -1) * n * Fraction(2) ** (e - 23)


def _kernel_div(y, s):
    """The int8 epilogue's ``div_rn`` in exact arithmetic, each operation
    rounded once to float32 as the card's ``__frcp_rn``, ``__fmul_rn`` and
    ``__fmaf_rn`` round it: r = RN(1/s), q0 = RN(y r), then two FMA
    residual steps."""
    y, s = Fraction(float(y)), Fraction(float(s))
    r = _rn32(1 / s)
    q = _rn32(y * r)
    for _ in range(2):
        q = _rn32(_rn32(y - s * q) * r + q)
    return q


def test_epilogue_division_is_ieee_division():
    """The kernel's reciprocal-and-FMA division gives IEEE float32 division's
    result bit for bit (numpy's ``y / s`` in float32, and the exactly
    rounded quotient) on quotients at and around every half-integer the
    int8 rounding turns on (-127.5 .. 127.5, up to 3 ulps either side),
    for scales over fifteen decades and the awkward mantissas (all ones,
    powers of two), and on random quotients; so its ``rint`` and clip are
    ``quant_act``'s."""
    rng = np.random.default_rng(12)
    scales = np.concatenate([
        np.float32(10.0) ** rng.uniform(-12, 3, 10),
        np.array([1.0, 0.5, 2.0 ** -20, np.nextafter(np.float32(2), 0),
                  np.nextafter(np.float32(1), 2), 3.0, 1 / 127],
                 np.float32)]).astype(np.float32)
    ks = np.concatenate([np.arange(-128, 129, 17), [-128, -127, 126, 127]])
    checked = 0
    for s in scales:
        ys = []
        for k in ks:
            y = np.float32(s * np.float32(k + 0.5))
            for _ in range(3):
                y = np.nextafter(y, np.float32(-np.inf))
            for _ in range(7):
                ys.append(y)
                y = np.nextafter(y, np.float32(np.inf))
        ys += list((rng.standard_normal(20) * 100 * s).astype(np.float32))
        for y in ys:
            got = _kernel_div(y, s)
            want = np.float32(y) / np.float32(s)
            assert got == Fraction(float(want)) == _rn32(
                Fraction(float(y)) / Fraction(float(s))), (y, s)
            q = np.clip(np.rint(float(got)), -127, 127)
            assert q == np.clip(np.rint(want), -127, 127)
            checked += 1
    assert checked > 2500


def test_int8_pool_equals_quantized_pool():
    """Max-pooling the int8 tensor equals quantizing the max-pooled f32
    one (the quantize is non-decreasing), on values at .5 ties and past
    the clamps, and on a K7 output."""
    rng = np.random.default_rng(9)
    y = (rng.integers(-600, 600, (2, 8, 10, 32)) / 2.0).astype(np.float32)
    y = torch.from_numpy(y)
    for s in (torch.tensor(1.0), torch.tensor(0.5), torch.tensor(3.0)):
        assert torch.equal(max_pool_2x2(conv_s8.quant_act(y, s)),
                           conv_s8.quant_act(max_pool_2x2(y), s))
    x, wk = _operands((2, 8, 6, 16, 16), 5)
    t = torch.from_numpy
    scale, bias = torch.rand(16) * 1e-3, torch.randn(16)
    s = torch.tensor(0.05)
    (q,) = conv_s8.conv3x3_s8_q_plain(t(x), t(wk), scale, bias, [s])
    assert torch.equal(max_pool_2x2(q), conv_s8.quant_act(max_pool_2x2(
        conv_s8.conv3x3_s8_plain(t(x), t(wk), scale, bias)), s))


def test_wrapper_cpu_route_and_refusals():
    """On the CPU both entries run their plain versions and count no
    launch; the scales are checked; the kernel's own path refuses a CPU
    tensor instead of falling back."""
    x, wk = _operands((1, 4, 5, 16, 16), 2)
    x, wk = torch.from_numpy(x), torch.from_numpy(wk)
    scale, bias, s = torch.rand(16), torch.randn(16), torch.tensor(0.5)
    graphs.reset_launches()
    assert torch.equal(conv_s8.conv3x3_s8_q(x, wk, scale, bias, [s, s])[1],
                       conv_s8.quant_act(conv_s8.conv3x3_s8_plain(
                           x, wk, scale, bias), s))
    assert conv_s8.LAUNCHES["conv3x3_s8"] == 0
    for bad in ([], [s, s, s], [s.double()], [torch.ones(2)]):
        with pytest.raises(ValueError, match="out.scale"):
            conv_s8.conv3x3_s8_q(x, wk, scale, bias, bad)
    with pytest.raises(ValueError, match="unsupported device"):
        conv_s8._launch(x, wk, scale, bias, [s], True)


def test_tile_plan_s8_choices_and_refusals():
    p = conv_s8.tile_plan_s8(128, 128, 128, 32, 64)  # slim4's padded stem
    assert (p.wt, p.rt, p.bn, p.bkc, p.fold) == (128, 1, 64, 32, True)
    assert p.swizzle == p.bkc == 32 and p.grid == 128 * 128
    p = conv_s8.tile_plan_s8(8, 32, 32, 256, 256)
    assert (p.wt, p.rt, p.bn, p.bkc, p.fold) == (32, 4, 256, 128, False)
    assert conv_s8.tile_plan_s8(1, 4, 4, 64, 256).bn == 128  # bkc 64
    assert conv_s8.tile_plan_s8(1, 4, 4, 96, 16).bkc == 32
    for bad in ((1, 4, 4, 8, 16), (1, 4, 4, 32, 24), (0, 4, 4, 32, 16)):
        with pytest.raises(ValueError, match="multiples of 16"):
            conv_s8.tile_plan_s8(*bad)
    with pytest.raises(ValueError, match="multiple of 32"):
        conv_s8.tile_plan_s8(1, 4, 4, 16, 16)


# (H, W, C, D) of every int8 conv shape the card sees: slim4's, phase 21's
# parity shapes, the flagship's at stem 1; channels padded as the wrapper
# pads them (C to 32, D to 16).
S8_SHAPES = sorted({(h, w, c + -c % 32, d + -d % 16) for h, w, c, d in (
    chip_smoke.SLIM4_CONVS + chip_smoke.EXTRA_CONVS + chip_smoke.EDGE_CONVS
    + chip_smoke.S8_EDGE_CONVS + chip_smoke.FLAGSHIP_CONVS)})


@pytest.mark.parametrize("shape", S8_SHAPES, ids=str)
def test_s8_plan_invariants(shape):
    h, w, c, d = shape
    for batch in (1, 2, 3, 8, 32, 128):
        p = conv_s8.tile_plan_s8(batch, h, w, c, d)
        assert (p.bkc, p.bn, p.fold) in conv_s8.S8_INSTANTIATIONS
        assert p.rt * p.wt == conv.TILE_PIXELS
        assert p.fold == (p.wt >= 64 and p.bn <= 128)
        assert p.wt & (p.wt - 1) == 0 and (p.wt >= w or p.wt == 128)
        # One swizzle row a box row; whole chunks of C.
        assert p.swizzle == p.bkc in (32, 64, 128) and c % p.bkc == 0
        assert p.bkc == 128 or c % (2 * p.bkc)
        assert p.bn == 256 or not (d >= 256 and p.bkc == 128)
        # TMA: box dims <= 256; a folded box holds <= 132 pixel rows.
        assert max(p.bkc, p.wt + 2 * p.fold, p.rt, p.bn) <= 256
        assert (p.wt + 2) * p.rt <= 132 or not p.fold
        for n, t, size in ((h, p.tiles_h, p.rt), (w, p.tiles_w, p.wt),
                           (d, p.tiles_n, p.bn)):
            assert (t - 1) * size < n <= t * size
        assert p.grid == batch * p.tiles_h * p.tiles_w * p.tiles_n < 2 ** 31


def test_parity_shapes_reach_every_instantiation():
    """Phase 21's parity shapes (slim4's and the ragged ones at batch 8,
    the edge shapes at ``EDGE_BATCH``) run every ``(bkc, bn, fold)`` plan
    the kernel source instantiates, in both epilogues (the assert phase 21
    makes on the card)."""
    assert chip_smoke.k7_plans(conv_s8) == set(conv_s8.S8_INSTANTIATIONS)
    assert len(set(conv_s8.S8_INSTANTIATIONS)) == 13
