"""K8's tiling (``ops/conv.tile_plan_f32``), its weight split and a numpy
emulation of its walk and arithmetic (``csrc/conv3x3_f32.cu``), on the CPU.

The emulation follows the kernel: tiles of 128 pixels (``rt`` image rows x
``wt`` columns) by ``bn`` channels; per A box (one tap, or with the dx fold
one row of taps) a TMA load that fills zeros outside the tensor, split into
big and small halves; each warpgroup's 64 pixel rows read as a view that
starts ``row0 + dx`` rows into the box; the weights K-major and split by
the wrapper (``conv.split_tf32``), read as the kernel's 3-D tensor map over
(C, D, 18) with rows past D zero; per tap the three products small_x *
big_w + big_x * small_w + big_x * big_w, no small * small; each box's
products in a partial added to a float32 total; bias, ReLU and the masked
store.  The kernel itself runs only on the card (``chip_smoke.py`` phase
22); here its addressing must reproduce the plain conv and its arithmetic
must hold phase 22's bars against float64 and the JAX package's kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unetseg_tpu.ops.pallas_conv import conv3x3_bias_act as jax_conv
from unetseg_tpu_torch.ops import conv


def _round_tf32(a):
    """numpy float32 rounded to TF32 on its bits, ties away from zero."""
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(a):
    big = _round_tf32(a)
    return big, _round_tf32(a - big)


def _box(x, b, h, w, c0, rows, cols, bkc):
    """x[b, h:h+rows, w:w+cols, c0:c0+bkc] with zeros wherever the box
    leaves the tensor, as a TMA tiled load fills them."""
    _, H, W, _ = x.shape
    out = np.zeros((rows, cols, bkc), np.float32)
    hs, he, ws, we = max(h, 0), min(h + rows, H), max(w, 0), min(w + cols, W)
    if hs < he and ws < we:
        out[hs - h:he - h, ws - w:we - w] = x[b, hs:he, ws:we, c0:c0 + bkc]
    return out


def _emulate(x, w, bias, relu):
    """The kernel's walk and arithmetic under ``tile_plan_f32``, tile by
    tile, in float32."""
    B, H, W, C = x.shape
    D = w.shape[3]
    p = conv.tile_plan_f32(B, H, W, C, D)
    # The wrapper's split K-major weights, as the (C, D, 18) tensor map
    # reads them: planes 0..8 big taps, 9..17 small.
    ws = conv.split_tf32(conv.kmajor(torch.from_numpy(w))).reshape(
        18, D, C).numpy()
    taps, chunks = (3 if p.fold else 1), C // p.bkc
    # Box row where warpgroup g's 64 pixels start (dx = 0).
    row0 = [64 * g // p.wt * (p.wt + 2) + 64 * g % p.wt if p.fold
            else 64 * g for g in (0, 1)]
    out = np.full((B, H, W, D), np.nan, np.float32)
    for t in range(p.grid):  # the kernel's blockIdx.x decomposition
        tn, t = t % p.tiles_n, t // p.tiles_n
        tw, t = t % p.tiles_w, t // p.tiles_w
        th, b = t % p.tiles_h, t // p.tiles_h
        h0, w0, n0 = th * p.rt, tw * p.wt, tn * p.bn
        total = np.zeros((128, p.bn), np.float32)
        for ia in range(9 // taps * chunks):
            tap0, c0 = ia // chunks * taps, ia % chunks * p.bkc
            box = _box(x, b, h0 + tap0 // 3 - 1,
                       w0 - 1 + (0 if p.fold else tap0 % 3), c0, p.rt,
                       p.wt + (2 if p.fold else 0), p.bkc).reshape(-1, p.bkc)
            a_big, a_small = _split(box)
            partial = np.zeros_like(total)
            for dx in range(taps):
                rows = np.concatenate([np.arange(r + dx, r + dx + 64)
                                       for r in row0])
                ab, asm = a_big[rows], a_small[rows]
                bb = np.zeros((p.bn, p.bkc), np.float32)
                bs = np.zeros_like(bb)
                n = min(p.bn, D - n0)
                bb[:n] = ws[tap0 + dx, n0:n0 + n, c0:c0 + p.bkc]
                bs[:n] = ws[9 + tap0 + dx, n0:n0 + n, c0:c0 + p.bkc]
                partial += asm @ bb.T
                partial += ab @ bs.T
                partial += ab @ bb.T
            total += partial
        n = min(p.bn, D - n0)
        y = total[:, :n] + bias[n0:n0 + n]
        if relu:
            y = np.maximum(y, 0)
        y = y.reshape(p.rt, p.wt, n)
        he, we = min(h0 + p.rt, H), min(w0 + p.wt, W)
        out[b, h0:he, w0:we, n0:n0 + n] = y[:he - h0, :we - w0]
    assert not np.isnan(out).any()  # every output written by a tile
    return out


def _inputs(shape):
    B, H, W, C, D = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, D)) / (9 * C) ** 0.5).astype(
        np.float32)
    b = (rng.standard_normal(D) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,relu", [
    ((2, 5, 37, 32, 80), True),     # fold at wt = 64, rt = 2; D 80 of 128
    ((1, 3, 4, 16, 16), True),      # wt = 4, rt = 32: fewer rows than a tile
    ((3, 9, 14, 48, 112), False),   # bkc 16, 3 chunks a tap; unfolded
    ((2, 11, 12, 64, 64), True),    # 2 chunks of 32; bn 64; ragged H
    ((1, 3, 150, 32, 144), True),   # fold at wt = 128, 2 column tiles, D 144
    ((2, 4, 64, 16, 48), False),    # fold at wt = 64 exactly; bkc 16
    ((1, 2, 1, 64, 16), True),      # W = 1: wt = 1, rt = 128
])
def test_k8_walk_matches_the_plain_conv(shape, relu):
    """The emulated walk (boxes, fold views, K-major split weights, ragged
    edges) against the plain conv in float32: rtol and atol 1e-5, two
    orders above the split's ~2^-22 of a product, far below any addressing
    slip (a wrong box or weight row moves outputs by O(1))."""
    x, w, b = _inputs(shape)
    want = conv.conv3x3_bias_act_plain(*(torch.from_numpy(a) for a in
                                         (x, w, b)), relu=relu).numpy()
    np.testing.assert_allclose(_emulate(x, w, b, relu), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [
    (2, 9, 12, 16, 48),      # C = 16: bkc 16, unfolded (wt = 16)
    (1, 5, 70, 64, 80),      # fold at wt = 128; D ragged
    (2, 8, 40, 128, 128),    # fold at wt = 64; the JAX Pallas kernel
    (1, 6, 20, 256, 64),     # 8 chunks a tap; the JAX Pallas kernel
])
def test_3xtf32_products_hold_the_phase22_bar(shape):
    """The emulated 3xTF32 arithmetic against float64 and the JAX package's
    ``conv3x3_bias_act`` in float32 (its Pallas kernel in interpret mode
    for C >= 128, XLA's conv below), at phase 22's bars: within
    ``chip_smoke.F32_TOL`` (2e-5) of max |out| of float64 and of JAX's
    output, and at most ``F32_VS_LIBRARY`` (4) times the plain float32
    conv's own error.  The split keeps ~22 bits of each operand and every
    tf32 product is exact in float32, so the error stays a float32 sum's."""
    x, w, b = _inputs(shape)
    got = _emulate(x, w, b, True).astype(np.float64)
    ref = conv.conv3x3_bias_act_plain(*(torch.from_numpy(a).double() for a
                                        in (x, w, b))).numpy()
    plain = conv.conv3x3_bias_act_plain(*(torch.from_numpy(a) for a in
                                          (x, w, b))).numpy()
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               interpret=True))
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    p_err = np.abs(plain - ref).max()
    assert err <= chip_smoke.F32_TOL * scale
    assert err <= max(chip_smoke.F32_VS_LIBRARY * p_err, 2.0 ** -24 * scale)
    assert np.abs(got - want).max() <= chip_smoke.F32_TOL * scale


def test_split_tf32_rounds_on_the_bits():
    """``conv.split_tf32`` against the numpy rounding: both halves have 13
    zero low bits, ties round away from zero, big + small is the value to
    2^-23 of it, and small is the rounded rest (exact where it fits)."""
    rng = np.random.default_rng(11)
    v = np.concatenate([(rng.standard_normal(4096)
                         * 10.0 ** rng.integers(-6, 6, 4096)).astype(
                             np.float32),
                        np.array([1 + 2 ** -11, -(1 + 2 ** -11),
                                  1 + 3 * 2 ** -12, 0.0, -0.0],
                                 np.float32)])
    got = conv.split_tf32(torch.from_numpy(v)).numpy()
    big, small = _split(v)
    np.testing.assert_array_equal(got[0].view(np.uint32), big.view(np.uint32))
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  small.view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    # The tie 1 + 2^-11 rounds away from zero, to 1 + 2^-10.
    assert got[0, -5] == 1 + 2 ** -10 and got[0, -4] == -(1 + 2 ** -10)
    err = np.abs(got[0].astype(np.float64) + got[1] - v)
    assert (err <= 2.0 ** -23 * np.abs(v)).all()
    with pytest.raises(TypeError, match="float32"):
        conv.split_tf32(torch.from_numpy(v).double())


@pytest.mark.parametrize("cw,dw,c,d", [(5, 9, 16, 16), (16, 48, 16, 48),
                                       (1, 16, 16, 16)])
def test_weight_stage_pads_and_reads_any_strides(cw, dw, c, d):
    """``split_weights_f32`` (K8's weight stage; its CPU plain version here)
    gives the split K-major weights of w zero-padded to (c, d), for HWIO w
    and for the data gradient's rotated, transposed view of another w."""
    g = torch.Generator().manual_seed(cw * 100 + dw)
    w = torch.randn((3, 3, cw, dw), generator=g)
    got = conv.split_weights_f32(w, c, d)
    assert got.shape == (2, 3, 3, d, c) and got.is_contiguous()
    big, small = _split(w.permute(0, 1, 3, 2).numpy())
    np.testing.assert_array_equal(got[0, :, :, :dw, :cw].numpy(), big)
    np.testing.assert_array_equal(got[1, :, :, :dw, :cw].numpy(), small)
    assert not got[:, :, :, dw:].any() and not got[..., cw:].any()
    w2 = torch.randn((3, 3, dw, cw), generator=g)  # dgrad: C and D swap
    view = w2.flip((0, 1)).transpose(2, 3)
    assert torch.equal(conv.split_weights_f32(view, c, d),
                       conv.split_weights_f32(view.contiguous(), c, d))
    with pytest.raises(ValueError, match="weights wanted"):
        conv.split_weights_f32(w, cw - 1 if cw > 1 else 0, d)


def test_tile_plan_f32_covers_and_refuses():
    p = conv.tile_plan_f32(32, 512, 512, 64, 64)
    assert (p.wt, p.rt, p.bn, p.bkc, p.fold) == (128, 1, 64, 32, True)
    assert p.grid == 32 * 512 * 4 * 1 and p.swizzle == 4 * p.bkc
    assert conv.tile_plan_f32(2, 32, 32, 1024, 1024)[:5] == (32, 4, 128, 32,
                                                             128)
    assert conv.tile_plan_f32(1, 1, 1, 16, 80).tiles_n == 1
    assert conv.tile_plan_f32(1, 1, 1, 48, 144).bkc == 16
    for bad in ((1, 4, 4, 8, 16), (1, 4, 4, 16, 24), (0, 4, 4, 16, 16)):
        with pytest.raises(ValueError, match="multiples of 16"):
            conv.tile_plan_f32(*bad)


# (H, W, C, D) of every float32 shape the card sees (phase 22's served and
# edge shapes, the training step's last level), channels padded to 16.
F32_SHAPES = sorted({(h, w, c + -c % 16, d + -d % 16) for h, w, c, d in (
    chip_smoke.F32_SERVED_CONVS + chip_smoke.F32_EDGE_CONVS
    + chip_smoke.TRAIN_LAST_CONVS)})


@pytest.mark.parametrize("shape", F32_SHAPES, ids=str)
def test_f32_plan_invariants(shape):
    h, w, c, d = shape
    for batch in (1, 2, 3, 8, 32, 128):
        p = conv.tile_plan_f32(batch, h, w, c, d)
        assert (p.bkc, p.bn, p.fold) in conv.F32_INSTANTIATIONS
        assert p.rt * p.wt == conv.TILE_PIXELS and p.fold == (p.wt >= 64)
        assert p.wt & (p.wt - 1) == 0 and (p.wt >= w or p.wt == 128)
        assert c % p.bkc == 0 and p.swizzle == 4 * p.bkc in (64, 128)
        # TMA: box dims <= 256; a folded box holds <= 132 pixel rows.
        assert max(p.bkc, p.wt + 2 * p.fold, p.rt, p.bn) <= 256
        assert (p.wt + 2) * p.rt <= 132 or not p.fold
        for n, t, size in ((h, p.tiles_h, p.rt), (w, p.tiles_w, p.wt),
                           (d, p.tiles_n, p.bn)):
            assert (t - 1) * size < n <= t * size
        assert p.grid == batch * p.tiles_h * p.tiles_w * p.tiles_n < 2 ** 31


def test_kernel_entry_takes_only_cuda_float32():
    """On the CPU the wrapper runs the plain version; on a device that is
    neither the CPU nor a card it refuses float32 tensors instead of
    falling back."""
    x = torch.randn((1, 4, 4, 16))
    w = torch.randn((3, 3, 16, 16))
    b = torch.zeros(16)
    torch.testing.assert_close(conv.conv3x3_bias_act(x, w, b),
                               conv.conv3x3_bias_act_plain(x, w, b))
    with pytest.raises(ValueError, match="unsupported device"):
        conv.conv3x3_bias_act(*(t.to("meta") for t in (x, w, b)))


def test_dtype_dispatch_names_each_kernel():
    assert conv.variant(16, torch.float32) == "conv3x3_bias_act_f32"
    assert conv.variant(64, torch.bfloat16) == "conv3x3_bias_act_small_c"
    assert conv.variant(128, torch.bfloat16) == "conv3x3_bias_act"
    assert set(conv.DGRAD_LAUNCHES) == set(conv.LAUNCHES)


def test_dgrad_is_the_rotated_transposed_conv(monkeypatch):
    """``conv3x3_dgrad`` on the CPU against autograd's input gradient of
    the plain conv without ReLU, float64; and the weights it hands the conv
    entry are the rotated, transposed HWIO weights, whose K-major form (as
    K8 reads them) is ``w`` rotated alone."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 6, 7, 5), generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((3, 3, 5, 9), generator=g, dtype=torch.float64)
    gy = torch.randn((2, 6, 7, 9), generator=g, dtype=torch.float64)
    y = conv.conv3x3_bias_act_plain(x, w, torch.zeros(9, dtype=torch.float64),
                                    relu=False)
    (y * gy).sum().backward()
    seen = []
    entry = conv.conv3x3_bias_act
    monkeypatch.setattr(conv, "conv3x3_bias_act",
                        lambda x, w, b, relu: seen.append(w) or entry(
                            x, w, b, relu))
    torch.testing.assert_close(conv.conv3x3_dgrad(gy, w), x.grad,
                               rtol=1e-12, atol=1e-12)
    (w_t,) = seen
    assert torch.equal(w_t, w.flip((0, 1)).transpose(2, 3).contiguous())
    assert torch.equal(conv.kmajor(w_t), w.flip((0, 1)))
    assert conv.kmajor(w_t).is_contiguous()


def test_parity_shapes_reach_every_instantiation():
    """Phase 22's ``check_k8`` runs every ``(bkc, bn, fold)`` variant the
    kernel source instantiates: its served shapes at ``F32_PARITY_BATCH``
    and its edge shapes at ``EDGE_BATCH`` (the assert phase 22 makes on
    the card)."""
    plans = (chip_smoke.k8_plans(conv, chip_smoke.F32_SERVED_CONVS,
                                 chip_smoke.F32_PARITY_BATCH)
             | chip_smoke.k8_plans(conv, chip_smoke.F32_EDGE_CONVS,
                                   chip_smoke.EDGE_BATCH))
    assert plans == set(conv.F32_INSTANTIATIONS)
    # The edge shapes alone miss no variant either, so the gradient check
    # (grad_parity over F32_EDGE_CONVS) runs each in the forward too.
    assert chip_smoke.k8_plans(conv, chip_smoke.F32_EDGE_CONVS,
                               chip_smoke.EDGE_BATCH) == plans
