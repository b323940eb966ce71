"""K8's tiling (``ops/conv.tile_plan_f32``) and a numpy emulation of its
walk (``csrc/conv3x3_f32.cu``) against the plain conv, on the CPU.

The emulation follows the kernel: blocks of 128 flattened output pixels by
64 channels, each pixel's (b, y, x) decoded from its flat index; K steps of
one tap by 16 channels, the tap's SAME padding a per-pixel mask, the
weight rows ``step * 16 + k`` of the (9C, D) HWIO matrix; each tap's sum
in a partial added to the total; ragged pixel and channel blocks masked;
bias, then ReLU.  It must match the plain conv (float32, rtol 1e-5), so
the addressing the card runs is the one the plain version computes.  The
kernel itself runs only on the card (``chip_smoke.py`` phase 22)."""

import numpy as np
import pytest
import torch

from unetseg_tpu_torch.ops import conv


def _emulate(x, w, b, relu):
    B, H, W, C = x.shape
    D = w.shape[3]
    plan = conv.tile_plan_f32(B, H, W, C, D)
    M = B * H * W
    wm = w.reshape(9 * C, D)
    chunks = C // plan.bk
    out = np.full((M, D), np.nan, np.float32)
    for tm in range(plan.tiles_m):
        m = tm * plan.bm + np.arange(plan.bm)
        valid = m < M
        pb, r = np.divmod(m, H * W)
        py, px = np.divmod(r, W)
        for tn in range(plan.tiles_n):
            n = tn * plan.bn + np.arange(plan.bn)
            nvalid = n < D
            acc = np.zeros((plan.bm, plan.bn), np.float32)
            for tap in range(9):
                part = np.zeros_like(acc)
                yy, xx = py + tap // 3 - 1, px + tap % 3 - 1
                inside = valid & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                for cc in range(chunks):
                    step = tap * chunks + cc
                    a = np.zeros((plan.bm, plan.bk), np.float32)
                    a[inside] = x[pb[inside], yy[inside], xx[inside],
                                  cc * plan.bk:(cc + 1) * plan.bk]
                    bm = np.zeros((plan.bk, plan.bn), np.float32)
                    bm[:, nvalid] = wm[step * plan.bk:(step + 1) * plan.bk,
                                       n[nvalid]]
                    part += a @ bm
                acc += part
            y = acc + np.where(nvalid, np.pad(b, (0, plan.bn * plan.tiles_n
                                                  - D))[n], 0)
            if relu:
                y = np.maximum(y, 0)
            out[np.ix_(m[valid], n[nvalid])] = y[valid][:, nvalid]
    assert not np.isnan(out).any()  # every output written exactly by a tile
    return out.reshape(B, H, W, D)


@pytest.mark.parametrize("shape,relu", [
    ((2, 5, 37, 32, 80), True),     # 3 pixel blocks, the last ragged; D 80
    ((1, 3, 4, 16, 16), True),      # fewer pixels than one block
    ((3, 9, 14, 48, 112), False),   # 3 chunks a tap; 2 channel blocks
    ((2, 11, 12, 64, 64), True),    # the blocks fill exactly (M = 264 > 256)
])
def test_k8_walk_matches_the_plain_conv(shape, relu):
    B, H, W, C, D = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, D)) / (9 * C) ** 0.5).astype(
        np.float32)
    b = (rng.standard_normal(D) * 0.1).astype(np.float32)
    want = conv.conv3x3_bias_act_plain(*(torch.from_numpy(a) for a in
                                         (x, w, b)), relu=relu).numpy()
    np.testing.assert_allclose(_emulate(x, w, b, relu), want, rtol=1e-5,
                               atol=1e-5)


def test_tile_plan_f32_covers_and_refuses():
    p = conv.tile_plan_f32(32, 512, 512, 64, 64)
    assert (p.bm, p.bn, p.bk) == conv.F32_TILE == (128, 64, 16)
    assert p.tiles_m * p.bm >= 32 * 512 * 512 > (p.tiles_m - 1) * p.bm
    assert p.grid == p.tiles_m * p.tiles_n and p.steps == 9 * 64 // 16
    assert conv.tile_plan_f32(1, 1, 1, 16, 80).tiles_n == 2
    for bad in ((1, 4, 4, 8, 16), (1, 4, 4, 16, 24), (0, 4, 4, 16, 16)):
        with pytest.raises(ValueError, match="multiples of 16"):
            conv.tile_plan_f32(*bad)


def test_dtype_dispatch_names_each_kernel():
    assert conv.variant(16, torch.float32) == "conv3x3_bias_act_f32"
    assert conv.variant(64, torch.bfloat16) == "conv3x3_bias_act_small_c"
    assert conv.variant(128, torch.bfloat16) == "conv3x3_bias_act"
    assert set(conv.DGRAD_LAUNCHES) == set(conv.LAUNCHES)


def test_dgrad_is_the_rotated_transposed_conv():
    """``conv3x3_dgrad`` on the CPU against autograd's input gradient of
    the plain conv without ReLU, float64."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 6, 7, 5), generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((3, 3, 5, 9), generator=g, dtype=torch.float64)
    gy = torch.randn((2, 6, 7, 9), generator=g, dtype=torch.float64)
    y = conv.conv3x3_bias_act_plain(x, w, torch.zeros(9, dtype=torch.float64),
                                    relu=False)
    (y * gy).sum().backward()
    torch.testing.assert_close(conv.conv3x3_dgrad(gy, w), x.grad,
                               rtol=1e-12, atol=1e-12)
