"""The model's FLOPs and one conv launch's operations and bytes, by hand."""

import pytest

from perfbench import counts, peaks

FLAGSHIP = dict(arch="unet", stem=1, image_size=512, base_channels=64,
                depth=4, num_classes=3, compute_dtype="bfloat16")
SLIM4 = dict(FLAGSHIP, stem=4, depth=2)


def test_flops_per_slice():
    assert counts.model_flops_per_slice(FLAGSHIP) / 1e9 == pytest.approx(
        384.802226176, rel=1e-12)
    assert counts.model_flops_per_slice(SLIM4) / 1e9 == pytest.approx(
        13.019119616, rel=1e-12)


def test_launches_per_forward():
    assert len(counts.conv_launches(FLAGSHIP)) == 16   # 13 K1 + 3 K2
    assert len(counts.conv_launches(SLIM4)) == 10
    assert counts.fused_last_level(FLAGSHIP)
    assert not counts.fused_last_level(SLIM4)


def test_one_k1_launch():
    # the flagship's first-level conv2: 64 -> 64 channels at 512², batch 32
    c = counts.Conv(64, 64, 512)
    assert counts.conv_flops(c, 32) == 2 * 9 * 64 * 64 * 512 * 512 * 32
    px = 512 * 512 * 32
    assert counts.conv_bytes(c, 32) == 2 * (px * 64 + 9 * 64 * 64 + 64
                                            + px * 64)
    # bytes bound it: 2.15 GB at 3.35 TB/s is longer than 0.618 TFLOP
    assert counts.bound_s(counts.conv_flops(c, 32), counts.conv_bytes(c, 32)) \
        == pytest.approx(2 * (2 * px * 64 + 9 * 64 * 64 + 64)
                         / peaks.HBM_BYTES_PER_S)
    assert 2 * 9 * 64 * 64 * px / peaks.BF16_FLOPS < 0.000641


def test_fused_last_level_launch():
    flops, nbytes = counts.last_level(FLAGSHIP, 32)
    assert flops == pytest.approx(1.996086050816e12)
    assert counts.dec1_bound_s(FLAGSHIP, 32) == pytest.approx(
        flops / peaks.BF16_FLOPS)
