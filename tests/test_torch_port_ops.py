"""The port's preprocess, decode, metrics, data and host-library binding
against the JAX package's counterparts (integer and byte stages: exact)."""

import numpy as np
import pytest
import torch

from unetseg_tpu import data as jax_data, metrics as jax_metrics
from unetseg_tpu.io import native as jax_native
from unetseg_tpu.ops import decode as jax_decode, preprocess as jax_pre
from unetseg_tpu_torch import data, metrics
from unetseg_tpu_torch.io import native
from unetseg_tpu_torch.ops import decode, preprocess


def test_decode_tie_break_lowest_index():
    logits = torch.zeros((1, 2, 2, 3))  # all ties -> class 0
    assert (decode.decode_mask(logits) == 0).all()
    logits[0, 0, 0] = torch.tensor([1.0, 1.0, 0.5])  # tie 0/1 -> 0
    logits[0, 0, 1] = torch.tensor([0.0, 2.0, 2.0])  # tie 1/2 -> 1
    logits[0, 1, 0] = torch.tensor([-1.0, -0.5, -0.5])  # tie at max -> 1
    got = decode.decode_mask(logits)
    assert got.dtype == torch.uint8
    assert got[0, 0, 0] == 0 and got[0, 0, 1] == 1 and got[0, 1, 0] == 1


def test_decode_matches_jax_on_bf16_ties():
    """bf16 logits tie often; the first maximum wins on both sides."""
    rng = np.random.default_rng(0)
    x = rng.integers(-2, 3, (4, 16, 16, 3)).astype(np.float32) * 0.5
    want = np.asarray(jax_decode.decode_mask(x))
    got = decode.decode_mask(torch.from_numpy(x).to(torch.bfloat16).float())
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_ignores_extra_channels():
    logits = torch.tensor([[[[0.0, 1.0, 2.0, 99.0, 99.0]]]])
    assert int(decode.decode_mask(logits)[0, 0, 0]) == 2


def test_mask_to_image_lut():
    m = np.array([[0, 1, 2]], np.uint8)
    np.testing.assert_array_equal(decode.mask_to_image_np(m),
                                  jax_decode.mask_to_image_np(m))


def test_model_input_from_u8():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = np.asarray(jax_pre.model_input_from_u8(u8))
    got = preprocess.model_input_from_u8(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,out", [(80, 100, 64), (512, 512, 512),
                                     (768, 700, 512), (7, 9, 16)])
def test_preprocess_oracle_and_native_are_bit_exact(h, w, out):
    raw = np.random.default_rng(h * w).integers(0, 65536, (h, w), dtype=np.uint16)
    want = jax_pre.preprocess_oracle_u8(raw, out)
    np.testing.assert_array_equal(preprocess.preprocess_oracle_u8(raw, out), want)
    np.testing.assert_array_equal(native.preprocess_u8(raw, out), want)


def test_synth_and_foreground_iou_match_jax():
    raws, labels = data.synth_batch(np.random.default_rng(991), 2, size=64)
    jraws, jlabels = jax_data.synth_batch(np.random.default_rng(991), 2, size=64)
    np.testing.assert_array_equal(raws, jraws)
    np.testing.assert_array_equal(labels, jlabels)
    pred = labels[::-1].copy()
    for i in range(2):
        assert metrics.foreground_iou(pred[i], labels[i]) == pytest.approx(
            float(jax_metrics.foreground_iou(pred[i], labels[i])), abs=1e-6)
    assert metrics.foreground_iou(np.zeros((4, 4)), np.zeros((4, 4))) == 1.0


def test_native_host_entries_match_jax_binding():
    rng = np.random.default_rng(1)
    masks = np.zeros((3, 64, 64), np.uint8)
    masks[:, 10:40, 12:50] = 2
    masks[1, 20:25, 20:25] = 1
    masks[2] = rng.integers(0, 3, (64, 64))
    clean = native.postprocess_batch(masks)
    np.testing.assert_array_equal(clean, jax_native.postprocess_batch(masks))
    np.testing.assert_array_equal(native.postprocess_batch(masks[0]), clean[0])

    vis = decode.mask_to_image_np(clean[0])
    contours = native.extract_contours(vis)
    assert contours and contours == jax_native.extract_contours(vis)
    assert native.contour_json_bytes(contours, "s", 100, 80, 100 / 64, 80 / 64) \
        == jax_native.contour_json_bytes(contours, "s", 100, 80, 100 / 64,
                                         80 / 64)
    assert native.size_json_bytes("s.raw", 100, 80, 64, 64) \
        == jax_native.size_json_bytes("s.raw", 100, 80, 64, 64)
    assert native.TIER_FULL == jax_native.TIER_FULL
    assert native.TIER_MASK_JSON == jax_native.TIER_MASK_JSON
    assert native.TIER_JSON == jax_native.TIER_JSON


def test_emit_batch_matches_jax_binding(tmp_path):
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (2, 48, 48), dtype=np.uint8)
    masks = np.zeros((2, 48, 48), np.uint8)
    masks[0, 5:30, 8:40] = 2
    for side, mod in (("port", native), ("jax", jax_native)):
        d = tmp_path / side
        d.mkdir()
        counts = mod.emit_batch(u8, masks, [str(d)] * 2, ["a", "b"],
                                ["a.raw", "b.raw"], 96, 72, mod.TIER_FULL)
        assert list(counts) == [1, 0]
    for f in sorted(p.name for p in (tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
