"""The port's reference twin (numpy and scipy, no OpenCV) against
``unetseg_tpu.reference_twin`` (numpy and cv2).

* ``numpy_unet_logits`` is bit-equal to the JAX twin's, stem 1 and stem 4.
* ``twin_postprocess`` on ``scipy.ndimage`` is bit-equal to the cv2 one:
  holes inside and touching the border, components just below and at the
  6% area threshold, foreground on the border (the open's border rule),
  seeded noise.
* ``twin_polygons`` traced by ``io/contours_py`` equals the cv2 one as a
  set of point lists; ``twin_pipeline``'s polygon IoU against JAX's is 1.0.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from unetseg_tpu import checkpoint as jax_ckpt, reference_twin as jax_twin
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu_torch import checkpoint, metrics, reference_twin as twin
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import synth_batch
from unetseg_tpu_torch.ops.preprocess import preprocess_oracle_u8

SLIM4 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "models", "flagship_slim4.ckpt")


def _cfgs(**kw):
    jcfg = JaxModelConfig(compute_dtype="float32", **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("stem,base,depth,size", [(1, 8, 2, 32),
                                                  (4, 8, 2, 64)])
def test_numpy_unet_logits_bit_equal(stem, base, depth, size):
    jcfg, cfg = _cfgs(stem=stem, base_channels=base, depth=depth,
                      image_size=size)
    params = jax.device_get(jax_unet.init(jax.random.key(stem), jcfg))
    x = np.random.default_rng(stem).random((size, size)).astype(np.float32)
    got = twin.numpy_unet_logits(params, x, cfg)
    want = jax_twin.numpy_unet_logits(params, x, jcfg)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twin.reference_argmax(got),
                                  jax_twin.reference_argmax(want))


def _hand_masks():
    """50 x 50 masks (min area int(2500 * 0.06f) = 150) around the
    threshold and the borders."""
    assert twin._min_area(50, 50) == 150
    masks = []
    m = np.zeros((50, 50), np.uint8)
    m[5:45, 5:45] = 2
    m[10:20, 10:24] = 0   # interior hole of 140: filled
    m[22:32, 10:25] = 0   # interior hole of 150: kept
    masks.append(m)
    m = np.full((50, 50), 2, np.uint8)
    m[0:6, 20:30] = 0     # hole touching the top border: kept
    m[20:25, 44:50] = 1   # touching the right border, class 1
    masks.append(m)
    m = np.zeros((50, 50), np.uint8)
    m[2:17, 2:12] = 2     # component of 150: kept
    m[30:45, 30:40] = 2
    m[30, 30] = 0         # component of 149: dropped
    masks.append(m)
    m = np.zeros((50, 50), np.uint8)
    m[0:20, 0:50] = 2     # foreground on three borders: the open keeps it
    m[40:50, 0:1] = 2     # a one-pixel column on the border: opened away
    m[25, 10:40] = 2      # a one-pixel line: opened away
    masks.append(m)
    return masks


def _noise_masks(seed, n=6, size=96):
    rng = np.random.default_rng(seed)
    _, labels = synth_batch(rng, n, size)
    noise = rng.random(labels.shape)
    labels[noise < 0.03] = 2
    labels[(noise >= 0.03) & (noise < 0.06)] = 0
    labels[(noise >= 0.06) & (noise < 0.07)] = 1
    return list(labels)


def _all_masks():
    return _hand_masks() + _noise_masks(0) + _noise_masks(1, size=61)


def test_twin_postprocess_bit_equal_to_cv2():
    for i, m in enumerate(_all_masks()):
        got = twin.twin_postprocess(m)
        want = jax_twin.twin_postprocess(m)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"mask {i}")


def test_twin_polygons_equal_cv2_as_sets():
    n = 0
    for m in _all_masks():
        vis = twin.mask_to_vis(twin.twin_postprocess(m))
        for ow, oh in ((m.shape[1], m.shape[0]), (1024, 768)):
            got = twin.twin_polygons(vis, ow, oh)
            want = jax_twin.twin_polygons(vis, ow, oh)
            assert sorted(map(tuple, got)) == sorted(map(tuple, want))
            n += len(got)
    assert n > 10


def test_twin_pipeline_matches_jax():
    """The shipped slim4 checkpoint (stem 4, trained: real organs) on two
    slices of bench.py's pool, at 512²."""
    params, cfg = checkpoint.load(SLIM4)
    jparams, jcfg = jax_ckpt.load(SLIM4)
    raws, _ = synth_batch(np.random.default_rng(991), 2)
    n = 0
    for raw in raws:
        u8 = preprocess_oracle_u8(raw, 512)
        got = twin.twin_pipeline(params, cfg, u8, 1024, 768)
        want = jax_twin.twin_pipeline(jparams, jcfg, u8, 1024, 768)
        assert sorted(map(tuple, got)) == sorted(map(tuple, want))
        assert metrics.polygon_iou(got, want, 1024, 768) == 1.0
        n += len(got)
    assert n > 0
