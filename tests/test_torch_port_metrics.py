"""The port's metrics (``unetseg_tpu_torch/metrics.py``) against
``unetseg_tpu.metrics`` on seeded masks, and its polygon rasteriser against
``cv2.fillPoly`` bit for bit.

Tolerances: confusion counts exact; IoU, Dice and the evaluate_masks report
within 1e-6 (JAX reduces in float32, the port in float64); boundary
distances within 1e-9; Spearman within 1e-12; rasters bit-equal.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu import metrics as jax_metrics
from unetseg_tpu_torch import metrics
from unetseg_tpu_torch.data import synth_batch
from unetseg_tpu_torch.io import native
from unetseg_tpu_torch.ops import decode


def _masks(kind, seed):
    """(pred, target) (4, 40, 48) uint8 class masks of one kind."""
    rng = np.random.default_rng(seed)
    shape = (4, 40, 48)
    if kind == "random":
        return (rng.integers(0, 3, shape, dtype=np.uint8),
                rng.integers(0, 3, shape, dtype=np.uint8))
    if kind == "absent_class":  # class 1 in neither
        return (rng.integers(0, 2, shape, dtype=np.uint8) * 2,
                rng.integers(0, 2, shape, dtype=np.uint8) * 2)
    if kind == "empty":
        return np.zeros(shape, np.uint8), np.zeros(shape, np.uint8)
    if kind == "one_side_empty":
        return np.zeros(shape, np.uint8), rng.integers(0, 3, shape,
                                                      dtype=np.uint8)
    # border-touching regions: boxes clipped by every side
    pred, target = np.zeros(shape, np.uint8), np.zeros(shape, np.uint8)
    for i in range(shape[0]):
        y, x = rng.integers(-10, 30), rng.integers(-10, 38)
        pred[i, max(y, 0):y + 20, max(x, 0):x + 20] = 2
        target[i, max(y + 2, 0):y + 23, max(x - 1, 0):x + 17] = 2
        target[i, :3, :5] = 1
    return pred, target


KINDS = ["random", "absent_class", "empty", "one_side_empty", "border"]


@pytest.mark.parametrize("kind", KINDS)
def test_confusion_iou_dice_match_jax(kind):
    pred, target = _masks(kind, 3)
    cm = metrics.confusion_counts(torch.from_numpy(pred),
                                  torch.from_numpy(target), 3)
    want = np.asarray(jax_metrics.confusion_counts(
        jnp.asarray(pred), jnp.asarray(target), 3))
    np.testing.assert_array_equal(cm.numpy(), want)
    for port_fn, jax_fn in ((metrics.iou_per_class, jax_metrics.iou_per_class),
                            (metrics.dice_per_class,
                             jax_metrics.dice_per_class)):
        got = port_fn(torch.from_numpy(pred), torch.from_numpy(target), 3)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jax_fn(jnp.asarray(pred),
                                           jnp.asarray(target), 3)),
            rtol=1e-6, atol=1e-6)
    got = metrics.evaluate_masks(pred, target)
    want = jax_metrics.evaluate_masks(pred, target)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k
    assert metrics.foreground_iou(pred, target) == pytest.approx(
        float(jax_metrics.foreground_iou(jnp.asarray(pred),
                                         jnp.asarray(target))), abs=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_boundary_distances_match_jax(kind):
    pred, target = _masks(kind, 4)
    for i in range(len(pred)):
        got = metrics.boundary_distances(pred[i], target[i])
        want = jax_metrics.boundary_distances(pred[i], target[i])
        assert got.keys() == want.keys()
        for k in want:
            if np.isinf(want[k]):
                assert np.isinf(got[k]), k
            else:
                assert abs(got[k] - want[k]) <= 1e-9, k


@pytest.mark.parametrize("a,b", [
    ([1, 2, 2, 3, 5, 5, 5], [2, 1, 1, 4, 3, 3, 9]),
    ([0, 0, 1, 1], [1, 1, 0, 0]),
    ([3, 3, 3], [1, 2, 3]),  # constant: undefined
    (list(np.random.default_rng(0).integers(0, 5, 40)),
     list(np.random.default_rng(1).integers(0, 5, 40)))])
def test_spearman_matches_jax_with_ties(a, b):
    got, want = metrics.spearman(a, b), jax_metrics.spearman(a, b)
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert abs(got - want) <= 1e-12


def _cv2_raster(contours, h, w):
    m = np.zeros((h, w), np.uint8)
    cs = [np.asarray(c, np.int32).reshape(-1, 1, 2) for c in contours]
    if cs:
        cv2.fillPoly(m, cs, 1)
    return m.astype(bool)


HAND_CASES = {
    "one_point": ([[(5, 7)]], 12, 10),
    "two_point_line": ([[(1, 21), (2, 11)]], 24, 6),
    "horizontal_line": ([[(0, 3), (9, 3)]], 6, 10),
    "collinear_run": ([[(2, 2), (5, 2), (9, 2), (9, 6), (2, 6)]], 10, 12),
    "concave": ([[(1, 1), (14, 1), (14, 14), (8, 5), (1, 14)]], 16, 16),
    "on_the_border": ([[(0, 0), (19, 0), (19, 11), (0, 11)]], 12, 20),
    "border_corner_triangle": ([[(0, 15), (15, 0), (15, 15)]], 16, 16),
    "several": ([[(1, 1), (5, 1), (5, 5), (1, 5)], [(8, 2), (13, 9), (8, 9)],
                 [(3, 10)], [(2, 12), (6, 14)]], 16, 16),
    "self_intersecting": ([[(0, 0), (10, 10), (10, 0), (0, 10)]], 12, 12),
    "overlapping": ([[(1, 1), (9, 1), (9, 9), (1, 9)],
                     [(5, 5), (14, 5), (14, 14), (5, 14)]], 16, 16),
    "steep_and_shallow": ([[(3, 0), (4, 19), (18, 18), (0, 12)]], 20, 20),
}


@pytest.mark.parametrize("name", sorted(HAND_CASES))
def test_raster_bit_equal_to_cv2_on_hand_cases(name):
    contours, h, w = HAND_CASES[name]
    got = metrics.fill_polygons(contours, h, w)
    np.testing.assert_array_equal(got, _cv2_raster(contours, h, w))
    assert got.any()


def _cleaned_masks(seed, n=8, size=128):
    """Seeded cleaned masks: synthetic labels with speckle, through the
    host C++ cleanup (holes, specks, organs on the border)."""
    rng = np.random.default_rng(seed)
    _, labels = synth_batch(rng, n, size)
    noise = rng.random(labels.shape)
    labels[noise < 0.02] = 2
    labels[(noise >= 0.02) & (noise < 0.04)] = 0
    labels[1, :, : size // 3] = 2  # an organ on the left border
    labels[2, size // 2:, size // 2:] = 2  # and in a corner
    return native.postprocess_batch(labels)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raster_bit_equal_to_cv2_on_traced_contours(seed):
    masks = _cleaned_masks(seed)
    n_contours = 0
    for mask in masks:
        contours = native.extract_contours(decode.mask_to_image_np(mask))
        n_contours += len(contours)
        h, w = mask.shape
        np.testing.assert_array_equal(metrics.fill_polygons(contours, h, w),
                                      _cv2_raster(contours, h, w))
        # scaled to another resolution, as the artifacts are
        scaled = native.scaled_polygons(decode.mask_to_image_np(mask),
                                        200, 150)
        np.testing.assert_array_equal(metrics.fill_polygons(scaled, 150, 200),
                                      _cv2_raster(scaled, 150, 200))
    assert n_contours >= len(masks) // 2  # most slices keep an organ


@pytest.mark.parametrize("seed", range(4))
def test_raster_bit_equal_to_cv2_on_random_polygons(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 80, 2))
        contours = [[(int(rng.integers(0, w)), int(rng.integers(0, h)))
                     for _ in range(int(rng.integers(1, 10)))]
                    for _ in range(int(rng.integers(1, 4)))]
        np.testing.assert_array_equal(
            metrics.fill_polygons(contours, h, w),
            _cv2_raster(contours, h, w), err_msg=str((h, w, contours)))


def test_polygon_iou_matches_jax():
    masks = _cleaned_masks(5)
    polys = [native.scaled_polygons(decode.mask_to_image_np(m), 160, 120)
             for m in masks]
    for a, b in zip(polys, polys[1:] + polys[:1]):
        assert metrics.polygon_iou(a, b, 160, 120) == \
            jax_metrics.polygon_iou(a, b, 160, 120)
    assert metrics.polygon_iou([], [], 10, 10) == 1.0
    assert metrics.polygon_iou(polys[0], polys[0], 160, 120) == 1.0
    with pytest.raises(ValueError, match="outside"):
        metrics.fill_polygons([[(0, 0), (12, 3)]], 10, 10)
