"""The port's mask cleanup against the JAX package and the host C++ cleanup.

Morphology against ``unetseg_tpu.ops.morphology``; the per-image oracle
``postprocess_mask`` against ``postprocess_mask_jit``; the batched serving
path ``postprocess_masks`` (K3 on the card, its plain version here) against
``postprocess_batch_v4(interpret=True)`` and the port's
``native.postprocess_batch``.  Every comparison is bit equality.  Seeds come
from fixed integers or ``zlib.crc32``, which is stable across processes.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.ops import morphology as jax_morph
from unetseg_tpu.ops import postprocess as jax_pp
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.io import native
from unetseg_tpu_torch.ops import morphology, postprocess

V4_CASES = ["organ", "empty", "full", "speckle", "ring", "many-blobs"]


def _case_mask(case: str, s: int = 96) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "organ":
        return synth_slice(rng, s)[1]
    m = np.zeros((s, s), np.uint8)
    if case == "full":
        m[:] = 2
    elif case == "speckle":
        m = (rng.random((s, s)) > 0.5).astype(np.uint8) * 2
    elif case == "ring":
        m[10:80, 10:80] = 2
        m[30:60, 30:60] = 0
    elif case == "many-blobs":  # more components than v4's 128 slots
        m[::4, ::4] = 2
    return m


@pytest.mark.parametrize("op", ["erode", "dilate", "open_"])
@pytest.mark.parametrize("size", [1, 3, 5])
def test_morphology_matches_jax(op, size):
    fg = np.random.default_rng(size).random((2, 23, 31)) > 0.4
    fg[0, 0, :] = True  # a border row: erosion must not eat it
    want = np.asarray(getattr(jax_morph, op)(jnp.asarray(fg), size))
    got = getattr(morphology, op)(torch.from_numpy(fg), size)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_morphology_rejects_even_sizes():
    for size in (0, 2, 4):
        with pytest.raises(ValueError, match="odd"):
            morphology.open_(torch.zeros((8, 8), dtype=torch.bool), size)


def test_min_area_threshold_matches_jax():
    for h, w in ((512, 512), (96, 96), (70, 63), (17, 15), (64, 1), (1, 1),
                 (3001, 2999)):
        assert postprocess.min_area_threshold(h, w) == \
            jax_pp.min_area_threshold(h, w)


@pytest.mark.parametrize("case", V4_CASES)
def test_postprocess_matches_jax_and_native(case):
    m = _case_mask(case)
    want = np.asarray(jax_pp.postprocess_mask_jit(jnp.asarray(m)))
    v4 = np.asarray(jax_pp.postprocess_batch_v4(jnp.asarray(m[None]),
                                                interpret=True))[0]
    np.testing.assert_array_equal(v4, want)
    np.testing.assert_array_equal(native.postprocess_batch(m), want)
    oracle = postprocess.postprocess_mask(torch.from_numpy(m))
    np.testing.assert_array_equal(oracle.numpy(), want)
    batched = postprocess.postprocess_masks(torch.from_numpy(m[None]))
    assert batched.dtype == torch.uint8
    np.testing.assert_array_equal(batched.numpy()[0], want)


def test_fill_holes_matches_jax():
    m = _case_mask("ring")
    m[40:44, 40:44] = 2       # an island inside the big hole
    m[12:16, 12:16] = 0       # a small hole: filled
    want = np.asarray(jax_pp.fill_holes_inside_foreground(jnp.asarray(m)))
    got = postprocess.fill_holes_inside_foreground(torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[13, 13] == 2 and got[35, 35] == 0


@pytest.mark.parametrize("shape", [(70, 63), (33, 90), (17, 15), (64, 1)])
def test_odd_shapes(shape):
    rng = np.random.default_rng(zlib.crc32(repr(shape).encode()))
    m = (rng.random(shape) > 0.4).astype(np.uint8) * 2
    want = np.asarray(jax_pp.postprocess_mask_jit(jnp.asarray(m)))
    np.testing.assert_array_equal(
        postprocess.postprocess_masks(torch.from_numpy(m[None])).numpy()[0],
        want)
    np.testing.assert_array_equal(
        postprocess.postprocess_mask(torch.from_numpy(m)).numpy(), want)


def test_batched_path_matches_per_image():
    """One batch mixing every case: per-root tables keep images apart."""
    rng = np.random.default_rng(9)
    masks = np.stack([_case_mask(c, 64) for c in V4_CASES]
                     + [synth_slice(rng, 64)[1] for _ in range(3)])
    masks[-1, 5:9, 5:9] = 1   # class-1 pixels: part of the inverse mask
    want = np.asarray(jax_pp.postprocess_batch_v4(jnp.asarray(masks),
                                                  interpret=True))
    got = postprocess.postprocess_masks(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native.postprocess_batch(masks))
