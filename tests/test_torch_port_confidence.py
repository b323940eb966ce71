"""The port's router statistics (``ops/confidence.py``) against
``unetseg_tpu.ops.confidence`` on the CPU.

Seeded float32 logits at C = 3 (the pairwise compare form) and C = 5
(``torch.topk`` against ``lax.top_k``), with exact ties, an empty mask and
an all-foreground mask among the inputs.  ``margin_map`` and
``boundary_band`` must be bit-equal; ``boundary_margin`` sums in another
order than XLA, so it is held to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.ops import confidence as jax_conf
from unetseg_tpu_torch.ops import confidence


def _logits(c, seed, ties=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (3, 24, 20, c)).astype(np.float32)
    if ties:
        # exact ties: the top two equal on a block, all equal on another
        x[:, 2:6, 3:9, 1] = x[:, 2:6, 3:9, 0] = 4.0
        x[:, 10:12, :, :] = 1.5
        # small integers: many ties between any two classes
        x[2] = rng.integers(-2, 3, x[2].shape)
    return x


def _masks(seed):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 3, (3, 24, 20)).astype(np.uint8)
    m[0] = 0                         # empty: no foreground, no band
    m[1] = 2                         # all foreground: the band is empty too
    m[2, 4:14, 5:15] = 2             # a block with a rim
    return m


@pytest.mark.parametrize("c", [3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_margin_map_bit_equal(c, seed):
    x = _logits(c, seed)
    want = np.asarray(jax_conf.margin_map(jnp.asarray(x)))
    got = confidence.margin_map(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()  # the ties are in the input


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_boundary_band_bit_equal(size, seed):
    m = _masks(seed)
    want = np.asarray(jax_conf.boundary_band(jnp.asarray(m), size))
    got = confidence.boundary_band(torch.from_numpy(m), size)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0].any() and not want[1].any() and want[2].any()


@pytest.mark.parametrize("c", [3, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boundary_margin_close(c, seed):
    x = _logits(c, seed, ties=seed != 2)
    m = _masks(seed)
    want = np.asarray(jax_conf.boundary_margin(jnp.asarray(x),
                                               jnp.asarray(m)))
    got = confidence.boundary_margin(torch.from_numpy(x), torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the empty and the all-foreground slices score their global mean
    glob = confidence.margin_map(torch.from_numpy(x)).mean((1, 2)).numpy()
    np.testing.assert_allclose(got.numpy()[:2], glob[:2], rtol=1e-6)


def test_boundary_margin_scores_rim_only():
    """The JAX package's hand case: a low-margin rim around a confident
    block scores the rim's margin."""
    mask = np.zeros((1, 16, 16), np.uint8)
    mask[0, 4:12, 4:12] = 2
    logits = np.zeros((1, 16, 16, 3), np.float32)
    logits[..., 0] = 10.0
    logits[0, 4:12, 4:12, 0] = 0.0
    logits[0, 4:12, 4:12, 2] = 10.0
    band = confidence.boundary_band(torch.from_numpy(mask)).numpy()[0]
    logits[0, band, 1] = 9.5
    got = confidence.boundary_margin(torch.from_numpy(logits),
                                     torch.from_numpy(mask))
    want = jax_conf.boundary_margin(jnp.asarray(logits), jnp.asarray(mask))
    assert float(got[0]) == pytest.approx(0.5, abs=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
