"""K3's plain version (``ops/cc.py``) and the K3 wrapper's CPU dispatch
(``ops/cc_kernel.py``) against the JAX package's CCL, bit for bit.

Each labelling goes through the JAX XLA oracle ``cc.cc_label``, the Pallas
kernel ``cc_label_pallas`` in interpret mode, the port's plain
``cc.cc_label`` and the port's ``cc_kernel.cc_label`` entry on a CPU tensor,
which must take the plain version.  The cases are those of
tests/test_cc_pallas.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.ops import cc as jax_cc
from unetseg_tpu.ops.cc_pallas import cc_label_pallas, propagate_min_pallas
from unetseg_tpu_torch.ops import cc, cc_kernel


def _check(fg: np.ndarray) -> np.ndarray:
    """All four labellings of a (H, W) or (B, H, W) mask agree."""
    if fg.ndim == 2:
        want = np.asarray(jax_cc.cc_label(jnp.asarray(fg)))
    else:
        want = np.stack([np.asarray(jax_cc.cc_label(jnp.asarray(f)))
                         for f in fg])
    pallas = np.asarray(cc_label_pallas(jnp.asarray(fg), interpret=True))
    np.testing.assert_array_equal(pallas, want)
    t = torch.from_numpy(fg)
    for got in (cc.cc_label(t), cc_kernel.cc_label(t)):
        assert got.dtype == torch.int32 and got.shape == fg.shape
        np.testing.assert_array_equal(got.numpy(), want)
    return want


def _spiral(n: int) -> np.ndarray:
    fg = np.zeros((n, n), bool)
    x0, y0, x1, y1 = 0, 0, n - 1, n - 1
    while x0 < x1:
        fg[y0, x0:x1 + 1] = True
        fg[y0:y1 + 1, x1] = True
        fg[y1, x0:x1 + 1] = True
        fg[y0 + 2:y1 + 1, x0] = True
        x0, y0, x1, y1 = x0 + 4, y0 + 4, x1 - 4, y1 - 4
    return fg


def _serpentine(n: int) -> np.ndarray:
    """A 1-px boustrophedon: one component that turns n/2 times."""
    fg = np.zeros((n, n), bool)
    for r in range(0, n, 2):
        fg[r, :] = True
        if r + 1 < n:
            fg[r + 1, n - 1 if (r // 2) % 2 == 0 else 0] = True
    return fg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_blobs(seed):
    _check(np.random.default_rng(seed).random((64, 64)) > 0.55)


def test_spiral_worst_case():
    _check(_spiral(64))


def test_serpentine_is_one_component():
    fg = _serpentine(128)
    lbl = _check(fg)
    assert np.unique(lbl[fg]).tolist() == [0]


def test_degenerate_masks():
    _check(np.zeros((32, 32), bool))
    _check(np.ones((32, 32), bool))
    single = np.zeros((32, 32), bool)
    single[5, 7] = True
    lbl = _check(single)
    assert lbl[5, 7] == 5 * 32 + 7 and (lbl[~single] == 32 * 32).all()


def test_diagonal_only_links():
    fg = np.zeros((16, 16), bool)
    fg[2, 2] = fg[3, 3] = fg[4, 4] = True     # one 8-connected chain
    fg[10, 2] = fg[12, 4] = True              # two separate pixels
    lbl = _check(fg)
    assert lbl[4, 4] == 2 * 16 + 2 and lbl[12, 4] == 12 * 16 + 4


@pytest.mark.parametrize("shape", [(70, 63), (33, 90), (17, 15), (64, 1)])
def test_odd_shapes(shape):
    _check(np.random.default_rng(21).random(shape) > 0.4)


def test_batched():
    """Labels are flat indices within each image, not within the batch."""
    _check(np.random.default_rng(9).random((3, 32, 32)) > 0.5)


def test_propagate_min_regions():
    fg = np.zeros((16, 16), bool)
    fg[2:5, 2:10] = True
    fg[10:14, 1:6] = True
    seeds = np.full((16, 16), 999, np.int32)   # sentinel
    seeds[fg] = 500
    seeds[3, 7] = 42                            # min of region 1
    seeds[13, 5] = 7                            # min of region 2
    want = np.asarray(propagate_min_pallas(jnp.asarray(seeds), sentinel=999,
                                           interpret=True))
    for fn in (cc_kernel.propagate_min, cc_kernel.propagate_min_plain):
        got = fn(torch.from_numpy(seeds), 999)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want[2:5, 2:10] == 42).all() and (want[10:14, 1:6] == 7).all()
    assert (want[~fg] == 999).all()


def test_propagate_min_random_seeds_batched():
    """General seeds on random regions, a batch at once; seed = flat index
    reproduces the labelling."""
    rng = np.random.default_rng(4)
    fg = rng.random((2, 40, 48)) > 0.45
    sentinel = 40 * 48
    seeds = np.where(fg, rng.integers(0, sentinel, fg.shape), sentinel
                     ).astype(np.int32)
    want = np.asarray(propagate_min_pallas(jnp.asarray(seeds),
                                           sentinel=sentinel, interpret=True))
    got = cc_kernel.propagate_min(torch.from_numpy(seeds), sentinel)
    np.testing.assert_array_equal(got.numpy(), want)
    idx = np.where(fg, np.arange(sentinel).reshape(40, 48), sentinel)
    got = cc_kernel.propagate_min(torch.from_numpy(idx.astype(np.int32)),
                                  sentinel)
    np.testing.assert_array_equal(got.numpy(), cc.cc_label(
        torch.from_numpy(fg)).numpy())


def test_stats_and_area_match_jax():
    fg = np.random.default_rng(5).random((37, 29)) > 0.5
    jl, js = jax_cc.connected_components_with_stats(jnp.asarray(fg))
    pl, ps = cc.connected_components_with_stats(torch.from_numpy(fg))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    for name in js._fields:
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(
        cc.cc_area(torch.from_numpy(fg), pl).numpy(),
        np.asarray(jax_cc.cc_area(jnp.asarray(fg), jl)))


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="bool"):
        cc_kernel.cc_label(torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="int32"):
        cc_kernel.propagate_min(torch.zeros((4, 4)), 16)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        cc_kernel.cc_label(torch.zeros((2, 2, 4, 4), dtype=torch.bool))
    # 2**31 pixels, without the memory: an expanded view
    huge = torch.zeros((1, 1, 1), dtype=torch.bool).expand(2 ** 11, 2 ** 10,
                                                           2 ** 10)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        cc_kernel.cc_label(huge)
    assert cc_kernel.LAUNCHES == {"cc_label": 0, "propagate_min": 0}
