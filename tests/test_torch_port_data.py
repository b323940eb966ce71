"""The port's data generators (``unetseg_tpu_torch/data.py``) against the
JAX package's ``unetseg_tpu/data.py``: the same seed gives the same arrays,
bit for bit, for every shifted family, the real MR sample and its pool,
mosaic and 512² resample (or both ``None`` / ``[]`` where matplotlib or
its sample is absent)."""

import numpy as np
import pytest

from unetseg_tpu import data as jax_data
from unetseg_tpu_torch import data


@pytest.mark.parametrize("size", [96, 45])
@pytest.mark.parametrize("kind", ["lobulated", "crescent", "illum",
                                  "multiorgan"])
def test_synth_slice_shifted_is_bit_equal(kind, size):
    for seed in (0, 1):
        want = jax_data.synth_slice_shifted(np.random.default_rng(seed),
                                            size, kind)
        got = data.synth_slice_shifted(np.random.default_rng(seed), size,
                                       kind)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_synth_slice_shifted_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown shift kind"):
        data.synth_slice_shifted(np.random.default_rng(0), 32, "nope")


def test_real_mri_readers_are_bit_equal():
    for name in ("real_mri_slice", "real_mri_mosaic", "real_mri_512"):
        want, got = getattr(jax_data, name)(), getattr(data, name)()
        if want is None:
            assert got is None
            continue
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    want, got = jax_data.real_mri_pool(), data.real_mri_pool()
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(data.real_mri_mosaic(3),
                                  jax_data.real_mri_mosaic(3))

