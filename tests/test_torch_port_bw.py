"""The port's halo copies (ops/halo_copy.py, K4 and K5) against the Pallas
copy kernels of ``benchmarks/exp_bw.py``, run in interpret mode at a small
size (B=2, H=16, W2=8, K=128, TH=8): bit for bit.  ``copy_elem`` returns
``x[:, 1:H+1, :W2]`` and ``copy_blocked`` ``x[:, 0:H, :W2]``."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu_torch import graphs
from unetseg_tpu_torch.ops import halo_copy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W2, K = 2, 16, 8, 128


@pytest.fixture()
def exp_bw(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "exp_bw", os.path.join(REPO, "benchmarks", "exp_bw.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in (("B", B), ("H", H), ("W2", W2), ("K", K)):
        monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(jax.experimental.pallas.pallas_call,
                                          interpret=True))
    return mod


@pytest.mark.parametrize("kernel,row_offset", [("copy_elem", 1),
                                               ("copy_blocked", 0)])
def test_plain_matches_pallas_copy(exp_bw, kernel, row_offset):
    x = torch.randn((B, H + 2, W2 + 1, K), generator=torch.Generator()
                    .manual_seed(row_offset)).to(torch.bfloat16)
    want = np.asarray(getattr(exp_bw, kernel)(8)(
        jnp.asarray(x.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    graphs.reset_launches()
    got = halo_copy.halo_copy(x, H, W2, row_offset)
    assert got.shape == (B, H, W2, K) and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert halo_copy.NAMES[row_offset] == kernel
    assert all(n == 0 for n in halo_copy.LAUNCHES.values())


@pytest.mark.parametrize("h,w2,row_offset", [(17, 8, 1), (16, 10, 0),
                                             (16, 8, 2), (-1, 8, 0)])
def test_bad_arguments_raise(h, w2, row_offset):
    with pytest.raises(ValueError, match="halo_copy"):
        halo_copy.halo_copy(torch.zeros(1, 17, 9, 8), h, w2, row_offset)


def test_probe_script_imports_without_running():
    from unetseg_tpu_torch.benchmarks import exp_bw

    assert exp_bw.SHAPE == (32, 514, 257, 128)
    assert exp_bw.bound_ms() == pytest.approx(0.641, abs=1e-3)
