"""The port's 3x3 conv (ops/conv.py) against the JAX package's Pallas kernels.

On the CPU the wrapper runs its plain version; these tests hold that version
against ``conv3x3_bias_act`` (C >= 128) and ``_conv3x3_small_c`` (C < 128)
run in Pallas interpret mode, on the same numpy inputs.  f32 is held to
1e-5; bf16 to rtol 1.6e-2 / atol 1e-2, about two bf16 ulps at the output's
scale, since both sum in f32 in another order and round once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.ops import pallas_conv
from unetseg_tpu_torch import graphs
from unetseg_tpu_torch.ops import conv

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1.6e-2, atol=1e-2)}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, h, w, c, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, d)) / np.sqrt(9 * c)).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32) * 0.1
    return x, wt, bias


def _pallas(x, w, b, relu, dtype):
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    if x.shape[-1] >= 128:
        out = pallas_conv.conv3x3_bias_act(jx, jw, jb, relu=relu,
                                           interpret=True)
    else:
        out = pallas_conv._conv3x3_small_c(jx, jw, jb, relu=relu,
                                           interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("c,d,h,w", [(16, 64, 8, 8), (64, 32, 8, 12),
                                     (128, 64, 8, 8), (256, 128, 4, 8),
                                     (192, 96, 4, 8), (48, 80, 8, 12)])
def test_plain_matches_pallas(c, d, h, w, relu, dtype):
    x, wt, bias = _inputs(c + d + h, 2, h, w, c, d)
    want = _pallas(x, wt, bias, relu, dtype)
    t = _TORCH[dtype]
    got = conv.conv3x3_bias_act_plain(
        torch.from_numpy(x).to(t), torch.from_numpy(wt).to(t),
        torch.from_numpy(bias).to(t), relu=relu)
    assert got.dtype == t and got.shape == (2, h, w, d)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    x, wt, bias = _inputs(0, 1, 6, 5, 16, 16)
    tx, tw, tb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, wt, bias))
    graphs.reset_launches()
    got = conv.conv3x3_bias_act(tx, tw, tb)
    assert torch.equal(got, conv.conv3x3_bias_act_plain(tx, tw, tb))
    assert all(n == 0 for n in conv.LAUNCHES.values())


@pytest.mark.parametrize("wshape,bshape", [((3, 3, 8, 4), (4,)),
                                           ((1, 1, 16, 4), (4,)),
                                           ((3, 3, 16, 4), (5,))])
def test_wrapper_rejects_bad_shapes(wshape, bshape):
    x = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError):
        conv.conv3x3_bias_act(x, torch.zeros(wshape), torch.zeros(bshape))
