"""The port's fused last decoder level (ops/dec1.py, K6) against the JAX side.

``dec1_fused_plain`` is held against the Pallas kernel of
``benchmarks/exp_dec1_ablate.py::make("full")`` itself, run in interpret
mode at a small size (B=2, H=16, W2=8, C2=32), on the same bf16 numbers
folded into K6's layout.  ``UNet.masks`` of a small bf16 stem-1 model is
held against ``unet.apply`` + argmax.

Tolerance (``dec1.near_tie``): the class maps are equal except at pixels
whose f32 top-2 logit margin is within one bf16 ulp of the larger of the two
classes' absolute head sums ``|c2|.|wh| + |bh|``.  Two implementations
that sum in another f32 order may round a conv output to the neighbouring
bf16 value, which moves a logit by up to that much.
"""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import unet as jax_unet
from unetseg_tpu_torch import graphs
from unetseg_tpu_torch.checkpoint import up_weight_from_hwio
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.ops import dec1

from test_torch_port_unet import _random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W2, C2 = 2, 16, 8, 32
C = C2 // 2


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16, kept as f32 numpy (exact in both frameworks)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


@pytest.fixture()
def k6(monkeypatch):
    """``make`` of exp_dec1_ablate.py at the small size, interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "exp_dec1_ablate", os.path.join(REPO, "benchmarks",
                                        "exp_dec1_ablate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in (("B", B), ("H", H), ("W2", W2), ("C2", C2)):
        monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(jax.experimental.pallas.pallas_call,
                                          interpret=True))
    return mod.make


def _natural(seed, n_classes=3):
    """Natural operands of the level (numpy, bf16-rounded): x (B, H/2, W2,
    2C), skip (B, H, W, C), HWIO weights, head (C, K)."""
    rng = np.random.default_rng(seed)
    x = _bf16(np.maximum(rng.standard_normal((B, H // 2, W2, 2 * C)), 0))
    skip = _bf16(np.maximum(rng.standard_normal((B, H, 2 * W2, C)), 0))
    w_up = _bf16(rng.standard_normal((2, 2, 2 * C, C)) / np.sqrt(2 * C))
    w1 = _bf16(rng.standard_normal((3, 3, 2 * C, C)) / np.sqrt(9 * C))
    w2 = _bf16(rng.standard_normal((3, 3, C, C)) / np.sqrt(4.5 * C))
    wh = _bf16(rng.standard_normal((C, n_classes)) / np.sqrt(C))
    return x, skip, w_up, w1, w2, wh


def _fold_conv(wc):
    """(3, 3, Ci, Co) HWIO -> K6's (3, 2Ci, 2Co) lo and hi weights over
    folded pixel pairs (exp_dec1_ablate.py:77-137)."""
    ci, co = wc.shape[2], wc.shape[3]
    lo = np.zeros((3, 2 * ci, 2 * co), np.float32)
    hi = np.zeros_like(lo)
    for dy in range(3):
        lo[dy, :ci, :co] = wc[dy, 0]
        lo[dy, ci:, :co] = wc[dy, 1]
        lo[dy, ci:, co:] = wc[dy, 0]
        hi[dy, :ci, :co] = wc[dy, 2]
        hi[dy, :ci, co:] = wc[dy, 1]
        hi[dy, ci:, co:] = wc[dy, 2]
    return lo, hi


def _fold(x, skip, w_up, w1, w2, wh, seed):
    """K6's operands from the natural ones."""
    rng = np.random.default_rng(seed + 1000)
    # z: x with a one-pixel ring, non-zero, since K6 masks it (:63-68).
    z = _bf16(rng.standard_normal((B, H // 2 + 2, W2 + 2, 2 * C)))
    z[:, 1:-1, 1:-1] = x
    # skip: two pixels per folded column, a zero ring of 2 rows and one
    # folded column (K6 reads it unmasked).
    sk = np.pad(skip.reshape(B, H, W2, 2 * C), ((0, 0), (2, 2), (1, 1), (0, 0)))
    wu = np.zeros((2, 2 * C, 2 * C), np.float32)
    for a in range(2):
        for b in range(2):
            wu[a][:, b * C:(b + 1) * C] = w_up[1 - a, 1 - b]
    w1lo, w1hi = (np.stack(p) for p in zip(_fold_conv(w1[:, :, :C]),
                                          _fold_conv(w1[:, :, C:])))
    w2lo, w2hi = _fold_conv(w2)
    wh8 = np.zeros((2 * C, 8), np.float32)
    for k in range(wh.shape[1]):
        for h in range(2):
            wh8[h * C:(h + 1) * C, 2 * k + h] = wh[:, k]
    return [jnp.asarray(a, jnp.bfloat16)
            for a in (z, sk, wu, w1lo, w1hi, w2lo, w2hi, wh8)]


def _port_args(x, skip, w_up, w1, w2, wh, biases=None):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    zeros = (np.zeros(C, np.float32),) * 3 + (np.zeros(wh.shape[1],
                                                       np.float32),)
    bu, b1, b2, bh = biases or zeros
    return [t(x), t(skip), t(up_weight_from_hwio(w_up)), t(bu), t(w1), t(b1),
            t(w2), t(b2), t(wh), t(bh)]


def _assert_masks_match(got, want, ops):
    """Equal except near ties; returns the number of differing pixels."""
    assert got.shape == want.shape and got.dtype == torch.uint8
    tie = dec1.near_tie(dec1.dec1_head_input_plain(*ops[:8]), ops[8], ops[9])
    differ = got != want
    assert not (differ & ~tie).any(), (differ & ~tie).nonzero()[:10]
    return int(differ.sum())


@pytest.mark.parametrize("seed", [1, 4])
def test_plain_matches_jax_k6(k6, seed):
    nat = _natural(seed)
    out = np.asarray(k6("full", TR=8)(*_fold(*nat, seed)))
    assert out.shape == (B, H // 8, 8 * W2, 8)
    # out[b, i, t*W2 + j, h] is the class of pixel (8i + t, 2j + h).
    want = torch.from_numpy(out[..., :2].reshape(B, H // 8, 8, W2, 2)
                            .reshape(B, H, 2 * W2).astype(np.uint8))
    ops = _port_args(*nat)
    got = dec1.dec1_fused_plain(*ops)
    assert len(torch.unique(got)) == 3  # every class occurs: not vacuous
    _assert_masks_match(got, want, ops)


def test_plain_matches_jax_k6_without_up_taps_flip_fails(k6):
    """The up-conv's tap flip matters: without it the maps disagree well
    beyond the near-tie pixels (K6's fold and the port's layout both carry
    it)."""
    nat = _natural(3)
    out = np.asarray(k6("full", TR=8)(*_fold(*nat, 3)))
    want = out[..., :2].reshape(B, H // 8, 8, W2, 2).reshape(B, H, 2 * W2)
    x, skip, w_up, w1, w2, wh = nat
    unflipped = _port_args(x, skip, w_up[::-1, ::-1], w1, w2, wh)
    got = dec1.dec1_fused_plain(*unflipped).numpy()
    assert (got != want).mean() > 0.1


def test_unet_masks_match_jax_apply():
    """bf16 stem-1 UNet (depth 2, base 16, 64²) with biases: ``masks`` (K6's
    plain version for the last level) against JAX ``apply`` + argmax."""
    jcfg = JaxModelConfig(base_channels=16, depth=2, image_size=64,
                          compute_dtype="bfloat16")
    params = _random_params(jcfg, seed=4)
    x = np.random.default_rng(6).random((2, 64, 64, 1)).astype(np.float32)
    # Centre the head's bias on this input's logits, so that every class
    # occurs (a random UNet otherwise paints one class everywhere).
    params["head"]["b"] = np.zeros_like(params["head"]["b"])
    lg = np.asarray(jax_unet.apply(params, jnp.asarray(x), jcfg))
    params["head"]["b"] = -np.median(lg.reshape(-1, 3), 0).astype(np.float32)
    want_logits = np.asarray(jax_unet.apply(params, jnp.asarray(x), jcfg))
    want = torch.from_numpy(want_logits.argmax(-1).astype(np.uint8))
    model = registry.build(params, ModelConfig(**dataclasses.asdict(jcfg)),
                           device="cpu")
    with torch.inference_mode():
        got = model.masks(torch.from_numpy(x))
        xin, skip = model._trunk(torch.from_numpy(x))
        last = model.decoder[-1]
        ops = [xin, skip, last.up.weight, last.up.bias, last.conv1.weight,
               last.conv1.bias, last.conv2.weight, last.conv2.bias,
               model.head_weight, model.head_bias]
    assert len(torch.unique(got)) == 3
    # JAX's default path rounds every conv, the up-conv and the head twice
    # (product, then bias add) where K6 rounds once, so c1 and c2 differ by
    # up to a bf16 ulp at every element, not only where a sum lands near a
    # rounding boundary: the near-tie rule with two ulps, and at least 98%
    # of the pixels equal (the centred head makes near ties common here).
    tie = dec1.near_tie(dec1.dec1_head_input_plain(*ops[:8]), ops[8], ops[9],
                        ulps=2)
    differ = got != want
    assert differ.float().mean() <= 0.02, differ.float().mean()
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())


def test_f32_masks_are_forward_argmax_bit_for_bit():
    cfg = ModelConfig(base_channels=8, depth=2, image_size=32,
                      compute_dtype="float32")
    params = _random_params(JaxModelConfig(**dataclasses.asdict(cfg)), 2)
    model = registry.build(params, cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 32, 32, 1)).astype(np.float32))
    with torch.inference_mode():
        want = torch.argmax(model(x), -1).to(torch.uint8)
        assert torch.equal(model.masks(x), want)


def _ops(n=1, h=8, w=8, c=16, k=3, dtype=torch.bfloat16):
    return [torch.zeros(s, dtype=dtype) for s in (
        (n, h // 2, w // 2, 2 * c), (n, h, w, c), (2 * c, 4 * c), (c,),
        (3, 3, 2 * c, c), (c,), (3, 3, c, c), (c,), (c, k), (k,))]


@pytest.mark.parametrize("index,shape", [
    (0, (1, 4, 4, 16)), (1, (1, 8, 8, 8)), (2, (32, 32)), (3, (8,)),
    (4, (3, 3, 16, 16)), (6, (1, 3, 16, 16)), (8, (16, 3, 1)), (9, (4,))])
def test_wrong_shapes_raise(index, shape):
    ops = _ops()
    ops[index] = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dec1_fused"):
        dec1.dec1_fused_masks(*ops)


def test_odd_size_and_mixed_dtypes_raise():
    ops = _ops(h=8, w=8)
    ops[1] = torch.zeros((1, 8, 9, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dec1.dec1_fused_masks(*ops)
    ops = _ops()
    ops[4] = ops[4].float()
    with pytest.raises(TypeError, match="dtype"):
        dec1.dec1_fused_masks(*ops)
    with pytest.raises(TypeError, match="dtype"):
        dec1.dec1_fused_masks(*_ops(dtype=torch.int32))


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    nat = _natural(5)
    ops = _port_args(*nat)
    graphs.reset_launches()
    assert torch.equal(dec1.dec1_fused_masks(*ops),
                       dec1.dec1_fused_plain(*ops))
    assert dec1.LAUNCHES == {"dec1_fused": 0}


def test_near_tie_rule():
    c2 = torch.tensor([[[[1.0, 1.0]]]])
    wh = torch.tensor([[1.0, -1.0, 1.0], [1.0, 1.0, -1.0]])
    # logits [2, 0, 0]: a margin of 2 against an ulp of 2 (2**-6).
    assert not dec1.near_tie(c2, wh, torch.zeros(3)).any()
    # logits [2, 2 - 2**-7, 0]: inside one ulp of class 1's sum 4 - 2**-7.
    assert dec1.near_tie(c2, wh, torch.tensor([0.0, 2 - 2 ** -7, 0.0])).all()
    # logits [2**-8, 0] cancel from absolute sums of 2: a tie, where one
    # ulp of the larger logit (2**-15) would call it none.
    cancel = torch.tensor([[1.0, 1.0], [-1.0, -1.0]])
    assert dec1.near_tie(c2, cancel, torch.tensor([2 ** -8, 0.0])).all()
    assert not dec1.near_tie(c2, cancel, torch.tensor([2 ** -5, 0.0])).any()
    assert not dec1.near_tie(c2, wh[:, :1], torch.zeros(1)).any()
