"""The port's distribution-shift report
(``unetseg_tpu_torch.benchmarks.eval_shift``) against the JAX script's
computation (``benchmarks/eval_shift.py``) on the CPU, on the shipped slim4
and one off-family kind at n = 2.

The slices are the JAX script's (the same crc32 seed and draws).  The
student's masks equal JAX's ``make_pred`` masks (u8 / 255, ``registry.apply``,
argmax) except at pixels whose top-2 logits lie within bf16 rounding of a
tie (``dec1.near_tie_sums``, 4 ulps of the absolute head sum: the port's
bf16 bar); the report's IoU fields lie within 1e-4 of JAX's metrics on
JAX's masks, its boundary misses equal JAX's, and the pipeline's polygon
IoU against the reference twin is at least 0.999.
"""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unetseg_tpu import checkpoint as jax_ckpt, data as jax_data
from unetseg_tpu import metrics as jax_metrics
from unetseg_tpu.io import native as jax_native_mod
from unetseg_tpu.models import registry as jax_registry
from unetseg_tpu_torch import checkpoint
from unetseg_tpu_torch.benchmarks import eval_shift
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.ops import dec1

from test_torch_port_native_ready import (  # noqa: F401 (fixtures)
    jax_native, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KIND, N = "crescent", 2
SLIM4 = os.path.join(eval_shift.MODELS_DIR, "flagship_slim4.ckpt")


@pytest.fixture(scope="module")
def jax_side():
    """The JAX script's slices of KIND and its student's logits on them."""
    rng = np.random.default_rng(zlib.crc32(KIND.encode()) % 2**31)
    raws, labels = zip(*[jax_data.synth_slice_shifted(rng, 512, KIND)
                         for _ in range(N)])
    u8 = np.stack([jax_native_mod.preprocess_u8(r, 512) for r in raws])
    params, cfg = jax_ckpt.load(SLIM4)
    x = jnp.asarray(u8, jnp.float32)[..., None] / 255.0
    logits = np.array(jax.jit(
        lambda p, x: jax_registry.apply(p, x, cfg))(params, x))
    return np.stack(labels), u8, logits


def test_slices_are_the_jax_scripts(jax_side, jax_native):
    labels, u8, _ = jax_side
    _, got_labels, got_u8 = eval_shift.shifted_slices(KIND, N)
    np.testing.assert_array_equal(got_labels, labels)
    np.testing.assert_array_equal(got_u8, u8)


def test_student_masks_meet_the_bf16_bar(jax_side):
    _, u8, logits = jax_side
    params, cfg = checkpoint.load(SLIM4)
    got = torch.from_numpy(eval_shift.make_pred(params, cfg, "cpu")(u8))
    want_logits = torch.from_numpy(logits)
    want = want_logits.argmax(-1).to(torch.uint8)
    model = registry.build(params, cfg, device="cpu")
    with torch.no_grad():
        x = torch.from_numpy(u8).float()[..., None] / 255.0
        absum = chip_smoke.head_sums(torch, model, x)[1]
    differ = got != want
    tie = dec1.near_tie_sums(want_logits, absum, ulps=4)
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    assert (want == 2).any()


def test_report_matches_jax_metrics(jax_side):
    labels, _, logits = jax_side
    masks = logits.argmax(-1).astype(np.uint8)
    report = eval_shift.evaluate(N, (KIND,), "cpu", log=lambda *a: None)
    assert report["student"] == "slim4" and report["teacher"] is None
    got = report[KIND]
    ious = [float(jax_metrics.foreground_iou(masks[i], labels[i]))
            for i in range(N)]
    assert abs(got["student_fg_iou"] - np.mean(ious)) <= 1e-4
    assert abs(got["student_fg_iou_min"] - np.min(ious)) <= 1e-4
    misses = sum(not np.isfinite(jax_metrics.boundary_distances(
        masks[i], labels[i])["hd95"]) for i in range(N))
    assert got["student_boundary_misses"] == misses
    assert got["pipeline_twin_parity"] >= 0.999
    assert got["teacher_fg_iou"] is None and got["agreement_min"] is None
