"""The port's BASELINE report (``unetseg_tpu_torch.benchmarks.run_all``)
against the JAX script ``benchmarks/run_all.py`` on the CPU.

The report's keys are the JAX script's, read from its source text (the
script is not imported: it runs on import of its ``main`` only, and would
measure).  At 64², with a seeded float32 model (stem 1, base 8, depth 2,
random biases), one numpy tree in the JAX layout serving both: every value
finite and positive; the contour count of config 2 equals JAX's
``native.contours_per_class`` count on ``unetseg_tpu.data`` draws made in
the JAX script's order (which pins the draw order); config 2's and 2b's
masks equal JAX's ``dev`` and ``fused_all_device`` (its plain CCL) on the
same RAWs.
"""

import dataclasses
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu import data as jax_data
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import registry as jax_registry
from unetseg_tpu.ops import decode as jax_decode
from unetseg_tpu.ops import postprocess as jax_post
from unetseg_tpu.ops import preprocess as jax_pre
from unetseg_tpu_torch.benchmarks import run_all
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.engine import InferenceEngine
from unetseg_tpu_torch.models import registry

from test_torch_port_native_ready import (  # noqa: F401 (fixtures)
    jax_native, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
JCFG = JaxModelConfig(base_channels=8, depth=2, stem=1, image_size=SIZE,
                      compute_dtype="float32")
CFG = ModelConfig(**dataclasses.asdict(JCFG))
SLICES = 6


def _params(seed=0):
    """The port's seeded He-normal tree (the JAX layout, numpy arrays, which
    both packages load) with random biases, so every bias add counts."""
    params = registry.init(CFG, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)

    def fill(tree):
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            if k == "b":
                tree[k] = rng.standard_normal(v.shape).astype(np.float32) * .1
            elif isinstance(v, (dict, list)):
                fill(v)
    fill(params)
    return params


def _jax_report_keys():
    src = open(os.path.join(REPO, "benchmarks", "run_all.py")).read()
    keys = set(re.findall(r'report = \{"(\w+)": .*?, "(\w+)": ', src)[0])
    tiers = re.search(r"for tier in \(None, ([^)]*)\)", src).group(1)
    names = ["e2e"] + re.findall(r'"(\w+)"', tiers)
    for key in re.findall(r'report\[(f?)"(\w+(?:\{key\})?)"\]', src):
        if key[0]:
            keys |= {key[1].replace("{key}", n) for n in names}
        else:
            keys.add(key[1])
    return keys


@pytest.fixture(scope="module")
def report():
    return run_all.report(SLICES, "cpu", SIZE, (_params(), CFG, "seeded"))


def test_report_keys_are_the_jax_scripts(report):
    want = _jax_report_keys()
    assert len(want) == 22 and "c4_study_slices_per_sec_mask_json" in want
    assert set(report) == want


def test_report_values_are_finite_and_positive(report):
    assert report["device"] == "cpu" and report["checkpoint"] == "seeded"
    assert report["c4_study_slices"] == SLICES
    for key, v in report.items():
        if key not in ("device", "checkpoint"):
            assert isinstance(v, (int, float)) and math.isfinite(v) \
                and v > 0, (key, v)
    assert isinstance(report["c2_total_contours"], int)


def test_contour_count_pins_the_draw_order(report, jax_native):
    rng = np.random.default_rng(0)
    jax_data.synth_slice(rng, SIZE)           # config 1
    jax_data.synth_batch(rng, 32, SIZE)       # config 2's batch
    _, labels = jax_data.synth_batch(rng, 8, SIZE)
    want = sum(len(cs) for k in range(8)
               for cs in jax_native.contours_per_class(labels[k]).values())
    assert report["c2_total_contours"] == want


def test_config2_masks_equal_jax():
    params = _params()
    # class 2 raised a little, so its regions outlive the cleanup
    params["head"]["b"] = params["head"]["b"] + np.float32([0, 0, 0.2])
    raws, _ = jax_data.synth_batch(np.random.default_rng(3), 8, 96)

    @jax.jit
    def dev(p, r):
        _, x = jax_pre.preprocess_batch(r, SIZE)
        return jax_decode.decode_mask(jax_registry.apply(p, x, JCFG),
                                      JCFG.num_classes)

    @jax.jit
    def fused_all_device(p, r):
        return jax_post.postprocess_batch(dev(p, r), use_pallas_cc=False)

    c2, c2b = run_all.config2_programs(
        InferenceEngine(params, CFG, "cpu"), SIZE)
    got = c2(torch.from_numpy(raws)).numpy()
    want = np.asarray(dev(params, jnp.asarray(raws)))
    assert len(np.unique(want)) >= 2  # not one class only
    np.testing.assert_array_equal(got, want)
    got_b = c2b(torch.from_numpy(raws)).numpy()
    np.testing.assert_array_equal(
        got_b, np.asarray(fused_all_device(params, jnp.asarray(raws))))
    assert 0.5 < (got_b == 2).mean() < 0.95 and not (got_b == 1).any()
    assert (got_b != np.where(got == 2, 2, 0)).any()  # the cleanup acted
