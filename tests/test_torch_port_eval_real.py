"""The port's real-anatomy pass (``unetseg_tpu_torch.benchmarks.eval_real``)
against the JAX side on the CPU.

The package's copy of matplotlib's MR slice decodes to JAX's
``data.real_mri_slice()`` and is read without matplotlib; with neither file
the pass raises.  Variants rot0 and crop192 through every stage, into a
kept directory: their decoded masks meet the port's bf16 bar against JAX's
engine (equal but at pixels whose top-2 logits lie within 4 bf16 ulps of
the absolute head sum, ``dec1.near_tie_sums``), the served mask PNG is the
host cleanup of the port's decoded mask, the twin parity is at least 0.998
per variant (JAX's recorded run: 0.99864-0.99974), the batched artifacts
equal the serial ones and the mosaic's cleanup leaves nothing; nothing is
written under ``benchmarks/``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unetseg_tpu import checkpoint as jax_ckpt, data as jax_data
from unetseg_tpu import engine as jax_engine
from unetseg_tpu_torch import checkpoint, data
from unetseg_tpu_torch.benchmarks import eval_real
from unetseg_tpu_torch.engine import InferenceEngine
from unetseg_tpu_torch.io import native, png
from unetseg_tpu_torch.ops import dec1
from unetseg_tpu_torch.ops.decode import mask_to_image_np

from test_torch_port_native_ready import (  # noqa: F401 (fixtures)
    jax_native, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VARIANTS = ("rot0", "crop192")
SLIM4 = os.path.join(eval_real.MODELS_DIR, "flagship_slim4.ckpt")
BENCHMARKS = os.path.join(eval_real.REPO, "benchmarks")


def _tree(root):
    return sorted((d, f, os.path.getmtime(os.path.join(d, f)))
                  for d, _, fs in os.walk(root) for f in fs)


def test_package_slice_is_jaxs_and_needs_no_matplotlib(monkeypatch):
    want = jax_data.real_mri_slice()
    assert want is not None and want.shape == (256, 256)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    np.testing.assert_array_equal(data.real_mri_slice(), want)
    assert os.path.getsize(data.SAMPLE_SLICE) == 33229


def test_missing_slice_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(data, "SAMPLE_SLICE", str(tmp_path / "absent.gz"))
    assert data.real_mri_slice() is None
    with pytest.raises(FileNotFoundError):
        eval_real.evaluate("cpu", VARIANTS, str(tmp_path / "w"))


def test_variants_match_jax_and_every_stage_holds(tmp_path, jax_native):
    before = _tree(BENCHMARKS)
    out = eval_real.evaluate("cpu", VARIANTS, str(tmp_path),
                             log=lambda s: None)
    assert _tree(BENCHMARKS) == before
    rows = {r["variant"]: r for r in out["rows"]}
    assert sorted(rows) == sorted(VARIANTS)
    summary = out["summary"]
    assert summary["serving"] == "slim4" and summary["device"] == "cpu"
    assert summary["batched_byte_equal"] and summary["batched_variants"] == 1
    assert summary["mosaic_multiorgan_cleanup_empty"]
    assert summary["window_contours"] >= 1

    params, cfg = checkpoint.load(SLIM4)
    eng = InferenceEngine(params, cfg, "cpu")
    jparams, jcfg = jax_ckpt.load(SLIM4)
    jeng = jax_engine.InferenceEngine(jparams, jcfg)
    pool = dict(data.real_mri_pool())
    for name in VARIANTS:
        assert rows[name]["twin_parity"] >= 0.998, rows[name]
        assert rows[name]["contours"] >= 1
        u8 = native.preprocess_u8(pool[name], cfg.image_size)[None]
        with torch.no_grad():
            got = eng._masks(torch.from_numpy(u8))
            absum = chip_smoke.head_sums(
                torch, eng.model, torch.from_numpy(u8).float()[..., None]
                / 255.0)[1]
        logits, want = jeng._logits_and_mask(jparams, jnp.asarray(u8))
        want = torch.from_numpy(np.array(want))
        differ = got != want
        tie = dec1.near_tie_sums(torch.from_numpy(np.array(logits)), absum,
                                 ulps=4)
        assert not (differ & ~tie).any(), (name, int((differ & ~tie).sum()))
        served = png.read_png_gray(str(tmp_path / "A" / name
                                       / f"{name}_mask.png"))
        np.testing.assert_array_equal(served, mask_to_image_np(
            native.postprocess_batch(got.numpy())[0]))
