"""A whole run on the CPU at a small size, the harness's look for a card
skipped: ``correct`` holds on the sound path and comes out false with the
timed path broken underneath, once for each fault the cell can have (an
answer altered where it is produced; half of a batch left out; the
preprocessed u8 shifted by a pixel where it is made, on the host or on
the device)."""

import json
import subprocess
import sys

import pytest

from perfbench import harness

STUDY = {"distinct_slices": 4, "study_slices": 10, "batch": 4,
         "warm_studies": 1, "raw_size": 96}
# the benchmark's cell at a small size, and the study generator's other
# path on it: the host library's resample and contour JSON artifacts
# (stem 4, as the shipped slim4 serves them), no callback
CELLS = {
    "device_resample": ("flagship.study_masks", {
        "config": {"base_channels": 16, "depth": 2, "image_size": 64},
        "traffic": STUDY}),
    "host_json": ("flagship.study_masks", {
        "config": {"base_channels": 16, "depth": 2, "image_size": 64,
                   "stem": 4},
        "traffic": {**STUDY, "host_preprocess": True, "artifacts": "json",
                    "emit_callback": False},
        "limits": {"contour_files": 0, "u8_px": 0}}),
}
# the number that each fault has to fail
CAUGHT_BY = {"alter": "gap_max", "half": "gap_max", "u8": "u8_px"}
# Each run is its own process: this one holds what the repository's test
# set-up loaded (the JAX package among it), which a run refuses.
DRIVER = """
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, {root!r})
from perfbench import harness
from unetseg_tpu_torch import engine
from unetseg_tpu_torch.io import native
from unetseg_tpu_torch.ops import preprocess

FAULTS = {{
    "alter": lambda m: m[0, : m.shape[1] // 4].copy_(
        (m[0, : m.shape[1] // 4] + 1) % 3),
    "half": lambda m: m[m.shape[0] // 2:].zero_(),
}}
fault = {fault!r}


def plant(run):
    if fault == "u8":
        host_u8, device_u8 = native.preprocess_u8, preprocess.preprocess_batch

        def shifted_host(raw, out_size=512):
            return np.roll(host_u8(raw, out_size), 1, axis=1)

        def shifted_device(raws, out_size=preprocess.OUT_SIZE):
            u8 = torch.roll(device_u8(raws, out_size)[0], 1, dims=-1)
            return u8, preprocess.model_input_from_u8(u8)[..., None]
        native.preprocess_u8 = shifted_host
        preprocess.preprocess_batch = shifted_device
        return
    orig = engine.InferenceEngine._masks_on

    def broken(self, i, u8, x=None):
        m = orig(self, i, u8, x).clone()
        FAULTS[fault](m)
        return m
    engine.InferenceEngine._masks_on = broken


out = harness.run({name!r}, 2 ** 31 + 5, 0.5, False, time.monotonic(),
                  device="cpu", overrides={ov!r},
                  fault=plant if fault else None)
print(json.dumps(out["result"]))
"""


def _run(name, fault=None):
    cell, ov = CELLS[name]
    code = DRIVER.format(root=harness.ROOT, name=cell, fault=fault, ov=ov)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["u8_unjudged"]["value"] == 0
    assert set(CELLS[name][1].get("limits", {})) <= set(r["checks"])
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in sorted(CELLS) for f in sorted(CAUGHT_BY)])
def test_broken_run_is_not_correct(name, fault):
    r = _run(name, fault)
    assert not r["correct"]
    check = r["checks"][CAUGHT_BY[fault]]
    assert check["value"] > check["limit"]
