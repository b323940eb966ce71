"""The control of every cell fails the cell's limit: the reference in the
program's place, computed in float8 e4m3 (the precision below the
configurations' bfloat16), judged by the same widest logit gap; and, where
the cell resamples on the device, the float64 preprocess in float16 (the
step below the program's float32 resample) and a RAW shifted by one pixel
fail ``u8_px``.  On the CPU at a small size; on the card at the cell's own
size, three seeds."""

import pytest

from perfbench import harness
from perfbench.calibrate import control_gap, control_u8

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
DEVICE_RESAMPLE = [n for n in CELLS
                   if not harness.cell(n)["traffic"]["host_preprocess"]]
SMALL = {"flagship": {"base_channels": 16, "depth": 2, "image_size": 64}}
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_small(name):
    spec = harness.cell(name)
    cfg = {**spec["config"], **SMALL.get(spec["workload"]["config"], {})}
    traffic = dict(spec["traffic"], distinct_slices=4)
    if cfg["image_size"] < 512:
        traffic["raw_size"] = 96
    gap = control_gap(cfg, traffic, 2 ** 31 + 17, "cpu")
    assert gap > spec["limits"]["gap_max"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_at_cell_size(card, name, seed):
    spec = harness.cell(name)
    gap = control_gap(spec["config"], spec["traffic"], seed, card)
    assert gap > spec["limits"]["gap_max"]


@pytest.mark.parametrize("name", DEVICE_RESAMPLE)
@pytest.mark.parametrize("seed", SEEDS)
def test_u8_control_fails_at_cell_size(name, seed):
    # host arithmetic only: the cell's own sizes on the CPU, 4 slices
    spec = harness.cell(name)
    got = control_u8(dict(spec["traffic"], distinct_slices=4),
                     spec["config"]["image_size"], seed)
    limit = spec["limits"]["u8_px"]
    assert got["control_u8_px"] > limit and got["shift_u8_px"] > limit
