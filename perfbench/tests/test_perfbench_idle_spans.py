"""The study thread's metrics: the device's idle time while one of its
spans was open (a hand-built trace, shares computed by hand), and its
stages per slice, none where the program records no such stage."""

import pytest

from perfbench import harness
from perfbench.trace import WINDOW, Trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(*spans):
    # busy 10-30, 50-60 and 95-100 (a kernel cut at the window's end):
    # idle 0-10, 30-50 and 60-95, 65 of the window's 100
    return Trace([
        _ev("user_annotation", WINDOW, 0, 100),
        _ev("kernel", "conv3x3_wgmma_kernel<64>", 10, 20),
        _ev("gpu_memcpy", "Memcpy DtoH", 50, 10),
        _ev("kernel", "late", 95, 25),
        *spans,
    ])


IDLE = ["idle_load_wait_pct.study", "idle_cleanup_pct.study",
        "idle_dispatch_pct.study"]
STAGE_MS = {"load_wait_ms_per_slice.study": "wait_load",
            "dispatch_ms_per_slice.study": "dispatch",
            "d2h_wait_ms_per_slice.study": "d2h"}


def test_idle_while_spans():
    tr = _trace(
        # two overlapping spans of one name, over busy time: idle 5-10
        # and 30-40
        _ev("user_annotation", "study.wait_load", 5, 15),
        _ev("user_annotation", "study.wait_load", 15, 25),
        # cut off at the window's end: idle 60-95
        _ev("user_annotation", "study.cleanup", 55, 55),
        # one begun before the window (idle 0-4), one over a copy's
        # start (idle 45-50)
        _ev("user_annotation", "study.dispatch", -10, 14),
        _ev("user_annotation", "study.dispatch", 45, 7),
        # the loaders' spans: other names, counted by none
        _ev("user_annotation", "study.load", 0, 100),
        _ev("cpu_op", "study.wait_load_x", 60, 30),
    )
    got = [harness.reader(m)({"trace": tr}) for m in IDLE]
    assert got == pytest.approx([15.0, 35.0, 9.0])
    idle = harness.reader("device_idle_pct.study")({"trace": tr})
    assert idle == pytest.approx(65.0) and sum(got) <= idle


@pytest.mark.parametrize("metric", IDLE)
def test_idle_while_nothing_to_read(metric):
    read = harness.reader(metric)
    assert read({}) is None and read({"trace": None}) is None
    # a program without the study thread's spans (or none in the window)
    out = _ev("user_annotation", "study.cleanup", 100, 10)
    assert read({"trace": _trace(out)}) is None


@pytest.mark.parametrize("metric,stage", sorted(STAGE_MS.items()))
def test_stage_ms_per_slice(metric, stage):
    read = harness.reader(metric)
    assert read({"slices_untraced": 300,
                 "stages": {stage: 0.6, "load": 9.0}}) == pytest.approx(2.0)
    # the parent's timer has no such stage
    assert read({"slices_untraced": 300, "stages": {"load": 9.0}}) is None
    assert read({"slices_untraced": 0, "stages": {stage: 0.6}}) is None
