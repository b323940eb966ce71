"""The trace's reduction: busy time, kernels by name, idle gaps named by
the innermost host span at their middle."""

import pytest

from perfbench.trace import WINDOW, Trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduction():
    t = Trace([
        _ev("user_annotation", WINDOW, 0, 100),
        _ev("kernel", "conv3x3_wgmma_kernel<64>", 10, 20),
        _ev("kernel", "conv3x3_wgmma_kernel<64>", 25, 10),   # overlaps
        _ev("gpu_memcpy", "Memcpy DtoH", 60, 10),
        _ev("kernel", "late", 95, 20),                        # clipped
        _ev("cpu_op", "outer", 30, 40),
        _ev("user_annotation", "native.emit_batch", 40, 15),
    ])
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx((25 + 10 + 5) * 1e-6)
    n, s = t.kernels(lambda k: "conv3x3" in k)
    assert n == 2 and s == pytest.approx(30e-6)
    gaps = dict(t.idle_gaps())
    # gaps 0-10 (none), 35-60 (mid 47.5: emit), 70-95 (none)
    assert gaps["native.emit_batch"] == pytest.approx(25e-6)
    assert gaps["no traced host span"] == pytest.approx(35e-6)
    assert t.device_ops()[0][0] == "conv3x3_wgmma_kernel<64>"
