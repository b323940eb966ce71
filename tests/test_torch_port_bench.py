"""``python -m unetseg_tpu_torch.bench`` on the CPU: one JSON line with
exactly the keys of the repo's ``bench.py``.

The bench reads its checkpoint from ``bench.MODELS_DIR``; the test points
that at a directory holding a small float32 checkpoint written by the JAX
package under the slim4 name, so the accuracy, boundary and parity keys are
all computed (against the numpy twin), and runs ``main(device="cpu")`` at
batch 4.
"""

import ast
import json
import os
import sys
import time

from unetseg_tpu import checkpoint as jax_ckpt
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = JaxModelConfig(base_channels=8, depth=2, image_size=64,
                       compute_dtype="float32")


def _bench_py_keys():
    """The keys of the JSON line ``bench.py`` prints: its largest
    ``json.dumps`` of a dict literal (the other is the outage report)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    dicts = [node.args[0] for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "attr", None) == "dumps"
             and node.args and isinstance(node.args[0], ast.Dict)]
    keys = [k.value for k in max(dicts, key=lambda d: len(d.keys)).keys]
    assert "p50_ms_note" in keys and "parity_polygon_iou" in keys
    return keys


def test_bench_prints_bench_py_keys(tmp_path, monkeypatch, capsys):
    models = tmp_path / "models"
    models.mkdir()
    jax_ckpt.create(str(models / "flagship_slim4.ckpt"), SMALL, seed=0)
    monkeypatch.setattr(bench, "MODELS_DIR", str(models))
    monkeypatch.setattr(bench, "FLAGSHIP", str(models / "flagship_synth.ckpt"))
    monkeypatch.setattr(sys, "argv", ["bench", "4"])
    t0 = time.perf_counter()
    assert bench.main(device="cpu") == 0
    seconds = time.perf_counter() - t0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == _bench_py_keys()
    assert seconds < 60
    assert out["serving_checkpoint"] == "slim4" and out["serving_batch"] == 4
    assert out["value"] > 0 and out["p50_ms"] > 0 and out["h2d_gbps"] > 0
    assert 0 <= out["fg_iou_min"] <= out["fg_iou"] <= 1
    assert out["gate_fg_iou_min"] == (out["fg_iou_min"] >= 0.999)
    # the served path (plain float32 convs here) against the numpy twin
    assert out["parity_polygon_iou"] >= 0.999
    assert out["agreement_polygon_iou"] is None
    assert out["agreement_polygon_iou_min"] is None
    assert out["boundary_miss_count"] is not None
    assert "TPU" not in out["p50_ms_note"] and "tunnel" not in out[
        "p50_ms_note"]


def test_bench_rejects_a_bad_batch(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["bench", "zero"])
    try:
        bench.main(device="cpu")
    except SystemExit as e:
        assert e.code == 2
    else:
        raise AssertionError("a bad batch argument must exit 2")
