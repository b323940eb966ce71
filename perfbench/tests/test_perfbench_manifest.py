"""BENCHMARK.json against the contract: names, units, the files each cell
and metric is found by, and which cells report which metric."""

import json
import os
import re

import pytest

from perfbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for text in (entry.get("why"), entry.get("layer")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text
            assert "\t" not in text


def test_names_unique():
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) \
        == len(MAN["workloads"])
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("work", MAN["workloads"],
                         ids=lambda w: w["name"])
def test_cell_files_found(work):
    spec = harness.cell(work["name"])
    assert spec["config"]["source"]
    assert spec["traffic"]["kind"] == "study"
    assert work["chips"] in (1, 4)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_reported(metric):
    assert callable(harness.reader(metric["name"]))
    moved = next(m for m in MAN["end_to_end"]
                 if m["name"] == metric["moves"])
    for w in metric["workloads"]:
        assert "workloads" not in moved or w in moved["workloads"]


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            json.load(f)


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_full_check_fits():
    # 2 + 14 runs a cell of run_seconds + 60 s, 180 s a cell to compile and
    # 1200 s spare, for the 24 cells later PRs may reach
    cells = 24
    assert ((2 + 14 * cells) * (MAN["run_seconds"] + 60) + cells * 180
            + 1200) <= 43200
