"""One run of one cell: find the cell's files by name, set up, run the
window, judge what the timed path produced, and build the result line.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the sizes as run, the weights' origin, and
  under ``"reference"`` the module that models it (``family``);
* ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  generator in ``kinds/`` that runs it;
* ``limits/<workload>.json``: the limit of each number compared;
* ``layer_metrics/<metric>.py``: a ``read(ctx)`` that returns the metric or
  None where it finds nothing to read.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import inputs, peaks
from perfbench.reference import host

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "unetseg_tpu")


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(name: str, man: Optional[dict] = None) -> dict:
    """The workload entry, its configuration, traffic and limits, and the
    metrics it reports untraced (``end_to_end``) and traced
    (``per_layer``)."""
    man = man or manifest()
    work = next((w for w in man["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def reported(m):
        return "workloads" not in m or name in m["workloads"]

    return {"workload": work,
            "config": {"name": work["config"],
                       **_json("configs", work["config"] + ".json")},
            "traffic": _json("traffic", work["traffic"] + ".json"),
            "limits": _json("limits", name + ".json"),
            "end_to_end": [m for m in man["end_to_end"] if reported(m)],
            "per_layer": [m for m in man["per_layer"] if reported(m)]}


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    path = os.path.join(HERE, "layer_metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench.layer_metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


#: What a configuration's reference module exports
#: (``perfbench/reference/__init__.py``).
FAMILY = ("init", "centre", "Reference", "flops_per_slice")


def family(cfg: dict):
    """The module that the configuration's ``"reference"`` names (a path
    from the checkout's root), loaded by path once a process: its seeded
    weights, where its head takes the bias, its reference model and its
    FLOPs a slice."""
    where = f"perfbench/configs/{cfg.get('name')}.json"
    rel = cfg.get("reference")
    if not rel:
        raise ValueError(f"{where}: no \"reference\" names the module of "
                         f"its model")
    path = os.path.join(ROOT, rel)
    if os.path.isabs(rel) or ".." in rel.split("/") or \
            not os.path.isfile(path):
        raise ValueError(f"{where}: its reference {rel!r} is no file of the "
                         f"checkout")
    name = os.path.splitext(os.path.normpath(rel))[0].replace(os.sep, ".")
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    missing = [n for n in FAMILY if not hasattr(mod, n)]
    if missing:
        raise ValueError(f"{where}: its reference {rel} lacks {missing}")
    return mod


class ForbiddenModules(RuntimeError):
    """A module of JAX or of the JAX package was loaded."""


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def refuse_forbidden() -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules loaded that the port may not load: "
                               f"{found}")


@dataclasses.dataclass
class Run:
    """A run's state, shared by the harness and its kind."""

    name: str
    cfg: dict
    traffic: dict
    seed: int
    device: str
    tmp: str
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    #: the configuration's reference module (``family``)
    family: object = None
    #: filled by the kind: end-to-end values, the per-layer readers'
    #: context, the numbers compared, and things to print.
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    ctx: Dict[str, object] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)
    state: Dict[str, object] = dataclasses.field(default_factory=dict)

    def part(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.setup_parts[name] = self.setup_parts.get(name, 0.0) + now - t0
        return now


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from unetseg_tpu_torch.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def weights(run: Run, raws: np.ndarray):
    """(reference params, program params, program ModelConfig, checkpoint
    path or None) of the run's configuration.  A checkpoint is read by
    both sides, each with its own reader; seeded weights are drawn on the
    device from the run's seed and handed to each side as its own copy."""
    w = run.cfg["weights"]
    if w["kind"] == "checkpoint":
        from unetseg_tpu_torch import checkpoint

        path = os.path.join(ROOT, w["path"])
        ref, stored = host.read_checkpoint(path)
        for k, v in stored.items():
            if k in run.cfg and run.cfg[k] != v:
                raise ValueError(f"{path}: {k} is {v}, the configuration "
                                 f"says {run.cfg[k]}")
        params, mcfg = checkpoint.load(path)
        return ref, params, mcfg, path
    if w["kind"] == "seeded":
        tree = inputs.seeded_params(run.cfg, run.seed,
                                    raws[: w["centre_on_slices"]], run.device,
                                    run.family)
        return tree, copy.deepcopy(tree), model_config(run.cfg), None
    raise ValueError(f"unknown weights kind {w['kind']!r}")


def build(run: Run) -> None:
    """Import the program and load (on a first run: build) the libraries
    this configuration runs, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from perfbench import counts
    from unetseg_tpu_torch.io import native

    loads = [native.load]
    if torch.device(run.device).type == "cuda":
        from unetseg_tpu_torch.ops import conv, dec1

        loads.append(conv.load)
        if counts.fused_last_level(run.cfg):
            loads.append(dec1.load)
    with ThreadPoolExecutor(len(loads)) as pool:
        for f in [pool.submit(fn) for fn in loads]:
            f.result()


def _judge(values: Dict[str, float], limits: Dict[str, float]):
    checks = {}
    for name, value in values.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r}")
        checks[name] = {"value": value, "limit": limits[name]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def run(workload: str, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda",
        overrides: Optional[dict] = None,
        fault: Optional[Callable] = None) -> dict:
    """One run.  ``overrides`` replaces entries of the configuration, the
    traffic and the limits (``{"config": {...}, "traffic": {...},
    "limits": {...}}``: small sizes and the generator's other paths for the
    CPU tests); ``fault(run)`` is called after set-up to break the timed
    path underneath (the tests' faults)."""
    spec = cell(workload)
    over = overrides or {}
    cfg = {**spec["config"], **over.get("config", {})}
    traffic = {**spec["traffic"], **over.get("traffic", {})}
    limits = {**spec["limits"], **over.get("limits", {})}
    tmp = os.path.join(tempfile.gettempdir(), "perfbench", workload)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    r = Run(workload, cfg, traffic, seed, device, tmp, family=family(cfg))
    kind = importlib.import_module("perfbench.kinds." + traffic["kind"])
    cuda = torch.device(device).type == "cuda"

    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats()
    t = r.part("cuda_init", t)
    build(r)
    r.part("import_and_build", t)
    kind.prepare(r)
    if fault is not None:
        fault(r)
    setup_s = time.monotonic() - t_start

    try:
        kind.window(r, seconds, traced)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        kind.release(r)
    refuse_forbidden()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    correct, checks = _judge(kind.judge(r), limits)
    r.notes.append(f"judge_s {time.perf_counter() - t_judge:.3f}")
    shutil.rmtree(tmp, ignore_errors=True)

    if traced:
        metrics = {}
        for m in spec["per_layer"]:
            v = reader(m["name"])(r.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {**r.e2e, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": spec["workload"]["chips"],
           "memory_peak_bytes": int(peak)}
    trace = r.ctx.get("trace")
    if traced and trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
    card = peaks.card() if cuda else {}
    if card:
        dev["power_limit"] = card["power_limit"]
    r.notes.insert(0, "setup " + json.dumps(
        {"setup_s": setup_s, **r.setup_parts}))
    result = {"correct": bool(correct and r.failed == 0),
              "attempted": r.attempted, "failed": r.failed,
              "metrics": metrics, "device": dev}
    if traced and trace is not None:
        from perfbench.trace import summary
        result["breakdown"] = summary(trace)
    refuse_forbidden()
    result["checks"] = {**checks,
                        "failed": {"value": r.failed, "limit": 0}}
    return {"result": result, "notes": r.notes, "checks": result["checks"]}
