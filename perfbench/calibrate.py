"""Readings that the limits of ``limits/<workload>.json`` are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--seconds 3]

For each seed, in one process: a run of the cell (its numbers compared,
``gap_max`` among them), then the control: the reference put in the
program's place in float8 e4m3 (the precision below the configuration's
bfloat16), its classes judged by the same widest logit gap against the
float32 reference, on the same slices at the cell's size.  Where the cell
resamples on the device, also the u8's control: the float64 preprocess in
float16 (the program's own resample is float32, the step below the float64
that the host library states), and a fault, the RAW shifted by one pixel,
each read as ``u8_px`` is (the most pixels of one slice that differ from
the float64 preprocess).  One JSON line a seed.  Run on the card.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from perfbench import harness, inputs  # noqa: E402
from perfbench.reference import host  # noqa: E402
from perfbench.reference.unet import (  # noqa: E402
    Reference, first_max, widest_gap)


def control_gap(cfg: dict, traffic: dict, seed: int, device) -> float:
    """The widest gap of the control's classes on the run's slices."""
    raws = inputs.slices(seed, traffic["distinct_slices"], traffic["raw_size"])
    w = cfg["weights"]
    if w["kind"] == "checkpoint":
        params, _ = host.read_checkpoint(os.path.join(ROOT, w["path"]))
    else:
        params = inputs.seeded_params(cfg, seed, raws[: w["centre_on_slices"]],
                                      device)
    u8 = np.stack([host.preprocess_u8(r, cfg["image_size"]) for r in raws])
    ref = Reference(params, cfg["stem"], device).logits(u8)
    ctl = Reference(params, cfg["stem"], device, quant="fp8").logits(u8)
    return max(widest_gap(r, first_max(c)) for r, c in zip(ref, ctl))


def control_u8(traffic: dict, size: int, seed: int) -> dict:
    """``u8_px`` of the u8's control and of the shifted RAW."""
    raws = inputs.slices(seed, traffic["distinct_slices"], traffic["raw_size"])
    ref = [host.preprocess_u8(r, size) for r in raws]

    def px(u8s):
        return max(int((a != b).sum()) for a, b in zip(u8s, ref))
    return {"control_u8_px": px([host.preprocess_u8(r, size, np.float16)
                                 for r in raws]),
            "shift_u8_px": px([host.preprocess_u8(np.roll(r, 1, axis=1), size)
                               for r in raws])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    spec = harness.cell(args.workload)
    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed}
        with contextlib.redirect_stdout(sys.stderr):
            out = harness.run(args.workload, seed, args.seconds, False,
                              time.monotonic())
        line["correct"] = out["result"]["correct"]
        line["program"] = {k: c["value"] for k, c in out["checks"].items()}
        line["metrics"] = {k: m["value"] for k, m in
                           out["result"]["metrics"].items()}
        t = time.perf_counter()
        line["control_gap_max"] = control_gap(spec["config"], spec["traffic"],
                                              seed, "cuda")
        if not spec["traffic"]["host_preprocess"]:
            line.update(control_u8(spec["traffic"],
                                   spec["config"]["image_size"], seed))
        line["control_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
