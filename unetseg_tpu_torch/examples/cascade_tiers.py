"""Cascade routing and artifact tiers: the port of
``examples/cascade_tiers.py``.

    python -m unetseg_tpu_torch.examples.cascade_tiers [--out DIR]
        [--device cuda]

Builds three small checkpoints (a serving student, a co-student for the
disagreement router, a larger fallback), initializes the engine with the
``disagree`` cascade (slices where the two students' masks differ at more
than 16 pixels go to the fallback), and processes a directory at the
``json`` artifact tier (the size and contour JSONs only; ``full`` writes
all five reference artifacts) into ``DIR/artifacts``.

The same through the other entry points:
    REPL:     init student.ckpt --cascade-disagree co.ckpt fallback.ckpt 16
              process --batched --tier json <dir> 64 64 <out>
    service:  {"cmd": "init", ..., "cascade_router": "disagree", ...}
              {"cmd": "process", ..., "tier": "json"}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "unetseg_cascade_demo"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from unetseg_tpu_torch import checkpoint, engine
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.data import synth_slice
    from unetseg_tpu_torch.io import raw as raw_io

    out = args.out
    os.makedirs(out, exist_ok=True)
    small = dict(base_channels=8, depth=2, image_size=64,
                 compute_dtype="float32")

    # the co-student differs by seed: the router's signal is their
    # disagreement
    student = os.path.join(out, "student.ckpt")
    co = os.path.join(out, "co.ckpt")
    fallback = os.path.join(out, "fallback.ckpt")
    checkpoint.create(student, ModelConfig(**small), seed=0)
    checkpoint.create(co, ModelConfig(**small), seed=1)
    checkpoint.create(fallback, ModelConfig(**{**small, "base_channels": 16}),
                      seed=2)

    # a tiny study of RAW slices
    rng = np.random.default_rng(0)
    study = os.path.join(out, "study")
    os.makedirs(study, exist_ok=True)
    for i in range(4):
        raw_io.write_raw(os.path.join(study, f"s{i}_64_64.raw"),
                         synth_slice(rng, 64)[0])

    if not engine.initialize_engine(
            student, log_dir=os.path.join(out, "log"), device=args.device,
            cascade_ckpt=fallback, cascade_router="disagree",
            cascade_co_ckpt=co,
            cascade_threshold=16.0):  # > 16 px of the masks disagree
        raise RuntimeError("initialize_engine with the cascade failed")
    try:
        paths = sorted(os.path.join(study, f) for f in os.listdir(study))
        art = os.path.join(out, "artifacts")
        ok, fail = engine.process_batch(paths, 64, 64, [art] * len(paths),
                                        batch_size=4, tier="json")
        print(f"processed ok={ok} fail={fail}")
        if (ok, fail) != (len(paths), 0):
            raise RuntimeError(f"process_batch: ok={ok} fail={fail}")
        arts = sorted(os.listdir(art))
        print("artifacts (json tier):", arts)
        # json tier: the size JSON always, the contour JSON where there are
        # contours
        if not all(a.endswith(".json") for a in arts):
            raise RuntimeError(f"the json tier wrote {arts}")
        one = [a for a in arts if a.endswith("_original_sizes.json")][0]
        with open(os.path.join(art, one)) as f:
            print("size record:", json.dumps(json.load(f)))
    finally:
        engine.cleanup_resources()
    return 0


if __name__ == "__main__":
    sys.exit(main())
