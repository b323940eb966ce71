"""End-to-end demo: train on synthetic shapes -> checkpoint -> serve a RAW
slice through the engine -> polygon JSON -> evaluate.  The port of
``examples/end_to_end.py``.

    python -m unetseg_tpu_torch.examples.end_to_end [--out DIR]
        [--steps N] [--full] [--device cuda]

By default a small float32 model at 64² (its 3x3 convs in the float32
conv kernel on the card, under autograd); ``--full`` trains the 512²
flagship ``ModelConfig()`` in bf16.  Writes ``DIR/engine/model.ckpt`` and
the five artifacts under ``DIR/results``.
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
                                                  "unetseg_demo"))
    ap.add_argument("--full", action="store_true",
                    help="the 512² flagship model")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from unetseg_tpu_torch import checkpoint, engine, metrics, train
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.data import synth_slice, training_batch
    from unetseg_tpu_torch.io import native, raw as raw_io

    size = 512 if args.full else 64
    cfg = (ModelConfig() if args.full else
           ModelConfig(base_channels=8, depth=2, image_size=64,
                       compute_dtype="float32"))
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)

    # 1. train
    tx = train.make_optimizer(lr=1e-2, total_steps=args.steps)
    state = train.init_state(0, cfg, tx, device=args.device)
    for i in range(args.steps):
        imgs, labels = training_batch(rng, 8, size=size)
        state, loss = train.train_step(state, (imgs, labels), cfg, tx)
        if i % 25 == 0:
            print(f"step {i:4d} loss {float(loss):.4f}")

    # 2. checkpoint (the engine's plan-file analog)
    cache = os.path.join(args.out, "engine", "model.ckpt")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    checkpoint.save(cache, checkpoint.params_to_jax(state.params), cfg)

    # 3. serve
    results = os.path.join(args.out, "results")
    if not engine.initialize_engine(cache, device=args.device):
        raise RuntimeError(f"initialize_engine failed on {cache}")
    try:
        raw, gt = synth_slice(rng, size)
        raw_path = os.path.join(args.out, "case_001.raw")
        raw_io.write_raw(raw_path, raw)
        if not engine.process_single_image(raw_path, size, size, results):
            raise RuntimeError(f"process_single_image failed on {raw_path}")
        print("process_single_image: True")

        # 4. evaluate the polygon JSON against the ground truth's contours
        cj = os.path.join(results, "case_001.json")
        if os.path.exists(cj):
            with open(cj) as f:
                contours = [[tuple(p) for p in s["points"]]
                            for s in json.load(f)["shapes"]]
            gt_contours = native.extract_contours(
                np.where(gt == 2, np.uint8(255), np.uint8(0)))
            iou = metrics.polygon_iou(contours, gt_contours, size, size)
            print(f"polygon IoU vs ground truth: {iou:.4f}")
    finally:
        engine.cleanup_resources()
    print("artifacts in", results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
