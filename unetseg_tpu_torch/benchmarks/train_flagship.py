"""Train the flagship 512² UNet on synthetic CT-like data with the port.

The port of ``benchmarks/train_flagship.py``, the recipe the default
flagship was trained with: ``ModelConfig(remat=True)`` (bf16 compute,
every encoder and decoder stage rematerialized), batch 8 drawn from a pool
of 128 ``data.training_batch`` slices (seed 42, reshuffled each pass), the
optimizer of ``train.make_optimizer(lr=3e-4, total_steps=steps)``; then the
foreground IoU of the argmax (no cleanup) on ``training_batch(
default_rng(1234), 16)``, and a serve-config checkpoint (no remat, params
stored float16 as the JAX script stores them).  Its 3x3 convs run in the
conv kernels on the card, forward and data gradient (``train.py``)::

    python -m unetseg_tpu_torch.benchmarks.train_flagship [steps] [out.ckpt]

``chip_smoke.py`` calls :func:`run` with a few dozen steps.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from unetseg_tpu_torch import checkpoint, data, metrics, train
from unetseg_tpu_torch.config import ModelConfig

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "models", "flagship_synth.ckpt")


def run(steps: int = 300, out: str = DEFAULT_OUT, *, batch: int = 8,
        n_train: int = 128, lr: float = 3e-4,
        cfg: ModelConfig = ModelConfig(remat=True), device: str = "cuda",
        seed: int = 0, log=print) -> dict:
    """Train for ``steps`` steps and save to ``out`` (None: no file).
    Returns the losses, ms per step after the first (host clock around a
    synchronised step), the validation IoU and the final state."""
    dev = torch.device(device)
    tx = train.make_optimizer(lr=lr, total_steps=steps)
    state = train.init_state(seed, cfg, tx, device=device)
    rng = np.random.default_rng(42)
    t0 = time.perf_counter()
    imgs, labels = data.training_batch(rng, n_train)
    log(f"data gen: {time.perf_counter() - t0:.1f}s for {n_train} slices")
    imgs_t, labels_t = torch.from_numpy(imgs), torch.from_numpy(labels)
    order = np.arange(n_train)
    losses, step_s = [], []
    per_pass = max(1, n_train // batch)
    for s in range(steps):
        if s % per_pass == 0:
            rng.shuffle(order)
        start = (s * batch) % n_train
        idx = torch.from_numpy(order[start:start + batch])
        b = (imgs_t[idx].to(dev), labels_t[idx].to(dev))
        t1 = time.perf_counter()
        state, loss = train.train_step(state, b, cfg, tx)
        losses.append(float(loss))  # synchronises
        step_s.append(time.perf_counter() - t1)
        if s % 25 == 0 or s == steps - 1:
            log(f"step {s:4d} loss {losses[-1]:.4f} "
                f"({np.mean(step_s[1:] or step_s) * 1e3:.0f} ms/step)")
    vi, vl = data.training_batch(np.random.default_rng(1234), 16)
    pred = np.concatenate([train.predict_masks(state.params, cfg,
                                               vi[i:i + batch])
                           for i in range(0, len(vi), batch)])
    fg_iou = float(np.mean([metrics.foreground_iou(pred[i], vl[i])
                            for i in range(len(vl))]))
    log(f"val foreground IoU (argmax, no postprocess): {fg_iou:.4f}")
    if out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        params = _tree_map(lambda a: np.asarray(a, np.float16),
                           checkpoint.params_to_jax(state.params))
        checkpoint.save(out, params, dataclasses.replace(cfg, remat=False))
        log(f"saved {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return {"losses": losses, "ms_per_step": float(np.mean(
        step_s[1:] or step_s) * 1e3), "val_fg_iou": fg_iou, "state": state}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    steps = int(argv[0]) if argv else 300
    out = argv[1] if len(argv) > 1 else DEFAULT_OUT
    run(steps, out)


if __name__ == "__main__":
    main()
