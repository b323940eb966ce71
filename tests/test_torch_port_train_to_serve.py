"""The port's mirror of ``tests/test_train_to_serve.py``: train with the
port (``unetseg_tpu_torch.train``) on synthetic shapes at the JAX test's
size and asserts, from the JAX test's initial weights (``jax.random.key(0)``
and ``key(1)``, so both tests start from the same place), save a
checkpoint, serve it.

Both the port's CPU engine and the JAX engine serve the port-trained
checkpoint; wherever their masks are equal the contour JSON must be
byte-equal (the ``_mask.png`` pixels decide "equal"), and most slices must
be such (the float32 logits of the two packages differ in the last bits,
so a mask can part only at an exact tie).
"""

import json
import os

import cv2
import jax
import numpy as np
import pytest

from unetseg_tpu import engine as jax_engine
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import registry as jax_registry
from unetseg_tpu_torch import checkpoint, engine, train
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import synth_slice, training_batch
from unetseg_tpu_torch.io import raw as raw_io

from test_torch_port_native_ready import jax_native  # noqa: F401 (fixture)

CFG = ModelConfig(base_channels=8, depth=2, image_size=64,
                  compute_dtype="float32")


def _iou(a, b):
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else inter / union


def _train(cfg, rng, steps, seed, teacher=None, teacher_cfg=None):
    tx = train.make_optimizer(lr=1e-2, total_steps=steps)
    init = jax.device_get(jax_registry.init(
        jax.random.key(seed), JaxModelConfig(**vars(cfg))))
    state = train.state_from_params(init, tx, device="cpu")
    losses = []
    for _ in range(steps):
        imgs, labels = training_batch(rng, 8, size=64)
        if teacher is None:
            state, loss = train.train_step(state, (imgs, labels), cfg, tx)
        else:
            t_logits = train.logits(teacher, teacher_cfg, imgs)
            state, loss = train.distill_step(state, (imgs, labels, t_logits),
                                             cfg, tx)
        losses.append(float(loss))
    return state, losses


def _serve_both(ckpt, tmp_path, n, rng):
    """Both engines' artifacts for ``n`` RAWs of 64²: the names of the
    slices whose masks are equal and of those whose are not."""
    paths = []
    for i in range(n):
        p = str(tmp_path / "in" / f"case_{i:02d}.raw")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        raw_io.write_raw(p, synth_slice(rng, 64)[0])
        paths.append(p)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_engine.initialize_engine(ckpt, log_dir=str(tmp_path / "jlog"))
    try:
        assert jax_engine.process_batch(paths, 64, 64, [jdir] * n,
                                        emitter="native") == (n, 0)
    finally:
        jax_engine.cleanup_resources()
    assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "plog"),
                                    device="cpu")
    try:
        assert engine.process_batch(paths, 64, 64, [pdir] * n) == (n, 0)
    finally:
        engine.cleanup_resources()
    same, differ = [], []
    for p in paths:
        base = os.path.basename(p)[:-len(".raw")]
        masks = [cv2.imread(os.path.join(d, base + "_mask.png"),
                            cv2.IMREAD_UNCHANGED) for d in (jdir, pdir)]
        if not np.array_equal(*masks):
            differ.append(base)
            continue
        same.append(base)
        for d in (jdir, pdir):
            assert os.path.exists(os.path.join(d, base + ".json")), base
        assert open(os.path.join(jdir, base + ".json"), "rb").read() == \
            open(os.path.join(pdir, base + ".json"), "rb").read(), base
    return same, differ, pdir


def test_train_then_serve(tmp_path, jax_native):
    rng = np.random.default_rng(0)
    state, losses = _train(CFG, rng, 150, 0)
    assert losses[-1] < losses[0] * 0.3, losses[::25]

    # held-out IoU of the raw network (pre-cleanup)
    imgs, labels = training_batch(rng, 8, size=64)
    pred = train.predict_masks(state.params, CFG, imgs)
    iou = _iou(pred == 2, labels == 2)
    assert iou > 0.75, iou

    ckpt = str(tmp_path / "eng" / "trained.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    checkpoint.save(ckpt, checkpoint.params_to_jax(state.params), CFG)
    same, differ, pdir = _serve_both(ckpt, tmp_path, 6, rng)
    assert len(same) >= 5, differ

    # the organ is large (> 6% area): a polygon inside its bounding box
    raw, lab = synth_slice(rng, 64)
    raw_io.write_raw(str(tmp_path / "case.raw"), raw)
    out = tmp_path / "out"
    assert engine.initialize_engine(ckpt, device="cpu")
    try:
        assert engine.process_single_image(str(tmp_path / "case.raw"), 64,
                                           64, str(out))
    finally:
        engine.cleanup_resources()
    obj = json.loads((out / "case.json").read_text())
    assert obj["shapes"], "trained model produced no contour"
    pts = np.asarray(obj["shapes"][0]["points"])
    ys, xs = np.nonzero(lab == 2)
    cx, cy = pts[:, 0].mean(), pts[:, 1].mean()
    assert xs.min() - 8 <= cx <= xs.max() + 8
    assert ys.min() - 8 <= cy <= ys.max() + 8


def test_distill_slim_then_serve(tmp_path, jax_native):
    """A quick teacher, then a stem-2 student distilled against it; the
    student's masks agree with the teacher's; both engines serve it."""
    rng = np.random.default_rng(1)
    teacher, _ = _train(CFG, rng, 120, 0)
    s_cfg = ModelConfig(base_channels=8, depth=2, image_size=64,
                        compute_dtype="float32", stem=2)
    student, losses = _train(s_cfg, rng, 150, 1, teacher=teacher.params,
                             teacher_cfg=CFG)
    assert np.isfinite(losses[-1])

    imgs, _ = training_batch(rng, 8, size=64)
    t_pred = train.predict_masks(teacher.params, CFG, imgs)
    s_pred = train.predict_masks(student.params, s_cfg, imgs)
    agree = _iou(s_pred == 2, t_pred == 2)
    assert agree > 0.9, agree

    ckpt = str(tmp_path / "eng" / "slim.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    checkpoint.save(ckpt, checkpoint.params_to_jax(student.params), s_cfg)
    same, differ, pdir = _serve_both(ckpt, tmp_path, 4, rng)
    assert len(same) >= 3, differ
    assert os.path.exists(os.path.join(pdir, same[0] + "_mask.png"))


def test_training_entry_points_need_the_card_unless_told(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tx = train.make_optimizer(total_steps=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.init_state(0, CFG, tx)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.state_from_params(checkpoint.params_to_jax(
            train.init_state(0, CFG, tx, device="cpu").params), tx)
