"""Train-state checkpoints between the two packages, and the weight layout
both ways (``checkpoint.params_to_jax``, the inverse of
``params_from_jax``).

JAX ``save_state`` -> port ``load_state`` and port ``save_state`` -> JAX
``load_state`` give equal trees (parameters, Adam's moments, the counts,
the step); one further step on each side agrees (losses within rtol 1e-4,
as the five-step bar of ``test_torch_port_train.py``).  A port run saved
and resumed equals the same run uninterrupted.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu import train as jax_train
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import registry as jax_registry
from unetseg_tpu_torch import checkpoint, train
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import training_batch
from unetseg_tpu_torch.models import registry

KW = dict(base_channels=8, depth=2, image_size=32, compute_dtype="float32")
JCFG, CFG = JaxModelConfig(**KW), ModelConfig(**KW)


def _batch(seed):
    return training_batch(np.random.default_rng(seed), 4, 32)


def _equal_trees(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for (path, x), y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kw", [
    dict(arch="unet"), dict(arch="unet", stem=2),
    dict(arch="unetpp", deep_supervision=True), dict(arch="unetpp"),
    dict(arch="attention_unet"), dict(arch="attention_unet", stem=2)])
def test_params_to_jax_inverts_params_from_jax(kw):
    cfg = ModelConfig(**{**KW, **kw})
    tree = registry.init(cfg, torch.Generator().manual_seed(1))
    back = checkpoint.params_to_jax(checkpoint.params_from_jax(tree))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    _equal_trees(tree, back)


def _jax_state_after(steps):
    tx = jax_train.make_optimizer(lr=1e-2, total_steps=20)
    state = jax_train.init_state(jax.random.key(3), JCFG, tx)
    step = jax.jit(lambda s, b: jax_train.train_step(s, b, JCFG, tx,
                                                     boundary_boost=2.0))
    for i in range(steps):
        state, _ = step(state, _batch(40 + i))
    return tx, state, step


def _check_same_state(j_state, p_state):
    _equal_trees(j_state.params, checkpoint.params_to_jax(p_state.params))
    adam = j_state.opt_state[1][0]
    _equal_trees(adam.mu, checkpoint.params_to_jax(p_state.opt_state.mu))
    _equal_trees(adam.nu, checkpoint.params_to_jax(p_state.opt_state.nu))
    assert p_state.opt_state.count == int(adam.count)
    assert p_state.opt_state.schedule_count == \
        int(j_state.opt_state[1][2].count)
    assert p_state.step == int(j_state.step)


def test_states_cross_between_the_packages(tmp_path):
    j_tx, j_state, j_step = _jax_state_after(3)
    p_tx = train.make_optimizer(lr=1e-2, total_steps=20)
    jax_file = str(tmp_path / "jax.state")
    jax_train.save_state(jax_file, j_state, JCFG)

    p_state, cfg = train.load_state(jax_file, p_tx, device="cpu")
    assert cfg == CFG
    _check_same_state(j_state, p_state)

    port_file = str(tmp_path / "port.state")
    train.save_state(port_file, p_state, cfg)
    j_back, j_cfg = jax_train.load_state(port_file, j_tx)
    assert j_cfg == JCFG
    _check_same_state(j_back, p_state)
    assert open(port_file, "rb").read() == open(jax_file, "rb").read()

    # one further step on each side, from the crossed states
    batch = _batch(50)
    j_next, j_loss = j_step(j_back, batch)
    p_next, p_loss = train.train_step(p_state, batch, cfg, p_tx,
                                      boundary_boost=2.0)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-4)
    assert p_next.step == int(j_next.step) == 4
    jl = jax.tree_util.tree_leaves(j_next.params)
    pl = jax.tree_util.tree_leaves(checkpoint.params_to_jax(p_next.params))
    for a, b in zip(jl, pl):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    tx = train.make_optimizer(lr=1e-2, total_steps=20)
    batches = [_batch(60 + i) for i in range(4)]
    state = train.init_state(5, CFG, tx, device="cpu")
    straight = state
    for b in batches:
        straight, _ = train.train_step(straight, b, CFG, tx)
    for b in batches[:2]:
        state, _ = train.train_step(state, b, CFG, tx)
    path = str(tmp_path / "mid.state")
    train.save_state(path, state, CFG)
    resumed, cfg = train.load_state(path, tx, device="cpu")
    for b in batches[2:]:
        resumed, _ = train.train_step(resumed, b, cfg, tx)
    assert resumed.step == straight.step == 4
    for k in straight.params:
        assert torch.equal(resumed.params[k], straight.params[k]), k
        assert torch.equal(resumed.opt_state.nu[k], straight.opt_state.nu[k])


def test_load_state_refuses_other_files(tmp_path):
    path = str(tmp_path / "model.ckpt")
    checkpoint.create(path, CFG, seed=0)
    with pytest.raises(ValueError, match="train checkpoint"):
        train.load_state(path, train.make_optimizer(), device="cpu")
