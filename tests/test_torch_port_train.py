"""The port's training (``unetseg_tpu_torch/train.py``, the conv under
autograd in ``ops/conv.py``) against the JAX package's ``train.py`` on the
CPU, on the same seeded numpy inputs and weights.

Bars: ``boundary_weight_map`` bit-equal; the losses on the same logits
within rtol 1e-6; the learning-rate schedule equal to optax's at every step
(float32, op for op: equal but by lr * 2^-23 where the cosines part in the
last place); clip + AdamW updates within rtol 1e-6 of optax's; first-step gradients within rtol 1e-4 + atol 1e-6 of ``jax.grad`` in
float32 for every family (the two convs sum in different orders); five
``train_step``s and five ``distill_step``s within rtol 1e-4 in loss; a bf16
step within rtol 1e-2 (JAX rounds its XLA convs' bf16 outputs at other
points than the port's kernels).  The dp step over ``["cpu", "cpu"]``
against the one-device step; the conv Function's backward formula against
autograd through ``F.conv2d`` in float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from unetseg_tpu import train as jax_train
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import registry as jax_registry
from unetseg_tpu_torch import checkpoint, train
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import training_batch
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.ops import conv
from unetseg_tpu_torch.parallel import mesh as pmesh

SIZE = 32
BASE = dict(base_channels=8, depth=2, image_size=SIZE,
            compute_dtype="float32")
# name -> ModelConfig keywords beyond BASE
FAMILIES = {
    "unet_stem1": {},
    "unet_stem4": dict(stem=4),
    "unetpp": dict(arch="unetpp"),
    "unetpp_ds": dict(arch="unetpp", deep_supervision=True),
    "attention_unet": dict(arch="attention_unet"),
}


def _cfgs(**kw):
    kw = {**BASE, **kw}
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _params(jcfg, seed=0):
    """JAX init with random biases (init zeroes them), as numpy."""
    params = jax.device_get(jax_registry.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.standard_normal(v.shape) * 0.1).astype(
            np.float32) if path[-1].key == "b" else np.asarray(v), params)


def _batch(seed, n=4, size=SIZE):
    return training_batch(np.random.default_rng(seed), n, size)


def _leaves_close(jtree, ptree, rtol, atol):
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    pl = jax.tree_util.tree_leaves(ptree)
    assert len(jl) == len(pl)
    for (path, a), b in zip(jl, pl):
        np.testing.assert_allclose(b, np.asarray(a), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("radius,boost", [(2, 8.0), (1, 3.0), (3, 0.5)])
def test_boundary_weight_map_is_bit_equal(radius, boost):
    labels = np.random.default_rng(radius).integers(0, 3, (3, 21, 26))
    labels[1] = 2  # one slice of a single class: no boundary at all
    labels[2, :, :13] = 0
    labels[2, :, 13:] = 1
    want = np.asarray(jax_train.boundary_weight_map(
        jnp.asarray(labels, jnp.int32), radius=radius, boost=boost))
    got = train.boundary_weight_map(torch.from_numpy(labels), radius=radius,
                                    boost=boost).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_losses_on_the_same_logits_match(monkeypatch):
    """``soft_dice_loss``, ``segmentation_loss`` (with and without boundary
    weights) and ``distillation_loss`` on fixed logits: the model forward is
    replaced on both sides by one that returns them."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 16, 20, 3)) * 2).astype(np.float32)
    t_logits = (rng.standard_normal((3, 16, 20, 3)) * 2).astype(np.float32)
    labels = rng.integers(0, 3, (3, 16, 20)).astype(np.int32)
    imgs = np.zeros((3, 16, 20, 1), np.float32)
    jcfg, cfg = _cfgs()
    np.testing.assert_allclose(
        float(train.soft_dice_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 3)),
        float(jax_train.soft_dice_loss(logits, labels, 3)), rtol=1e-6)

    monkeypatch.setattr(jax_train.model_registry, "apply",
                        lambda p, x, c: jnp.asarray(logits))

    class Fixed(torch.nn.Module):
        def forward(self, x):
            return torch.from_numpy(logits)
    monkeypatch.setattr(train, "_bound", lambda c, p: Fixed())
    params = {"w": torch.zeros(1)}
    for boost in (0.0, 4.0):
        np.testing.assert_allclose(
            float(train.segmentation_loss(params, (imgs, labels), cfg,
                                          boundary_boost=boost)),
            float(jax_train.segmentation_loss({}, (imgs, labels), jcfg,
                                              boundary_boost=boost)),
            rtol=1e-6)
        for alpha, t in ((0.5, 2.0), (0.3, 1.0)):
            np.testing.assert_allclose(
                float(train.distillation_loss(
                    params, (imgs, labels, t_logits), cfg, alpha=alpha,
                    temperature=t, boundary_boost=boost)),
                float(jax_train.distillation_loss(
                    {}, (imgs, labels, t_logits), jcfg, alpha=alpha,
                    temperature=t, boundary_boost=boost)), rtol=1e-6)


@pytest.mark.parametrize("lr,total", [(1e-3, 100), (1e-2, 150), (3e-4, 300),
                                      (5e-3, 7)])
def test_schedule_equals_optax(lr, total):
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=max(1, total // 20),
        decay_steps=total)
    sched = train.make_optimizer(lr=lr, total_steps=total).schedule
    got = np.array([sched(c) for c in range(total + 1)], np.float32)
    ref = np.array([want(jnp.asarray(c, jnp.int32)) for c in range(total + 1)],
                   np.float32)
    assert got[0] == 0.0 and got[-1] == 0.0
    # float32 op for op: equal but where numpy's float32 cos and XLA's part
    # in the last place, which 1 + cos near -1 carries into lr * 2^-23
    np.testing.assert_allclose(got, ref, rtol=0, atol=lr * 2.0 ** -23)
    assert np.mean(got == ref) > 0.9


def _optax_state(tx, params, count, mu, nu):
    """optax's chain state for :func:`make_optimizer` at ``count`` updates
    with the given moments."""
    s0 = tx.init(params)
    adam = s0[1][0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu,
                             nu=nu)
    sched = s0[1][2]._replace(count=jnp.asarray(count, jnp.int32))
    return (s0[0], (adam, s0[1][1], sched))


_JAX_TX = jax_train.make_optimizer(lr=1e-2, weight_decay=1e-2,
                                   total_steps=40)
_JAX_UPDATE = jax.jit(_JAX_TX.update)  # one compile for every case


@pytest.mark.parametrize("count,scale", [(0, 0.002), (4, 0.002), (4, 0.3),
                                         (39, 0.3)])
def test_clip_adamw_update_matches_optax(count, scale):
    """One update from the same state and gradient tree: the first (count
    0, learning rate 0, so only the moments move), then from random
    moments at count 4 with the global norm below 1 (no clip) and above
    (clip), and at the schedule's end.  Params, mu and nu within rtol 1e-6
    and an atol of 1e-6 of each leaf's largest value (a moment's
    ``0.1 * g + 0.9 * m`` cancels at some elements, where the two libraries'
    roundings part relatively more)."""
    jcfg, _ = _cfgs()
    params = _params(jcfg, 1)
    rng = np.random.default_rng(count)

    def draw(s, positive=False):
        return jax.tree_util.tree_map(
            lambda v: (np.abs if positive else np.asarray)(
                rng.standard_normal(v.shape) * s).astype(np.float32), params)
    grads = draw(scale)
    mu = draw(0.0 if count == 0 else 0.02)
    nu = draw(0.0 if count == 0 else 1e-3, positive=True)
    upd, j_state = _JAX_UPDATE(
        grads, _optax_state(_JAX_TX, params, count, mu, nu), params)
    j_params = optax.apply_updates(params, upd)
    p_tx = train.make_optimizer(lr=1e-2, weight_decay=1e-2, total_steps=40)
    p_params, p_state = p_tx.update(
        checkpoint.params_from_jax(grads),
        train.OptState(count, checkpoint.params_from_jax(mu),
                       checkpoint.params_from_jax(nu), count),
        checkpoint.params_from_jax(params))
    adam = j_state[1][0]
    for want, got in ((j_params, p_params), (adam.mu, p_state.mu),
                      (adam.nu, p_state.nu)):
        got = checkpoint.params_to_jax(got)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got)):
            a = np.asarray(a)
            np.testing.assert_allclose(b, a, rtol=1e-6,
                                       atol=1e-6 * np.abs(a).max(),
                                       err_msg=jax.tree_util.keystr(path))
    assert p_state.count == int(adam.count) == count + 1
    assert p_state.schedule_count == int(j_state[1][2].count)
    if count == 0:  # learning rate 0: the parameters stay
        _leaves_close(params, checkpoint.params_to_jax(p_params), 0, 0)
    assert (float(optax.global_norm(grads)) >= 1.0) == (scale == 0.3)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_first_step_gradients_match_jax(name):
    jcfg, cfg = _cfgs(**FAMILIES[name])
    params = _params(jcfg, 3)
    imgs, labels = _batch(5)
    boost = 2.0 if name.startswith("unet") else 0.0
    j_loss, j_grads = jax.value_and_grad(jax_train.segmentation_loss)(
        params, (imgs, labels), jcfg, boundary_boost=boost)
    state = train.state_from_params(params, train.make_optimizer(), "cpu")
    loss, grads = train.loss_and_grads(state.params, (imgs, labels), cfg,
                                       boundary_boost=boost)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    _leaves_close(j_grads, checkpoint.params_to_jax(grads), 1e-4, 1e-6)


def test_remat_gives_the_same_gradients():
    _, cfg = _cfgs()
    jcfg, _ = _cfgs()
    params = _params(jcfg, 6)
    imgs, labels = _batch(7)
    state = train.state_from_params(params, train.make_optimizer(), "cpu")
    plain = train.loss_and_grads(state.params, (imgs, labels), cfg)
    again = train.loss_and_grads(state.params, (imgs, labels),
                                 dataclasses.replace(cfg, remat=True))
    assert float(plain[0]) == float(again[0])
    for k in plain[1]:
        torch.testing.assert_close(again[1][k], plain[1][k], rtol=1e-6,
                                   atol=0)


def test_two_states_on_one_config_do_not_share_a_module():
    """A rematerialized backward recomputes from its own parameters even
    after another state of the same config ran a forward in between (a
    teacher and a student, or two runs): nothing binds a shared module."""
    jcfg, cfg = _cfgs(remat=True)
    imgs, labels = _batch(8)
    tx = train.make_optimizer()
    a = train.state_from_params(_params(jcfg, 9), tx, "cpu").params
    b = train.state_from_params(_params(jcfg, 10), tx, "cpu").params
    want = train.loss_and_grads(a, (imgs, labels), cfg)
    model = train._bound(cfg, a)
    assert all(p.data_ptr() == a[k].data_ptr()
               for k, p in model.named_parameters())
    loss_a = train._combine([train._terms(
        model(torch.from_numpy(imgs)), torch.from_numpy(labels).long(), cfg,
        0.0)], torch.device("cpu"), False, 0.5, 2.0)
    train.segmentation_loss(b, (imgs, labels), cfg)
    train.logits(b, cfg, imgs)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss_a, leaves)
    assert float(loss_a.detach()) == float(want[0])
    for k, g in zip(names, grads):
        torch.testing.assert_close(g, want[1][k], rtol=0, atol=0)
    assert not any(p.requires_grad for p in (*a.values(), *b.values()))


def _run_jax(jcfg, params, batches, steps, distill=False, boost=0.0):
    tx = jax_train.make_optimizer(lr=1e-2, total_steps=20)
    state = jax_train.TrainState(params, tx.init(params),
                                 jnp.zeros((), jnp.int32))
    fn = jax_train.distill_step if distill else jax_train.train_step
    losses = []
    for b in batches[:steps]:
        state, loss = fn(state, b, jcfg, tx, boundary_boost=boost)
        losses.append(float(loss))
    return state, losses


def _run_port(cfg, params, batches, steps, distill=False, boost=0.0,
              step_fn=None):
    tx = train.make_optimizer(lr=1e-2, total_steps=20)
    state = train.state_from_params(params, tx, "cpu")
    fn = step_fn or (lambda s, b: (train.distill_step if distill else
                                   train.train_step)(s, b, cfg, tx,
                                                     boundary_boost=boost))
    losses = []
    for b in batches[:steps]:
        state, loss = fn(state, b)
        losses.append(float(loss))
    return state, losses


@pytest.mark.parametrize("distill", [False, True])
def test_five_steps_match_jax(distill):
    jcfg, cfg = _cfgs()
    params = _params(jcfg, 8)
    rng = np.random.default_rng(9)
    batches = []
    for i in range(5):
        imgs, labels = _batch(20 + i)
        if distill:
            t = (rng.standard_normal((*labels.shape, 3)) * 2).astype(
                np.float32)
            batches.append((imgs, labels, t))
        else:
            batches.append((imgs, labels))
    boost = 2.0 if distill else 0.0
    _, j_losses = _run_jax(jcfg, params, batches, 5, distill, boost)
    state, p_losses = _run_port(cfg, params, batches, 5, distill, boost)
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)
    assert state.step == 5 and state.opt_state.count == 5
    assert len(set(np.round(p_losses, 6))) == 5  # the steps moved the model


def test_bf16_step_loss_matches_jax():
    jcfg, cfg = _cfgs(compute_dtype="bfloat16")
    params = _params(jcfg, 10)
    batches = [_batch(30 + i) for i in range(2)]
    _, j_losses = _run_jax(jcfg, params, batches, 2)
    _, p_losses = _run_port(cfg, params, batches, 2)
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-2)


@pytest.mark.parametrize("distill", [False, True])
def test_dp_step_equals_the_one_device_step(distill):
    """The sharded step over ``["cpu", "cpu"]`` (two parts of a batch of
    4, boundary weights on) against the one-device step: the loss of the
    whole batch and its gradients, to float32 summation order, and after
    two steps the same parameters (Adam divides by sqrt(nu), so where a
    gradient is near 0 its last bits reach the update: atol 1e-5 is 1e-3
    of a step of lr 1e-2)."""
    _, cfg = _cfgs()
    jcfg, _ = _cfgs()
    params = _params(jcfg, 11)
    imgs, labels = _batch(12)
    batch = (imgs, labels)
    if distill:
        batch += ((np.random.default_rng(13).standard_normal(
            (*labels.shape, 3)) * 2).astype(np.float32),)
    tx = train.make_optimizer(lr=1e-2, total_steps=20)
    kw = dict(boundary_boost=3.0, distill=distill, alpha=0.4,
              temperature=1.5)
    one = train.make_sharded_train_step(
        cfg, pmesh.make_mesh(devices=["cpu"]), tx, **kw)
    two = train.make_sharded_train_step(
        cfg, pmesh.make_mesh(devices=["cpu", "cpu"]), tx, **kw)
    s1, s2 = (train.state_from_params(params, tx, "cpu") for _ in range(2))
    cpu = torch.device("cpu")
    g1 = train.loss_and_grads(s1.params, batch, cfg, devices=[cpu], **kw)[1]
    g2 = train.loss_and_grads(s1.params, batch, cfg, devices=[cpu, cpu], **kw)[1]
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=1e-5, atol=1e-7)
    for _ in range(2):
        s1, l1 = one(s1, batch)
        s2, l2 = two(s2, batch)
        np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for k in s1.params:
        torch.testing.assert_close(s2.params[k], s1.params[k], rtol=1e-5,
                                   atol=1e-5)
    if not distill:  # the one-device mesh step is train_step itself
        s3 = train.state_from_params(params, tx, "cpu")
        for _ in range(2):
            s3, l3 = train.train_step(s3, batch, cfg, tx, boundary_boost=3.0)
        for k in s1.params:
            torch.testing.assert_close(s3.params[k], s1.params[k], rtol=0,
                                       atol=0)


def test_sharded_step_refuses_the_spatial_split():
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="P9c"):
        train.make_sharded_train_step(
            cfg, pmesh.make_mesh(devices=["cpu"] * 2, sp=2),
            train.make_optimizer())


@pytest.mark.parametrize("relu", [True, False])
def test_conv_function_backward_formula_in_float64(relu):
    """``Conv3x3Function`` (forward the plain conv, backward the masked
    gradient, the rotated-weight conv for dx, ``conv2d_weight`` for dw)
    against autograd through ``F.conv2d`` + bias (+ ReLU), in float64, on a
    ragged shape with C and D not multiples of 16."""
    g = torch.Generator().manual_seed(14)
    x = torch.randn((2, 7, 9, 5), generator=g, dtype=torch.float64)
    w = torch.randn((3, 3, 5, 6), generator=g, dtype=torch.float64)
    b = torch.randn((6,), generator=g, dtype=torch.float64)
    r = torch.randn((2, 7, 9, 6), generator=g, dtype=torch.float64)
    got_in = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want_in = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = conv.conv3x3_bias_act_train(*got_in, relu=relu)
    (y * r).sum().backward()
    xw, ww, bw = want_in
    ref = F.conv2d(xw.permute(0, 3, 1, 2), ww.permute(3, 2, 0, 1), bw,
                   padding=1).permute(0, 2, 3, 1)
    if relu:
        ref = torch.relu(ref)
    (ref * r).sum().backward()
    torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)
    for a, e in zip(got_in, want_in):
        torch.testing.assert_close(a.grad, e.grad, rtol=1e-10, atol=1e-10)


def test_first_conv_computes_no_data_gradient(monkeypatch):
    """The data gradient runs once per 3x3 conv but the first, whose input
    is the (data) image; the weight gradient once per conv."""
    _, cfg = _cfgs(depth=1)
    jcfg, _ = _cfgs(depth=1)
    calls = {"dgrad": 0, "wgrad": 0}
    for name in calls:
        fn = getattr(conv, f"conv3x3_{name}")

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(conv, f"conv3x3_{name}", counted)
    state = train.state_from_params(_params(jcfg, 15),
                                    train.make_optimizer(), "cpu")
    train.loss_and_grads(state.params, _batch(16), cfg)
    n_convs = 4 * cfg.depth + 2
    assert calls == {"dgrad": n_convs - 1, "wgrad": n_convs}


def test_training_entry_points_default_to_the_card(monkeypatch):
    _, cfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.init_state(0, cfg, train.make_optimizer())
    with pytest.raises(NotImplementedError, match="not trainable"):
        registry.trainable(dataclasses.replace(cfg, arch="unet_w8a8"), {})
