"""Training, the port of ``unetseg_tpu/train.py`` under the same names.

* loss = softmax cross-entropy + soft Dice, optionally boundary-weighted;
  the distillation loss blends it with a temperature-scaled KL to a
  teacher's logits;
* the optimizer is optax's ``chain(clip_by_global_norm(1.0),
  adamw(warmup_cosine_decay_schedule(0, lr, max(1, total // 20), total),
  weight_decay))`` written out step for step (:func:`make_optimizer`), not
  ``torch.optim.AdamW``: optax's first update has learning rate 0, its
  weight decay reaches every leaf (biases too) scaled by the schedule, and
  its clip scales by ``1 / |g|`` only when ``|g| >= 1``, with no epsilon;
* the forward is the model of ``models/registry.trainable``: float32
  parameters cast per call to ``cfg.compute_dtype``, its 3x3 convs in the
  conv kernels under autograd on the card (K1/K2 in bf16, K8 in float32;
  ``ops.conv.Conv3x3Function``, whose data gradient runs in the same
  kernels), every stage rematerialized with ``cfg.remat``; the 3x3 convs'
  weight gradients and every other op are plain PyTorch, as JAX leaves
  them to XLA;
* :func:`make_sharded_train_step` splits the batch over a mesh's dp
  devices in one process; ``sp > 1`` is refused (ROADMAP.md queue A, P9c).

A :class:`TrainState` holds the parameters as the port's state dict (the
names of ``checkpoint.params_from_jax``, float32 tensors on one device), the
optimizer state and the step.  A step returns a new state and leaves the
old one as it was, as JAX's does.  :func:`save_state` writes the JAX
package's train-checkpoint format (``UTPUTRAIN1``): parameters and moments
in the JAX layout, so either package resumes the other's run.  Every entry
point runs on the card unless it is given ``device="cpu"`` (or a state
that lives on the CPU).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unetseg_tpu_torch import checkpoint
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.parallel import mesh as pmesh

MAGIC = b"UTPUTRAIN1\n"
Params = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    """optax's state for the chain above, flattened: ``scale_by_adam``'s
    count and moments, and ``scale_by_schedule``'s count (clip and weight
    decay keep none)."""
    count: int
    mu: Params
    nu: Params
    schedule_count: int


class TrainState(NamedTuple):
    params: Params
    opt_state: OptState
    step: int


class Optimizer(NamedTuple):
    """optax's ``GradientTransformation`` for :func:`make_optimizer`'s
    chain: ``init(params)`` and ``update(grads, state, params) -> (new
    params, new state)`` (the update already applied, as
    ``optax.apply_updates`` would)."""
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]
    schedule: Callable[[int], float]


def warmup_cosine_decay(lr: float, total_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, max(1, total // 20),
    total)`` in float32, op for op: a linear warmup from 0 (so the first
    update has learning rate 0), then a cosine decay to 0 at
    ``total_steps``."""
    warmup = max(1, total_steps // 20)
    decay = total_steps - warmup
    if not decay > 0:
        raise ValueError(f"total_steps={total_steps}: the cosine decay needs "
                         f"more steps than the warmup's {warmup}")
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup:  # polynomial_schedule, power 1
            c = min(max(count, 0), warmup)
            frac = f32(1) - f32(c) / f32(warmup)
            return float((f32(0) - f32(lr)) * frac + f32(lr))
        c = f32(min(f32(count - warmup), f32(decay)))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return float(f32(lr) * (f32(1) * cosine + f32(0)))
    return schedule


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-4,
                   total_steps: int = 10_000, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Clip by global norm 1.0, then AdamW with the warmup-cosine schedule,
    as ``unetseg_tpu/train.py::make_optimizer``; arithmetic in the
    parameters' dtype (float32) in optax's order."""
    schedule = warmup_cosine_decay(lr, total_steps)

    def init(params: Params) -> OptState:
        return OptState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                        {k: torch.zeros_like(p) for k, p in params.items()}, 0)

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params
               ) -> Tuple[Params, OptState]:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < 1.0
        count = state.count + 1
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32),
                            torch.tensor(count, dtype=torch.float32))
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32),
                            torch.tensor(count, dtype=torch.float32))
        step_size = -schedule(state.schedule_count)
        new_p, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            g = torch.where(keep, g, (g / g_norm) * 1.0)
            mu[k] = (1 - b1) * g + b1 * state.mu[k]
            nu[k] = (1 - b2) * (g * g) + b2 * state.nu[k]
            u = (mu[k] / bc1.to(p.device)) / (
                torch.sqrt(nu[k] / bc2.to(p.device)) + eps)
            u = u + weight_decay * p
            new_p[k] = p + step_size * u
        return new_p, OptState(count, mu, nu, state.schedule_count + 1)

    return Optimizer(init, update, schedule)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def soft_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                   num_classes: int, eps: float = 1e-6) -> torch.Tensor:
    """Mean soft Dice over samples and classes; logits (N,H,W,C), labels
    (N,H,W) int."""
    return 1.0 - torch.mean(_dice(logits, labels, num_classes, eps))


def _dice(logits, labels, num_classes, eps=1e-6) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).to(probs.dtype)
    inter = torch.sum(probs * onehot, dim=(1, 2))
    denom = torch.sum(probs + onehot, dim=(1, 2))
    return (2.0 * inter + eps) / (denom + eps)


def boundary_weight_map(labels: torch.Tensor, radius: int = 2,
                        boost: float = 8.0) -> torch.Tensor:
    """Per-pixel loss weights: ``1 + boost`` where the (2r+1)² window
    around the pixel spans more than one class, else 1 (float32, (N, H,
    W)).  JAX takes a max and a min ``reduce_window`` with SAME padding
    whose pad value never wins; ``max_pool2d`` pads with -inf, which never
    wins either, and the min is the max of the negated labels."""
    lab = labels.to(torch.float32)[:, None]
    k = 2 * radius + 1
    mx = F.max_pool2d(lab, k, stride=1, padding=radius)
    mn = -F.max_pool2d(-lab, k, stride=1, padding=radius)
    return 1.0 + boost * (mx != mn)[:, 0].to(torch.float32)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels``: per pixel,
    logsumexp minus the label's logit (classes last)."""
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


class _Terms(NamedTuple):
    """A batch part's sums; the loss is a function of their totals over the
    parts, so a split batch gives the whole batch's loss."""
    ce: torch.Tensor      # sum of ce * w (w = 1 without boundary weights)
    w: torch.Tensor       # sum of w
    dice: torch.Tensor    # sum of the per-sample, per-class Dice
    n_dice: int           # samples * classes
    kl: Optional[torch.Tensor]


def _terms(logits, labels, cfg: ModelConfig, boundary_boost: float,
           t_logits=None, temperature: float = 2.0) -> _Terms:
    w = (boundary_weight_map(labels, boost=boundary_boost)
         if boundary_boost > 0 else None)
    ce = _ce(logits, labels)
    dice = _dice(logits, labels, cfg.num_classes)
    kl = None
    if t_logits is not None:
        t = temperature
        t_prob = torch.softmax(t_logits / t, dim=-1)
        s_logp = torch.log_softmax(logits / t, dim=-1)
        kl = torch.sum(t_prob * (torch.log(t_prob + 1e-9) - s_logp), dim=-1)
    if w is None:
        n = torch.tensor(float(ce.numel()), device=ce.device)
        return _Terms(ce.sum(), n, dice.sum(), dice.numel(),
                      None if kl is None else kl.sum())
    return _Terms(torch.sum(ce * w), torch.sum(w), dice.sum(), dice.numel(),
                  None if kl is None else torch.sum(kl * w))


def _combine(parts: Sequence[_Terms], device, distill: bool, alpha: float,
             temperature: float) -> torch.Tensor:
    def total(name):
        vals = [getattr(p, name).to(device) for p in parts]
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out
    w = total("w")
    seg = total("ce") / w + (1.0 - total("dice") / sum(p.n_dice
                                                        for p in parts))
    if not distill:
        return seg
    t = temperature
    return (1.0 - alpha) * seg + alpha * (t * t) * (total("kl") / w)


# ---------------------------------------------------------------------------
# the model, bound to a parameter dict
# ---------------------------------------------------------------------------

def _bound(cfg: ModelConfig, params: Params) -> nn.Module:
    """A training module of ``cfg`` whose parameters are new leaves that
    share storage with ``params``' tensors (the gradients are taken
    against them).  It is built per call, its structure on the meta device
    so that nothing is allocated, and kept by no one: two states never
    share a module, and a rematerialized stage recomputes from the
    parameters of its own call."""
    with torch.device("meta"):
        model = registry.trainable(cfg, params)
    names = [k for k, _ in model.named_parameters()]
    if set(names) != set(params):
        raise ValueError(f"params do not match arch {cfg.arch!r}: "
                         f"{sorted(set(names) ^ set(params))[:4]}")
    for k in names:
        owner, _, attr = k.rpartition(".")
        setattr(model.get_submodule(owner), attr,
                nn.Parameter(params[k].detach(), requires_grad=True))
    return model


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


def loss_and_grads(params: Params, batch, cfg: ModelConfig, *,
                   devices: Optional[Sequence[torch.device]] = None,
                   boundary_boost: float = 0.0, distill: bool = False,
                   alpha: float = 0.5, temperature: float = 2.0
                   ) -> Tuple[torch.Tensor, Params]:
    """``jax.value_and_grad`` of :func:`segmentation_loss` (or, with
    ``distill``, of :func:`distillation_loss`; ``batch`` then carries the
    teacher's logits third).  With ``devices`` the batch is split over
    them (contiguous parts, one model replica per distinct device, the
    parameters copied there) and the gradients are summed on the
    parameters' device; by default it runs whole there."""
    home = next(iter(params.values())).device
    devices = [home] if devices is None else list(devices)
    replicas = pmesh.replicate(
        lambda d: _bound(cfg, {k: p.to(d) for k, p in params.items()}),
        devices)
    parts = [pmesh.split_batch(_as_tensor(a, None), devices) if
             len(devices) > 1 else [_as_tensor(a, devices[0])]
             for a in batch]
    terms = []
    for i, model in enumerate(replicas):
        imgs = parts[0][i].to(torch.float32)
        labels = parts[1][i].long()
        t_logits = parts[2][i].to(torch.float32) if distill else None
        logits = model(imgs)
        terms.append(_terms(logits, labels, cfg, boundary_boost, t_logits,
                            temperature))
    loss = _combine(terms, home, distill, alpha, temperature)
    models = list({id(m): m for m in replicas}.values())
    leaves = [dict(m.named_parameters()) for m in models]
    grads = torch.autograd.grad(loss, [p for lv in leaves
                                       for p in lv.values()])
    out: Params = {}
    i = 0
    for lv in leaves:
        for k in lv:
            g = grads[i].to(home)
            out[k] = g if k not in out else out[k] + g
            i += 1
    return loss.detach(), out


def segmentation_loss(params: Params, batch, cfg: ModelConfig, *,
                      boundary_boost: float = 0.0) -> torch.Tensor:
    """Cross-entropy (boundary-weighted mean when ``boundary_boost > 0``)
    plus soft Dice of the model's logits on ``batch = (imgs, labels)``."""
    device = next(iter(params.values())).device
    imgs, labels = (_as_tensor(a, device) for a in batch)
    logits = _bound(cfg, params)(imgs.to(torch.float32))
    return _combine([_terms(logits, labels.long(), cfg, boundary_boost)],
                    device, False, 0.5, 2.0)


def distillation_loss(params: Params, batch, cfg: ModelConfig, *,
                      alpha: float = 0.5, temperature: float = 2.0,
                      boundary_boost: float = 0.0) -> torch.Tensor:
    """``(1 - alpha) * (ce + dice) + alpha * T² * KL(teacher || student)``
    at temperature T on ``batch = (imgs, labels, teacher_logits)``; the
    boundary weights reach the CE and the KL terms."""
    device = next(iter(params.values())).device
    imgs, labels, t_logits = (_as_tensor(a, device) for a in batch)
    logits = _bound(cfg, params)(imgs.to(torch.float32))
    return _combine([_terms(logits, labels.long(), cfg, boundary_boost,
                            t_logits.to(torch.float32), temperature)],
                    device, True, alpha, temperature)


def _apply_grads(state: TrainState, tx: Optimizer, loss, grads
                 ) -> Tuple[TrainState, torch.Tensor]:
    params, opt_state = tx.update(grads, state.opt_state, state.params)
    return TrainState(params, opt_state, state.step + 1), loss


def train_step(state: TrainState, batch, cfg: ModelConfig, tx: Optimizer, *,
               boundary_boost: float = 0.0) -> Tuple[TrainState, torch.Tensor]:
    """One update on ``batch = (imgs (N,H,W,C) float in [0, 1], labels
    (N,H,W) int)`` (numpy or tensors): (new state, loss)."""
    loss, grads = loss_and_grads(state.params, batch, cfg,
                                 boundary_boost=boundary_boost)
    return _apply_grads(state, tx, loss, grads)


def distill_step(state: TrainState, batch, cfg: ModelConfig, tx: Optimizer,
                 *, alpha: float = 0.5, temperature: float = 2.0,
                 boundary_boost: float = 0.0
                 ) -> Tuple[TrainState, torch.Tensor]:
    """One update of :func:`distillation_loss` on ``batch = (imgs, labels,
    teacher_logits)``."""
    loss, grads = loss_and_grads(state.params, batch, cfg,
                                 boundary_boost=boundary_boost, distill=True,
                                 alpha=alpha, temperature=temperature)
    return _apply_grads(state, tx, loss, grads)


def state_from_params(tree: dict, tx: Optimizer, device: str = "cuda"
                      ) -> TrainState:
    """A fresh state on ``device`` from a JAX-layout parameter tree (the
    tests hand both packages the same numpy weights)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "explicitly to train on the CPU")
    params = {k: v.to(device=device, dtype=torch.float32).contiguous()
              for k, v in checkpoint.params_from_jax(tree).items()}
    return TrainState(params, tx.init(params), 0)


def init_state(rng, cfg: ModelConfig, tx: Optimizer, device: str = "cuda"
               ) -> TrainState:
    """He-normal weights for ``cfg`` from ``rng`` (a seed or a
    ``torch.Generator``; the numbers differ from ``jax.random``'s), a zero
    optimizer state and step 0, on ``device``."""
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    return state_from_params(registry.init(cfg, gen), tx, device)


def make_sharded_train_step(cfg: ModelConfig, mesh: pmesh.Mesh,
                            tx: Optimizer, *, boundary_boost: float = 0.0,
                            distill: bool = False, alpha: float = 0.5,
                            temperature: float = 2.0) -> Callable:
    """``(state, batch) -> (state, loss)`` with the batch split over the
    mesh's dp devices (contiguous parts, in the order of ``P("dp")``), in
    one process: each part's forward and backward on its device, a model
    replica per distinct device, the parts' loss sums and the gradients
    gathered on the state's device, so the loss is the whole batch's (the
    weighted means divide the summed numerators by the summed weights) and
    the update the one-device step's, as JAX's jit over ``P("dp", "sp")``
    gives.  ``distill=True``: the batch carries the teacher's logits third.
    The batch must split evenly.  ``sp > 1`` is refused (P9c)."""
    if mesh.shape["sp"] > 1:
        pmesh.spatial_split()
    devices = pmesh.dp_devices(mesh)

    def step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        loss, grads = loss_and_grads(
            state.params, batch, cfg, devices=devices,
            boundary_boost=boundary_boost, distill=distill, alpha=alpha,
            temperature=temperature)
        return _apply_grads(state, tx, loss, grads)
    return step


# ---------------------------------------------------------------------------
# train-state checkpoint / resume, in the JAX package's format
# ---------------------------------------------------------------------------

def _state_dict_form(tree):
    """flax's ``to_state_dict`` of a parameter tree: lists become dicts
    keyed ``"0"``, ``"1"``, ..."""
    if isinstance(tree, dict):
        return {k: _state_dict_form(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict_form(v) for i, v in enumerate(tree)}
    return tree


def save_state(path: str, state: TrainState, cfg: ModelConfig) -> None:
    """Write the full training state (parameters, optimizer, step) as the
    JAX package's ``save_state`` does: ``UTPUTRAIN1\\n`` and one msgpack map
    ``{config, params, opt_state, step}``, the parameters and moments in
    the JAX layout, the optimizer state as flax's state dict of the optax
    chain (``{"0": {}, "1": {"0": {count, mu, nu}, "1": {}, "2":
    {count}}}``).  The file appears only when complete."""
    opt = state.opt_state
    payload = checkpoint.packb({
        "config": dataclasses.asdict(cfg),
        "params": checkpoint.params_to_jax(state.params),
        "opt_state": {"0": {}, "1": {
            "0": {"count": np.asarray(opt.count, np.int32),
                  "mu": _state_dict_form(checkpoint.params_to_jax(opt.mu)),
                  "nu": _state_dict_form(checkpoint.params_to_jax(opt.nu))},
            "1": {},
            "2": {"count": np.asarray(opt.schedule_count, np.int32)}}},
        "step": int(state.step),
    })
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(payload)
    os.replace(tmp, path)


def load_state(path: str, tx: Optimizer, device: str = "cuda"
               ) -> Tuple[TrainState, ModelConfig]:
    """Restore a training state written by :func:`save_state` or by the
    JAX package's, onto ``device``."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"Not a unetseg_tpu train checkpoint: {path}")
        data = checkpoint.unpackb(f.read())
    cfg = checkpoint.config_from_snapshot(data["config"], path)
    state = state_from_params(data["params"], tx, device)
    adam, sched = data["opt_state"]["1"]["0"], data["opt_state"]["1"]["2"]
    dev = next(iter(state.params.values())).device

    def moments(tree):
        return {k: v.to(device=dev, dtype=torch.float32).contiguous()
                for k, v in checkpoint.params_from_jax(tree).items()}
    opt = OptState(int(adam["count"]), moments(adam["mu"]),
                   moments(adam["nu"]), int(sched["count"]))
    return TrainState(state.params, opt, int(data["step"])), cfg


def logits(params: Params, cfg: ModelConfig, imgs) -> torch.Tensor:
    """The model's float32 logits on ``imgs`` (N, H, W, C), no gradients,
    on the parameters' device: a teacher's, or a held-out check's."""
    device = next(iter(params.values())).device
    with torch.no_grad():
        return _bound(cfg, params)(_as_tensor(imgs, device, torch.float32))


def predict_masks(params: Params, cfg: ModelConfig, imgs) -> np.ndarray:
    """First-max argmax masks (uint8 numpy) of the model on ``imgs``."""
    out = logits(params, cfg, imgs)
    return torch.argmax(out, dim=-1).to(torch.uint8).cpu().numpy()


__all__ = ["TrainState", "OptState", "Optimizer", "make_optimizer",
           "warmup_cosine_decay", "soft_dice_loss", "boundary_weight_map",
           "segmentation_loss", "distillation_loss", "loss_and_grads",
           "train_step", "distill_step", "init_state", "state_from_params",
           "make_sharded_train_step", "save_state", "load_state",
           "logits", "predict_masks", "MAGIC"]
