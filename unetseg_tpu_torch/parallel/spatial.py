"""The spatial (sp) split: image rows in bands over a row of devices, with a
halo exchange around every 3x3 conv, the port of what XLA SPMD inserts for
the JAX package's ``P("dp", "sp")`` sharding (``unetseg_tpu/parallel/
batch.py::make_sharded_pipeline(spatial=True)``, ``mesh.py::
batch_spatial_sharding``, ``train.py::make_sharded_train_step``).

A :class:`Bands` holds one batch part's activation as row bands, band i on
its own device, empty bands left out.  The float families' modules run on
it unchanged, every band in lockstep in one call:

* every op but the 3x3 conv is row-local once the bands are cut in units of
  ``f = stem * 2**depth`` input rows (:func:`row_unit`): space-to-depth and
  depth-to-space, the 2x2 max-pool, the 2x2 stride-2 up-conv, the 1x1 convs
  and heads, the attention gates, the concats, the argmax, and the w8a8
  UNet's activation quantize and int8 products.  ``Bands``
  maps each over the bands: torch's functions and the model helpers that
  take part in ``torch.overrides`` (``has_torch_function_unary``) through
  ``__torch_function__``, operators and the ``to``/``float`` methods
  directly; a tensor argument (a weight) is copied to the band's device;
* the 3x3 conv (``ops.conv.conv3x3_bias_act_train``; the w8a8 UNet's
  ``ops.conv_s8.conv3x3_s8_q`` and ``conv3x3_s8``) exchanges halos
  (:func:`halo_slabs`): each band's slab is its rows with the last row of
  the band above and the first row of the band below, zero rows at the
  image's top and bottom edges; the conv runs on the (h + 2)-row slab
  through the same entry as a whole image (K1/K2 in bf16, K8 in float32,
  K7 on int8 on the card), and the slab's first and last output rows are
  dropped, from each output of a conv that writes one a consumer.  The
  kernels' tile plans depend on C, D and W only, so a band's rows come out
  of the same kernel instantiation, in the same k-order, as the whole
  image's.  An int8 slab's zero edge rows are what the whole image's
  padding reads: the activation quantize is symmetric, round(0 / s) = 0.

No band ever holds the whole activation and nothing is gathered before a
conv.  Lockstep needs no thread and no barrier, so autograd and ``remat``
(``torch.utils.checkpoint`` of a stage across all its bands: a stage's
second conv reads its neighbours' first-conv rows) work as on one tensor.
A copy between two cards (``Tensor.to``) is ordered after the work already
on both cards' current streams and before what follows on them (ATen's
device-to-device copy records and waits on an event each way), so the
exchange needs no event of its own.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models.unet import max_pool_2x2, space_to_depth
from unetseg_tpu_torch.ops import conv, conv_s8
from unetseg_tpu_torch.parallel import mesh as pmesh

#: What the halo exchanges moved since the last :func:`reset_exchange`:
#: exchanges (one per 3x3 conv), bytes of neighbour rows copied into the
#: slabs, bytes of the slabs assembled (int8 for the w8a8 UNet).
EXCHANGE: Dict[str, int] = {"exchanges": 0, "halo_bytes": 0,
                            "slab_bytes": 0}


def reset_exchange() -> None:
    for k in EXCHANGE:
        EXCHANGE[k] = 0


def row_unit(cfg: ModelConfig) -> int:
    """f, the input rows a band is cut in units of: ``stem * 2**depth``, so
    that space-to-depth and every 2x2 max-pool stay inside a band.  Raises
    for a family that cannot run in bands (``registry.refuse``)."""
    from unetseg_tpu_torch.models import registry

    registry.refuse(cfg, "row bands")
    return cfg.stem * 2 ** cfg.depth


def check_rows(cfg: ModelConfig, n: int, h: int, w: int) -> None:
    """Raise what the unsplit forward raises on an (n, h, w) input that does
    not cut in units of :func:`row_unit` (its space-to-depth's or a
    max-pool's reshape): the model's own helpers run on meta tensors of the
    shapes the unsplit forward gives them, so nothing is computed."""
    x = torch.empty((n, h, w, cfg.in_channels), device="meta")
    if cfg.stem > 1:
        x = space_to_depth(x, cfg.stem)
    for i in range(cfg.depth):
        x = max_pool_2x2(x.new_empty((*x.shape[:3],
                                      cfg.base_channels * 2 ** i)))


class Bands:
    """One batch part's rows in bands, band i (``parts[i]``, rows on axis 1)
    on its own device, in row order; no band is empty.  Row-local ops map
    over the bands, the 3x3 conv exchanges halos (module docstring)."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        if not parts or any(p.shape[1] == 0 for p in parts):
            raise ValueError("Bands needs one or more non-empty bands")
        self.parts: List[torch.Tensor] = list(parts)

    @classmethod
    def of(cls, parts: Sequence[torch.Tensor]) -> "Bands":
        """The non-empty ones of ``parts`` (``mesh.split_rows``' bands): an
        empty band computes nothing."""
        return cls([p for p in parts if p.shape[1]])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HALO_CONVS:
            return _halo_conv(func, args, kwargs)
        return _map(func, args, kwargs)

    def to(self, *args, **kwargs) -> "Bands":
        return _map(torch.Tensor.to, (self, *args), kwargs)

    def float(self) -> "Bands":
        return _map(torch.Tensor.float, (self,), {})

    def __getitem__(self, key) -> "Bands":
        if not (isinstance(key, tuple) and key and key[0] is Ellipsis):
            raise IndexError("Bands: only trailing axes may be indexed "
                             "(x[..., k]); the rows are split")
        return _map(torch.Tensor.__getitem__, (self, key), {})


def _binary(name: str):
    op = getattr(torch.Tensor, name)
    return lambda self, other: _map(op, (self, other), {})


# the operators the float families apply to activations
for _name in ("__add__", "__radd__", "__mul__", "__truediv__",
              "__rtruediv__", "__matmul__"):
    setattr(Bands, _name, _binary(_name))
Bands.__neg__ = lambda self: _map(torch.Tensor.__neg__, (self,), {})


def _find_bands(obj):
    if isinstance(obj, Bands):
        return obj
    if isinstance(obj, (list, tuple)):
        for o in obj:
            found = _find_bands(o)
            if found is not None:
                return found
    return None


def _band_arg(obj, i: int, device: torch.device, n: int):
    """``obj`` as band i sees it: a :class:`Bands` its part i, a tensor on
    ``device``, lists and tuples element by element."""
    if isinstance(obj, Bands):
        if len(obj.parts) != n:
            raise ValueError(f"Bands of {len(obj.parts)} and {n} bands meet")
        return obj.parts[i]
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_band_arg(o, i, device, n) for o in obj)
    return obj


def _map(func, args, kwargs) -> Bands:
    """``func`` on each band: the :class:`Bands` arguments' parts i, every
    other tensor on band i's device."""
    parts = _find_bands((args, tuple(kwargs.values()))).parts
    out = []
    for i, p in enumerate(parts):
        a = _band_arg(args, i, p.device, len(parts))
        kw = {k: _band_arg(v, i, p.device, len(parts))
              for k, v in kwargs.items()}
        out.append(func(*a, **kw))
    return Bands(out)


def halo_slabs(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The halo exchange: each band (N, h, W, C) as an (N, h + 2, W, C)
    slab, its rows between the last row of the band above and the first row
    of the band below, each copied to the band's device, or a zero row at
    the image's top or bottom edge: the rows a 3x3 SAME conv of the whole
    image reads for the band's output rows."""
    out = []
    for i, p in enumerate(parts):
        edge = p.new_zeros((p.shape[0], 1, *p.shape[2:]))
        top = parts[i - 1][:, -1:].to(p.device) if i > 0 else edge
        bottom = (parts[i + 1][:, :1].to(p.device) if i + 1 < len(parts)
                  else edge)
        out.append(torch.cat([top, p, bottom], dim=1))
    row = parts[0][:, :1].nbytes
    EXCHANGE["exchanges"] += 1
    EXCHANGE["halo_bytes"] += 2 * (len(parts) - 1) * row
    EXCHANGE["slab_bytes"] += sum(s.nbytes for s in out)
    return out


#: The 3x3 convs: each takes its input, the first argument, as a halo slab.
_HALO_CONVS = (conv.conv3x3_bias_act_train, conv_s8.conv3x3_s8,
               conv_s8.conv3x3_s8_q)


def _halo_conv(func, args, kwargs):
    """``func``, one of :data:`_HALO_CONVS`, of the whole image band by
    band: on each band's halo slab (``args[0]`` a :class:`Bands`, every
    other tensor copied to the band's device), the first and last output
    rows dropped; a conv that returns a list of outputs (``conv3x3_s8_q``,
    one per out scale) gives a list of :class:`Bands`.  Under autograd the
    gradient of a slab's edge rows flows back to the neighbour's rows
    through the exchange's copies."""
    x, rest = args[0], args[1:]
    outs = []
    for s in halo_slabs(x.parts):
        a = _band_arg(rest, 0, s.device, 1)
        kw = {k: _band_arg(v, 0, s.device, 1) for k, v in kwargs.items()}
        outs.append(func(s, *a, **kw))
    if isinstance(outs[0], list):
        return [Bands([o[j][:, 1:-1] for o in outs])
                for j in range(len(outs[0]))]
    return Bands([o[:, 1:-1] for o in outs])


def split(t: torch.Tensor, devices: Sequence[torch.device], unit: int
          ) -> Bands:
    """``t``'s rows in ``mesh.band_rows`` bands of whole ``unit`` rows,
    band i on ``devices[i]``; the empty bands (fewer units than devices)
    are left out (:meth:`Bands.of`)."""
    return Bands.of(pmesh.split_rows(t, devices, unit))


def gather(x: Bands, device: torch.device) -> torch.Tensor:
    """The bands' rows on ``device``, in order: the whole tensor."""
    return pmesh.gather_rows(x.parts, device)
