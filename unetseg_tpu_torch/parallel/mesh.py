"""Device meshes and the batch split over them, the port of
``unetseg_tpu/parallel/mesh.py``.

A mesh is a ``(dp, sp)`` array of ``torch.device``s: ``dp`` splits the
batch of slices, ``sp`` would split image rows.  JAX annotates shardings and
lets XLA place the work; here the three sharding helpers are explicit
functions on tensors:

* ``batch_sharding`` -> :func:`split_batch` (contiguous parts of the batch,
  one per dp device, in the order of ``P("dp")``) and :func:`gather_batch`
  (the parts back on one device, in batch order);
* ``replicated`` -> :func:`replicate` (one object per distinct device);
* ``batch_spatial_sharding`` -> :func:`spatial_split`, which refuses: the
  spatial split needs a halo exchange between devices, which XLA SPMD gives
  the JAX package and the port does not have yet (ROADMAP.md queue A, P9c).

A device list may repeat a device (``["cpu"] * 4``, ``["cuda:0"] * 2``):
the split is by position, so one machine can exercise it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch


class Mesh(NamedTuple):
    """``devices``: (dp, sp) object array of ``torch.device``; ``shape``:
    ``{"dp": dp, "sp": sp}``."""
    devices: np.ndarray
    shape: Dict[str, int]


def visible_devices() -> List[torch.device]:
    """Every CUDA device this process sees; raises without CUDA (entry
    points run on the card unless the caller names its devices)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=[...] "
                           "explicitly (e.g. ['cpu']) to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, sp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, sp) mesh over the first ``n_devices`` of ``devices`` (default:
    every visible CUDA device); dp varies slower, as in JAX."""
    devices = [torch.device(d) for d in (
        visible_devices() if devices is None else devices)]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % sp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by sp={sp}")
    dp = n_devices // sp
    arr = np.empty((n_devices,), dtype=object)
    arr[:] = devices[:n_devices]
    return Mesh(arr.reshape(dp, sp), {"dp": dp, "sp": sp})


def dp_devices(mesh: Mesh) -> List[torch.device]:
    """The devices along dp (the first of each sp row)."""
    return [mesh.devices[i, 0] for i in range(mesh.shape["dp"])]


def split_batch(t: torch.Tensor, devices: Sequence[torch.device]
                ) -> List[torch.Tensor]:
    """``t``'s leading axis in ``len(devices)`` contiguous equal parts, part
    i copied to ``devices[i]`` (enqueued, not waited for).  The caller
    checks that the batch divides."""
    n = len(devices)
    k = t.shape[0] // n
    if k * n != t.shape[0]:
        raise ValueError(f"batch {t.shape[0]} does not split over {n} "
                         f"devices")
    return [t[i * k:(i + 1) * k].to(d, non_blocking=True)
            for i, d in enumerate(devices)]


def gather_batch(parts: Sequence[torch.Tensor], device: torch.device
                 ) -> torch.Tensor:
    """The parts on ``device``, concatenated in order."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def replicate(build: Callable[[torch.device], object],
              devices: Sequence[torch.device]) -> list:
    """``build(device)`` for each position of ``devices``; a device that
    repeats shares the first object built for it."""
    built: dict = {}
    for d in devices:
        if d not in built:
            built[d] = build(d)
    return [built[d] for d in devices]


def spatial_split():
    """Rows over ``sp``: refused (ROADMAP.md queue A, P9c)."""
    from unetseg_tpu_torch.engine import not_ported

    raise not_ported("the spatial (sp) split", "P9c")
