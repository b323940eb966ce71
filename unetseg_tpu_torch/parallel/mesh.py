"""Device meshes and the batch split over them, the port of
``unetseg_tpu/parallel/mesh.py``.

A mesh is a ``(dp, sp)`` array of ``torch.device``s: ``dp`` splits the
batch of slices, ``sp`` splits image rows.  JAX annotates shardings and
lets XLA place the work; here the three sharding helpers are explicit
functions on tensors:

* ``batch_sharding`` -> :func:`split_batch` (contiguous parts of the batch,
  one per dp device, in the order of ``P("dp")``; :func:`split_ragged` for a
  count that does not divide) and :func:`gather_batch` (the parts back on
  one device, in batch order);
* ``replicated`` -> :func:`replicate` (one object per distinct device);
* ``batch_spatial_sharding`` -> :func:`spatial_split` (the batch over dp,
  then each part's rows over its sp row of devices, in bands of whole
  units: :func:`band_rows`, :func:`split_rows`) and :func:`gather_rows`.
  The halo exchange that XLA SPMD inserts around each conv is
  ``parallel/spatial.py``'s.

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
    i copied to ``devices[i]`` (enqueued, not waited for); a batch that
    does not divide raises ``ValueError``."""
    return [p.to(d, non_blocking=True)
            for p, d in zip(_batch_parts(t, len(devices)), devices)]


def _batch_parts(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    k = t.shape[0] // n
    if k * n != t.shape[0]:
        raise ValueError(f"batch {t.shape[0]} does not split over {n} "
                         f"devices")
    return [t[i * k:(i + 1) * k] for i in range(n)]


def split_ragged(t: torch.Tensor, devices: Sequence[torch.device]
                 ) -> List[torch.Tensor]:
    """``t``'s leading axis in contiguous parts of ``ceil(n / len(devices))``
    rows, the last one shorter, part i copied to ``devices[i]`` (enqueued,
    not waited for): an uneven count splits too, as GSPMD pads JAX's
    ``P("dp")``, and the devices past the last row get no part."""
    k = -(-t.shape[0] // len(devices))
    return [t[i:i + k].to(d, non_blocking=True)
            for i, d in zip(range(0, t.shape[0], k), devices)]


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


def band_rows(h: int, sp: int, unit: int) -> List[range]:
    """The rows of each of ``sp`` bands of an ``h``-row image: contiguous,
    in order, each a whole number of ``unit`` rows, as even as that allows
    (the first ``h // unit % sp`` bands one unit more, as ``np.array_split``
    deals); a band is empty when there are fewer units than bands.  The
    caller checks that ``unit`` divides ``h``."""
    units, extra = divmod(h // unit, sp)
    out, start = [], 0
    for i in range(sp):
        stop = start + (units + (i < extra)) * unit
        out.append(range(start, stop))
        start = stop
    return out


def split_rows(t: torch.Tensor, devices: Sequence[torch.device], unit: int
               ) -> List[torch.Tensor]:
    """``t``'s rows (axis 1) in :func:`band_rows` bands, band i copied to
    ``devices[i]`` (enqueued, not waited for); an empty band is a zero-row
    tensor."""
    rows = band_rows(t.shape[1], len(devices), unit)
    return [t[:, r.start:r.stop].to(d, non_blocking=True)
            for r, d in zip(rows, devices)]


def gather_rows(parts: Sequence[torch.Tensor], device: torch.device
                ) -> torch.Tensor:
    """The bands on ``device``, their rows concatenated in order."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=1)


def spatial_split(t: torch.Tensor, mesh: Mesh, unit: int
                  ) -> List[List[torch.Tensor]]:
    """JAX's ``P("dp", "sp")``: ``t``'s batch in contiguous parts over dp
    (:func:`split_batch`'s parts), then each part's rows over its row of
    the mesh (:func:`split_rows`): ``[dp][sp]`` tensors, each on its mesh
    device."""
    return [split_rows(p, mesh.devices[i], unit) for i, p in
            enumerate(_batch_parts(t, mesh.shape["dp"]))]
