"""A forward of a fixed shape captured once into a CUDA graph and replayed
per batch (the reference serves through a graph captured at warm-up,
src/process.cpp:90-105, 141-155).

Enqueued from Python, a flagship forward is a chain of ~100 launches: 16
conv wrappers (shape checks, the tile plan, a ctypes call that encodes
two TMA descriptors), K6's, the casts, pools, up-convs and cats.  A replay
enqueues the whole chain with one ``cudaGraphLaunch``: the same kernels
with the same tile plans in the same order.  The descriptors a kernel's C
entry encoded at the capture hold the addresses of the capture, so a graph
reads its one static input buffer, writes its one static output, and keeps
its intermediates in a memory pool that lives as long as the graph.

The kernel wrappers count launches as they enqueue them, each in a
``LAUNCHES`` dict it registers here (:func:`counts_launches`).  The
increments made while capturing are taken back (no kernel ran) and added
again at each replay, so the counters keep counting launches that ran.
:func:`reset_launches` sets every registered counter to 0.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: The launch counters of the kernel wrappers, registered as each wrapper
#: module is imported (:func:`counts_launches`).
COUNTERS: List[Dict[str, int]] = []


def counts_launches(counter: Dict[str, int]) -> Dict[str, int]:
    """Registers a kernel wrapper's launch counter, so that a capture takes
    back the increments it made and a replay adds them; returns it."""
    COUNTERS.append(counter)
    return counter


def reset_launches() -> None:
    """Sets every registered launch counter to 0."""
    for counter in COUNTERS:
        counter.update(dict.fromkeys(counter, 0))


def key(t: torch.Tensor) -> tuple:
    """What a graph is captured for: its input's shape, dtype and
    device."""
    return tuple(t.shape), t.dtype, t.device


def on_device(device: torch.device):
    """The context that makes ``device`` current, where it is a card: a
    capture's stream and a replay's launch go to the current device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _capture(fn: Callable, static_in: torch.Tensor, pool
             ) -> Tuple[torch.cuda.CUDAGraph, torch.Tensor]:
    """``fn(static_in)``'s launches captured into a new graph (none runs):
    (the graph, ``fn``'s output in the graph's pool).  Other threads may
    use the card meanwhile (``thread_local``)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        out = fn(static_in)
    return graph, out


class ForwardGraph:
    """``fn`` on one static input, captured; :meth:`replay` serves an input
    of the same shape and dtype.  ``pool`` is another graph's memory pool
    to share (:attr:`pool`): safe while the graphs replay one after
    another on one stream, since each keeps its own input and output."""

    def __init__(self, fn: Callable, static_in: torch.Tensor, pool=None):
        self.static_in = static_in
        before = [dict(c) for c in COUNTERS]
        with on_device(static_in.device):
            self.graph, self.static_out = _capture(fn, static_in, pool)
        #: (counter, name, launches) a replay adds.
        self.launches: List[Tuple[dict, str, int]] = []
        for counter, was in zip(COUNTERS, before):
            for name, n in counter.items():
                if n != was[name]:
                    self.launches.append((counter, name, n - was[name]))
            counter.update(was)
        with on_device(static_in.device):
            # the first launch uploads the graph: set-up, counted nowhere
            self.graph.replay()

    @property
    def pool(self):
        return self.graph.pool()

    def replay(self, t: torch.Tensor) -> torch.Tensor:
        """``fn(t)``, enqueued on the current stream: ``t`` copied into the
        static input, the graph replayed, and a fresh copy of the static
        output returned, so no result aliases the next replay's."""
        with on_device(t.device):
            self.static_in.copy_(t)
            self.graph.replay()
            out = self.static_out.clone()
        for counter, name, n in self.launches:
            counter[name] += n
        return out


def lookup(graphs: dict, t) -> Optional[ForwardGraph]:
    """The graph of ``graphs`` captured for ``t``, or None: ``t`` not a
    plain tensor (a ``__torch_function__`` override such as
    ``parallel.spatial.Bands``), or of a shape, dtype or device none was
    captured for."""
    if not graphs or type(t) is not torch.Tensor:
        return None
    return graphs.get(key(t))
