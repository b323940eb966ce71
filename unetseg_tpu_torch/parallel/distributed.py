"""Multi-process initialization and study-level sharding, the port of
``unetseg_tpu/parallel/distributed.py``.

Inference splits across processes by whole studies (:func:`shard_studies`):
each process serves its share on its own devices, with no traffic between
processes.  Training does not: ``train.make_sharded_train_step`` in a
multi-process run takes each process's rows of the global batch on that
process's mesh (:func:`global_mesh`, dp and sp over its own devices) and
sums the loss and the gradients over the processes.
:func:`initialize_distributed` starts ``torch.distributed`` from the same
environment variables the JAX package reads, so a deployment's environment
works unchanged; in a single process it is a no-op.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from unetseg_tpu_torch.parallel import mesh as pmesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda") -> bool:
    """Join the process group; True if a multi-process group was started,
    False in a single process (nothing to do).

    The arguments default to ``JAX_COORDINATOR_ADDRESS`` (``host:port`` of
    process 0), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``.  The group
    rendezvous is ``tcp://<coordinator_address>`` with the ``nccl`` backend
    for ``device="cuda"`` and ``gloo`` for the CPU."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    num = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num <= 1 and coordinator_address is None:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address "
                         "and this process's id (JAX_COORDINATOR_ADDRESS, "
                         "JAX_PROCESS_ID)")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num, rank=process_id)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(sp: int = 1, devices: Optional[Sequence] = None
                ) -> pmesh.Mesh:
    """The (dp, sp) mesh of this process: its own devices (default every
    CUDA device it sees).  A PyTorch process computes on its own devices
    only, so each rank's mesh spans that rank's share of the cluster."""
    return pmesh.make_mesh(sp=sp, devices=devices)


def shard_studies(study_paths: Sequence[str]) -> List[str]:
    """This process's studies: round-robin by rank over the world, with no
    traffic between processes."""
    pid, n = process_index(), process_count()
    return [p for i, p in enumerate(study_paths) if i % n == pid]
