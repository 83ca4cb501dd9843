"""Several processes, one mesh: the process group of the multi-device layer.

Counterpart of ``dxt_lossless_transform_tpu/parallel/distributed.py``. As in JAX, a
mesh is driven by one controller per process, and processes come in only across
hosts: :func:`initialize` joins this process to a ``torch.distributed`` group, after
which :func:`.mesh.make_mesh` spans every rank's devices and the blocks axis may
cross ranks. Every rank calls each step with the whole batch; it computes its own
positions' shards, exchanges halos and partial counts with the others, and gets every
output back whole.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

from .. import backend


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Union[str, torch.device] = "cuda") -> bool:
    """Join the process group at ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes``: ``"nccl"`` for a mesh of CUDA devices (each
    rank's current device), ``"gloo"`` for one on the CPU (``device="cpu"``).
    Returns whether more than one process is in the group: False, and nothing done,
    for ``num_processes`` <= 1 or when no cluster is given."""
    if num_processes is not None and num_processes <= 1:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None or num_processes is None or process_id is None:
        return False
    kind = backend.resolve_device(device).type
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the process that should write outputs and print reports: rank 0, or
    the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0
