"""Device meshes of the multi-device layer, and the moves between their positions.

Counterpart of ``dxt_lossless_transform_tpu/parallel/mesh.py``. A :class:`Mesh` is a
``(files, blocks)`` grid of ``torch.device``s driven by one Python process, as a JAX
mesh is by its controller: the steps of :mod:`.sharded` hold one shard of a batch at
each position of the grid and move bytes between positions. A mesh may list one
device more than once, the counterpart of XLA's virtual host devices, so that one
card runs the 8-shard exchange.

Under a process group (:func:`.distributed.initialize`) the mesh spans every rank's
devices, rank by rank, and each rank holds the shards of its own positions. A move
between positions of two ranks goes over ``torch.distributed`` point to point
(``batch_isend_irecv``; on the rank's first device of the mesh, its ``home``), sums
over the positions take one ``all_reduce``, and a step's outputs reach every rank by
``broadcast``. Within a rank a move is a copy between devices, which PyTorch orders
after the work queued on both devices' current streams.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import backend
from ..errors import DeviceUnavailableError

Position = Tuple[int, int]
#: a move: (source position, its view, destination position, its view); each view is
#: a function that returns the tensor, called only on the rank that holds it
Move = Tuple[Position, Callable[[], torch.Tensor], Position, Callable[[], torch.Tensor]]


def _group() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A ``(files, blocks)`` grid of devices.

    ``devices`` is the grid (a 2-D numpy array of ``torch.device``), ``shape`` maps
    each axis name to its size, ``ranks`` is the grid of the ranks that hold the
    positions (all 0 in one process) and ``home`` this rank's first device, where the
    steps return their outputs."""

    def __init__(self, devices, axis_names: Sequence[str] = ("files", "blocks"),
                 ranks=None):
        listed = np.asarray(devices, dtype=object)
        grid = np.empty(listed.shape, dtype=object)
        for index in np.ndindex(grid.shape):
            grid[index] = torch.device(listed[index])
        if grid.ndim != 2 or grid.size == 0 or len(axis_names) != 2:
            raise ValueError(f"a mesh is a non-empty 2-D grid with two axis names, got "
                             f"shape {grid.shape} and {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.ranks = (np.zeros(grid.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(grid.shape))
        self.rank, self.world = _group()
        self.positions: List[Position] = [
            (f, s) for f, s in np.ndindex(grid.shape) if self.ranks[f, s] == self.rank]
        if not self.positions:
            raise ValueError(f"rank {self.rank} holds no position of the mesh")
        self.home = self.devices[self.positions[0]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"

    def local(self, pos: Position) -> bool:
        return self.ranks[pos] == self.rank

    def run(self, moves: Sequence[Move]) -> None:
        """Make every move whose source or destination this rank holds. The
        destinations must not overlap: the moves from other ranks land after the
        local ones."""
        ops, received = [], []
        for tag, (src, get_src, dst, get_dst) in enumerate(moves):
            src_rank, dst_rank = self.ranks[src], self.ranks[dst]
            if src_rank == self.rank and dst_rank == self.rank:
                get_dst().copy_(get_src())
            elif src_rank == self.rank:
                ops.append(dist.P2POp(dist.isend, get_src().to(self.home).contiguous(),
                                      int(dst_rank), tag=tag))
            elif dst_rank == self.rank:
                view = get_dst()
                buf = torch.empty(view.shape, dtype=view.dtype, device=self.home)
                ops.append(dist.P2POp(dist.irecv, buf, int(src_rank), tag=tag))
                received.append((view, buf))
        if ops:
            for request in dist.batch_isend_irecv(ops):
                request.wait()
        for view, buf in received:
            view.copy_(buf)

    def sum_files(self, parts: dict) -> torch.Tensor:
        """(files, *shape) on ``home``: row f is the sum of the parts (each of one
        shape) that the positions of files-row f hold, over every rank."""
        like = next(iter(parts.values()))
        total = torch.zeros((self.shape["files"], *like.shape), dtype=like.dtype,
                            device=self.home)
        for (f, _), part in parts.items():
            total[f] += part.to(self.home)
        if self.world > 1:
            dist.all_reduce(total)
        return total

    def gather(self, shards: dict, dim: int) -> torch.Tensor:
        """The whole tensor on ``home``: the shards (each of one shape) joined along
        ``dim`` over the blocks axis and along dim 0 over the files axis."""
        if self.world == 1:
            whole = {pos: t.to(self.home) for pos, t in shards.items()}
        else:
            like = next(iter(shards.values()))
            whole = {}
            for pos in np.ndindex(self.devices.shape):
                buf = (shards[pos].to(self.home).contiguous() if self.local(pos) else
                       torch.empty(like.shape, dtype=like.dtype, device=self.home))
                dist.broadcast(buf, src=int(self.ranks[pos]))
                whole[pos] = buf
        nf, nb = self.devices.shape
        return torch.cat([torch.cat([whole[f, s] for s in range(nb)], dim=dim)
                          for f in range(nf)], dim=0)


def require(mesh) -> Mesh:
    """``mesh`` itself; anything but a :class:`Mesh` raises ``TypeError``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a Mesh (make_mesh), got {type(mesh).__name__}")
    return mesh


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("files", "blocks"),
              devices=None) -> Mesh:
    """A 2-D ``(files, blocks)`` mesh over the first ``n_devices`` devices.

    As JAX's: the blocks axis is the largest power of two that divides the device
    count (it bounds the largest texture a step holds), the files axis takes the
    rest; 8 devices give ``(1, 8)``, 6 give ``(3, 2)``. ``devices`` defaults to the
    process's CUDA devices and may repeat one. Under a process group it lists this
    rank's devices, and the mesh holds every rank's, rank by rank."""
    if devices is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "no CUDA device is available; pass devices=[torch.device('cpu')] * n "
                "for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [backend.resolve_device(d) for d in devices]
    rank, world = _group()
    ranks = [rank] * len(devices)
    if world > 1:
        listed: list = [None] * world
        dist.all_gather_object(listed, [str(d) for d in devices])
        devices = [torch.device(d) for names in listed for d in names]
        ranks = [r for r, names in enumerate(listed) for _ in names]
    if n_devices is not None:
        devices, ranks = devices[:n_devices], ranks[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    blocks = 1
    while blocks * 2 <= n and n % (blocks * 2) == 0:
        blocks *= 2
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // blocks, blocks), axis_names,
                np.asarray(ranks).reshape(n // blocks, blocks))
