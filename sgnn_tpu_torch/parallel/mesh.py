"""The data-parallel process group: the one place that joins ranks.

The port of sgnn_tpu/parallel/mesh.py.  Reference communication stack
(SURVEY.md §2.6): NCCL AllReduce of gradients between the GPUs of one
machine, MPI across machines.  The JAX package builds one ("data",
"graph") device mesh; here each rank is a process driving one device, and
the ranks of the "data" axis form one `torch.distributed` group — NCCL on
CUDA, gloo on the CPU.  The backend follows the device, never the other
way round: `sgnn_tpu_torch.resolve_device` picks the device, and a rank
without a card raises there instead of falling back to the CPU.

`make_group` joins, in this order:
  1. an already initialised default group (a launcher or a test made it);
  2. torchrun's environment (WORLD_SIZE/RANK/LOCAL_RANK): `env://`, one
     card a rank, `cuda:{LOCAL_RANK}`;
  3. otherwise a one-rank group over an in-process `HashStore` (no TCP
     store): on one card, the JAX package's one-device mesh.
The "graph" axis (row-partitioned whole-graph training) is ROADMAP item 6b.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device

GRAPH_AXIS_NOT_PORTED = (
    "a mesh with more than one graph rank (the row-partitioned whole-graph "
    "path) is not ported yet: ROADMAP Queue 1 item 6 (6b)")


def backend_for(device: torch.device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


@dataclasses.dataclass
class DataGroup:
    """This process's place on the "data" axis: its rank, the number of
    ranks, its device and the group's backend.  With `timed` set, CUDA
    events mark each collective region on the card (`region_times`)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    timed: bool = False
    _events: List = dataclasses.field(default_factory=list, repr=False)

    def __post_init__(self) -> None:
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"rank {self.rank}: an NCCL group needs a CUDA "
                             f"device, not {self.device}")

    @contextlib.contextmanager
    def timed_region(self, tag: str, nbytes: int):
        """Mark the work issued inside on the card's timeline (a no-op
        unless `timed` on a CUDA rank)."""
        if not (self.timed and self.device.type == "cuda"):
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._events.append((tag, nbytes, start, end))

    def region_times(self) -> Dict[str, List[Tuple[int, float]]]:
        """(bytes, ms) of each timed region since the last call, by tag
        (reading them syncs)."""
        got: Dict[str, List[Tuple[int, float]]] = {}
        for tag, nbytes, start, end in self._events:
            got.setdefault(tag, []).append((nbytes, start.elapsed_time(end)))
        self._events = []
        return got

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place SUM over the ranks (the reference's NCCL AllReduce)."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place: rank `src`'s values on every rank."""
        dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        dist.barrier()

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradient TOTAL over the ranks, the JAX package's `psum_grads`
        (sgnn_tpu/utils/vma.py:56-78): the leaves flattened into one
        contiguous buffer and one all_reduce(SUM) — a sum, not the mean
        DistributedDataParallel takes, and once a step at the trainer
        level, never inside a backward (that would count twice).  On one
        rank the values come back unchanged."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        with self.timed_region("grad_all_reduce",
                               flat.numel() * flat.element_size()):
            self.all_reduce_sum_(flat)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return out


def make_group(device=None, graph: int = 1) -> DataGroup:
    """This process's data-parallel group (module docstring).  `device`
    as `resolve_device` takes it; under torchrun a CUDA rank takes
    `cuda:{LOCAL_RANK}`."""
    if graph != 1:
        raise NotImplementedError(GRAPH_AXIS_NOT_PORTED)
    dev = resolve_device(device)
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != backend_for(dev):
            raise ValueError(f"the initialised {backend} group does not "
                             f"serve a {dev.type} rank")
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        backend = backend_for(dev)
        dist.init_process_group(backend, init_method="env://")
    else:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device()
                               if dev.index is None else dev.index)
            torch.cuda.set_device(dev)
        backend = backend_for(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return DataGroup(rank=dist.get_rank(), world_size=dist.get_world_size(),
                     device=dev, backend=backend)
