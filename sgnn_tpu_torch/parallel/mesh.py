"""The process group: the one place that joins ranks.

The port of sgnn_tpu/parallel/mesh.py.  Reference communication stack
(SURVEY.md §2.6): NCCL AllReduce of gradients between the GPUs of one
machine, MPI across machines.  The JAX package builds one ("data",
"graph") device mesh; here each rank is a process driving one device, and
the ranks form one `torch.distributed` group — NCCL on CUDA, gloo on the
CPU — that sits on one axis: "data" (the *MULTI engines: every rank trains
on its share of the seeds) or "graph" (`make_group(graph=n)`: every rank
holds one vertex range of the whole graph, `FullBatchTrainer(mesh=...)`).
A mixed data × graph layout does not exist, as the JAX FullBatchTrainer,
which shards over every device of its mesh, has none.  The backend follows
the device, never the other way round: `sgnn_tpu_torch.resolve_device`
picks the device, and a rank without a card raises there instead of
falling back to the CPU.

`make_group` joins, in this order:
  1. an already initialised default group (a launcher, a test or
     `parallel/multihost.initialize_distributed` made it);
  2. torchrun's environment (WORLD_SIZE/RANK/LOCAL_RANK): `env://`, one
     card a rank, `cuda:{LOCAL_RANK}`;
  3. otherwise a one-rank group over an in-process `HashStore` (no TCP
     store): on one card, the JAX package's one-device mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device


def backend_for(device: torch.device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


@dataclasses.dataclass
class DataGroup:
    """This process's place in the group: its rank, the number of ranks,
    its device, the group's backend and `graph`, the ranks on the "graph"
    axis (1: a data-parallel group; the world size: a graph group, one
    vertex range a rank; a one-rank group is both).  With `timed` set,
    CUDA events mark each collective region on the card
    (`region_times`)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    graph: int = 1
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

    def all_reduce_sum_(self, t: torch.Tensor,
                        tag: Optional[str] = None) -> torch.Tensor:
        """In-place SUM over the ranks (the reference's NCCL AllReduce),
        a timed region named `tag` when one is given."""
        if tag is None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            return t
        with self.timed_region(tag, t.numel() * t.element_size()):
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    # the halo's collectives (parallel/halo.py): rows are dim 0, every rank
    # passes the same shape; each is a timed region of the buffer's bytes
    def all_gather_rows(self, x: torch.Tensor,
                        tag: str = "halo_all_gather") -> torch.Tensor:
        """[rows, ...] on every rank → [n·rows, ...], rank r's rows at
        block r."""
        out = x.new_empty((self.world_size * x.shape[0], *x.shape[1:]))
        with self.timed_region(tag, out.numel() * out.element_size()):
            dist.all_gather_into_tensor(out, x.contiguous())
        return out

    def reduce_scatter_rows(self, t: torch.Tensor,
                            tag: str = "halo_reduce_scatter"
                            ) -> torch.Tensor:
        """[n·rows, ...] on every rank → [rows, ...]: rank r gets the SUM
        over the ranks of their block r (all_gather's transpose)."""
        out = t.new_empty((t.shape[0] // self.world_size, *t.shape[1:]))
        with self.timed_region(tag, t.numel() * t.element_size()):
            dist.reduce_scatter_tensor(out, t.contiguous(),
                                       op=dist.ReduceOp.SUM)
        return out

    def all_to_all_rows(self, t: torch.Tensor,
                        tag: str = "halo_all_to_all") -> torch.Tensor:
        """[n, k, ...] on every rank → [n, k, ...]: block q of rank p's
        input is block p of rank q's output."""
        out = torch.empty_like(t)
        with self.timed_region(tag, t.numel() * t.element_size()):
            dist.all_to_all_single(out, t.contiguous())
        return out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place: rank `src`'s values on every rank."""
        dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradient TOTAL over the ranks, the JAX package's `psum_grads`
        (sgnn_tpu/utils/vma.py:56-78): the leaves flattened into one
        contiguous buffer and one all_reduce(SUM) — a sum, not the mean
        DistributedDataParallel takes, and once a step at the trainer
        level, never inside a backward (that would count twice).  On one
        rank the values come back unchanged."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce_sum_(flat, "grad_all_reduce")
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return out


def process_world_size() -> int:
    """The ranks of the group `make_group` joins: an initialised group's,
    else torchrun's WORLD_SIZE, else 1 (the one-rank group)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return 1


def check_graph_axis(graph: int, world_size: int) -> None:
    """Raise unless `graph` ranks on the graph axis fill a group of
    `world_size`: ValueError for a count that does not divide it,
    NotImplementedError for a mixed data × graph layout."""
    if graph < 1 or world_size % graph:
        raise ValueError(f"graph={graph} ranks on the graph axis, but the "
                         f"group has {world_size}")
    if graph != world_size:
        raise NotImplementedError(
            f"a mixed layout ({world_size // graph} data × {graph} graph "
            f"ranks): whole-graph training shards over every rank of its "
            f"group, as the JAX FullBatchTrainer over every device of its "
            f"mesh")


def make_group(device=None, graph: int = 1) -> DataGroup:
    """This process's group (module docstring): a data-parallel one, or
    with `graph` > 1 a graph group, whose ranks must all sit on the graph
    axis (`check_graph_axis`, before any group is joined).  `device` as
    `resolve_device` takes it; under torchrun a CUDA rank takes
    `cuda:{LOCAL_RANK}`."""
    if graph != 1:
        check_graph_axis(graph, process_world_size())
    dev = resolve_device(device)
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != backend_for(dev):
            raise ValueError(f"the initialised {backend} group does not "
                             f"serve a {dev.type} rank")
        if dev.type == "cuda" and dev.index is None:
            # the card the process joined on (multihost.rank_device)
            dev = torch.device("cuda", torch.cuda.current_device())
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
                     device=dev, backend=backend, graph=graph)
