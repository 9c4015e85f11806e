"""Multi-process initialization and the collectives the port uses: the
port of ``plip_tpu.parallel.distributed`` on ``torch.distributed``.

One call per process before any collective::

    from plip_tpu_torch.parallel import distributed
    distributed.initialize()                       # torchrun's environment
    distributed.initialize("10.0.0.1:29500", 2, 0)  # or an explicit address
    mesh = create_mesh(dp=2)                        # parallel.mesh

The backend is NCCL where the process has a CUDA device and gloo on the CPU
(``backend=`` names another: gloo, which takes CUDA tensors too, runs
several ranks on one card, which NCCL refuses). The process group always has a finite
timeout, so a rank whose peer died raises instead of waiting forever.

Every collective here must be entered by every rank of the group, the same
number of times and in the same order. Each takes a ``group`` (None: the
default group); a broadcast's source is the group's first global rank.

Tensor parallelism (``parallel.mesh``) runs on a ``TPGroup`` and two
autograd functions, Megatron's pair: ``copy_to_tp`` (identity forward, the
gradient all-reduced backward) before a column-parallel product, and
``reduce_from_tp`` (the partials all-reduced forward, identity backward)
after a row-parallel one. Both sum in fp32.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S, backend: Optional[str] = None) -> bool:
    """Create the default process group. Returns True if there is more than
    one process.

    ``coordinator_address``: ``"host:port"`` of rank 0, with
    ``num_processes`` and ``process_id``. Without it the group is read from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); with neither it creates no group and returns False. A request
    that fails raises. Calling it again once the group exists returns at
    once. Under NCCL the process takes the card ``LOCAL_RANK`` (torchrun's),
    else ``process_id`` modulo the cards."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        if not all(k in os.environ for k in _ENV):
            return False
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return world > 1


def world_size() -> int:
    """Processes in the default group (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def group_device() -> torch.device:
    """Where the default group's collective buffers live: this process's
    card under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def agree_max_int(value: int) -> int:
    """Every process proposes an integer and all receive the largest: an
    all-reduce MAX of one int64 on the group's device. It lets the
    processes take the same decision (the tuner's accumulation factor, a
    failure) before any of them enters another collective. One process:
    ``value``, no device work."""
    if world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=group_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def local_batch_slice(global_batch: int) -> slice:
    """This process's rows of a globally ordered batch."""
    per = global_batch // world_size()
    start = rank() * per
    return slice(start, start + per)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` (each the same shape) concatenated along dim 0 in
    the group's rank order, on ``x``'s device. No autograd; without a
    group, ``x``."""
    if not dist.is_initialized():
        return x.detach()
    x = x.detach().contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the group's ranks, in place."""
    if not dist.is_initialized():
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_max_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t``'s elementwise maximum over the group's ranks, in place."""
    if not dist.is_initialized():
        return t
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def first_rank(group=None) -> int:
    """The global rank of the group's first process (0 for the default
    group, or without one)."""
    if group is None or not dist.is_initialized():
        return 0
    return dist.get_global_rank(group, 0)


def broadcast_(t: torch.Tensor, src: Optional[int] = None, group=None) -> torch.Tensor:
    """``t`` replaced by global rank ``src``'s, in place; by default the
    group's first rank's (``first_rank``)."""
    if not dist.is_initialized():
        return t
    dist.broadcast(t, src=first_rank(group) if src is None else src, group=group)
    return t


# ---------------------------------------------------------------------------
# Tensor parallelism: the group of a tp axis and its two autograd functions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class TPGroup:
    """The tensor-parallel group a sharded module runs its collectives on:
    ``group`` (a ``torch.distributed`` group; None: the default group),
    ``size`` ranks, this process ``rank`` among them. Set on the modules by
    ``parallel.mesh.shard_params``; a module without one runs meshless."""

    group: Optional[object]
    size: int
    rank: int

    def __deepcopy__(self, memo):  # a process group cannot be copied
        return self

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place (exact for integers)."""
        return all_reduce_sum_(t, self.group)

    def all_reduce_max_(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_max_(t, self.group)

    def sum_f32(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: ``t`` summed over the group in fp32, cast back to
        t's dtype (one rounding of the whole sum for a bf16 ``t``)."""
        s = t.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        self.all_reduce_(s)
        return s.to(t.dtype)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group backward: the
    input of column-parallel products, replicated on every rank, whose
    gradient each rank holds only the share of its columns of."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum_f32(g), None


class _ReduceFromTP(torch.autograd.Function):
    """The ranks' partials summed over the tp group forward (in fp32);
    identity backward: the output is replicated, so is its gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum_f32(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """``_CopyToTP`` over ``tp`` (``x`` itself without one)."""
    return x if tp is None else _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """``_ReduceFromTP`` over ``tp`` (``x`` itself without one)."""
    return x if tp is None else _ReduceFromTP.apply(x, tp)
