"""The process mesh and its data-parallel rules: the port of
``plip_tpu.parallel.mesh`` (the dp half).

A ``Mesh`` names the ``dp`` (data) and ``tp`` (tensor) axes over the
processes of a ``torch.distributed`` group, one process a device. Under dp
every process holds all the parameters (``replicate_params``: rank 0's,
broadcast) and its own rows of each globally ordered batch
(``shard_batch``, ``local_rows``); the consumers gather what the global
result needs (``train.contrastive``, ``api.PLIP``, ``data.wsi``,
``ops.retrieval``). ``tp > 1`` is accepted by ``create_mesh`` and refused by
every consumer (``require_dp_only``): the head-sharded kernels are ROADMAP
item 9b.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import distributed

TP_REFUSAL = ("tensor parallelism (tp > 1) is not ported: it needs head-sharded "
              "kernels and an all-reduce before the residual (ROADMAP.md item 9b)")


@dataclasses.dataclass
class Mesh:
    """``shape``: ``{"dp": ..., "tp": ...}``; ``group``: the process group
    (None: the default group, or no group for one process); ``device``:
    where the group's collective buffers live."""

    shape: Dict[str, int]
    group: Optional[object] = None
    device: torch.device = torch.device("cpu")

    @property
    def dp(self) -> int:
        return self.shape["dp"]

    @property
    def rank(self) -> int:
        return distributed.rank()


def create_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """A ``(dp, tp)`` mesh over the default group's processes (one without
    a group). ``dp`` defaults to processes // tp; ``dp * tp`` must equal the
    number of processes."""
    n = distributed.world_size()
    if tp < 1 or (dp is not None and dp < 1):
        raise ValueError(f"mesh axes must be positive, got dp={dp}, tp={tp}")
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} processes")
    return Mesh({"dp": dp, "tp": tp}, None, distributed.group_device())


def require_dp_only(mesh: Optional[Mesh], who: str) -> None:
    """Raise ``ValueError`` unless ``mesh`` is None or has ``tp == 1``."""
    if mesh is not None and mesh.shape.get("tp", 1) != 1:
        raise ValueError(f"{who}: {TP_REFUSAL}; got mesh {mesh.shape}")


def local_rows(n: int, mesh: Mesh) -> Tuple[int, int, int]:
    """``(lo, hi, shard)``: this rank's rows ``[lo, hi)`` of ``n`` rows split
    in shards of ``ceil(n / dp)`` (the last ranks may hold fewer, or none)."""
    shard = -(-n // mesh.dp)
    lo = min(mesh.rank * shard, n)
    return lo, min(lo + shard, n), shard


def gather_rows(x: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """The ``n``-row global result from each rank's ``local_rows`` part
    ``x``: padded to the shard, gathered in rank order, the pad dropped.
    Every rank calls it and gets the same rows."""
    shard = -(-n // mesh.dp)
    if x.shape[0] < shard:
        x = F.pad(x, (0, 0) * (x.dim() - 1) + (0, shard - x.shape[0]))
    return distributed.all_gather_rows(x, mesh.group)[:n]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a globally ordered batch (a tensor, an array, a
    list, or a tuple of them); the batch must divide over dp."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(b, mesh) for b in batch)
    n = len(batch)
    if n % mesh.dp:
        raise ValueError(f"batch of {n} rows does not divide over dp={mesh.dp}")
    per = n // mesh.dp
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


@torch.no_grad()
def replicate_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``model`` set to rank 0's (a broadcast,
    in place): the dp counterpart of the JAX package's ``shard_params``."""
    if mesh.dp > 1:
        for t in [*model.parameters(), *model.buffers()]:
            distributed.broadcast_(t.data, 0, mesh.group)
    return model

