"""The process mesh and its sharding rules: the port of
``plip_tpu.parallel.mesh``.

A ``Mesh`` names the ``dp`` (data) and ``tp`` (tensor) axes over the
processes of a ``torch.distributed`` group, one process a device. Global
rank ``r = d * tp + t``, as the JAX package lays its devices out
(``devices.reshape(dp, tp)``); ``create_mesh`` makes, on every rank in the
same order, the tp groups (``tp`` consecutive ranks) and the dp groups (the
ranks of one ``t``).

- dp: the rows of each globally ordered batch go by ``dp_rank``
  (``shard_batch``, ``local_rows``), so the ranks of one tp group hold the
  same rows; the consumers gather what the global result needs over the dp
  group (``gather_rows``; ``train.contrastive``, ``api.PLIP``,
  ``data.wsi``, ``ops.retrieval``).
- tp, Megatron-style (``param_spec``, the counterpart of the JAX
  ``param_specs``): ``qkv`` and ``fc1`` by output columns, ``out`` and
  ``fc2`` by input rows (their biases replicated), ``text.token_embed`` by
  vocabulary rows (a ceil split: the last shard may be shorter); every other
  leaf replicated. The qkv columns are ``[q heads | k heads | v heads]``
  (``ops.attention``), so rank t holds the q, k and v columns of its own
  heads, in that order (``shard_tensor``), where the JAX package's
  ``P(None, None, "tp")`` cuts contiguous thirds that GSPMD gathers back for
  the kernels. ``shard_params`` slices a full model in place, hands its
  blocks and text tower the ``TPGroup`` they run their collectives on, and
  replicates every leaf from the first rank of its group
  (``replicate_params``); ``gather_params`` / ``gather_tree`` rebuild the
  full tree.

``tp`` must divide each tower's heads (and so its ``4 * width``): where it
does not, ``shard_params`` raises a ``ValueError`` naming the tower before
any weight moves (GSPMD pads such a split instead). A tp mesh needs its
process group: ``check_mesh`` refuses one without it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import distributed
from .distributed import TPGroup

NO_GROUP = ("a tensor-parallel mesh (tp > 1) needs a process group of dp*tp ranks: make "
            "it with create_mesh after distributed.initialize")

# (name suffix, split) of the tensor-parallel leaves: "qkv" by its heads'
# columns, "col" by output columns, "row" by input rows. The W8A8 leaves
# (ops.quant) follow their kernels; a row layer's wscale is replicated.
_SPLITS = (("attn.qkv.kernel", "qkv"), ("attn.qkv.bias", "qkv"),
           ("attn.qkv.kernel_q", "qkv"), ("attn.qkv.wscale", "qkv"),
           ("attn.out.kernel", "row"), ("attn.out.kernel_q", "row"),
           ("mlp.fc1.kernel", "col"), ("mlp.fc1.bias", "col"),
           ("mlp.fc1.kernel_q", "col"), ("mlp.fc1.wscale", "col"),
           ("mlp.fc2.kernel", "row"), ("mlp.fc2.kernel_q", "row"))
VOCAB_LEAF = "text.token_embed"


@dataclasses.dataclass
class Mesh:
    """``shape``: ``{"dp": ..., "tp": ...}``; ``group``: the process group
    of the whole mesh (None: the default group, or no group for one
    process); ``device``: where the group's collective buffers live;
    ``dp_group`` / ``tp_group``: the groups of this rank's dp and tp axes
    (None: the whole mesh's, where the other axis is 1)."""

    shape: Dict[str, int]
    group: Optional[object] = None
    device: torch.device = torch.device("cpu")
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None

    def __post_init__(self):
        if self.tp == 1 and self.dp_group is None:
            self.dp_group = self.group
        if self.dp == 1 and self.tp_group is None:
            self.tp_group = self.group

    @property
    def dp(self) -> int:
        return self.shape["dp"]

    @property
    def tp(self) -> int:
        return self.shape.get("tp", 1)

    @property
    def rank(self) -> int:
        """The global rank."""
        return distributed.rank()

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def create_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """A ``(dp, tp)`` mesh over the default group's processes (one without
    a group). ``dp`` defaults to processes // tp; ``dp * tp`` must equal the
    number of processes. Every rank must call it, in the same order as its
    other group-making calls."""
    n = distributed.world_size()
    if tp < 1 or (dp is not None and dp < 1):
        raise ValueError(f"mesh axes must be positive, got dp={dp}, tp={tp}")
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} processes")
    dp_group = tp_group = None
    if dp > 1 and tp > 1:  # new_group is collective: every rank makes every group
        r = distributed.rank()
        for d in range(dp):
            g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
            if d == r // tp:
                tp_group = g
        for t in range(tp):
            g = dist.new_group(list(range(t, n, tp)))
            if t == r % tp:
                dp_group = g
    return Mesh({"dp": dp, "tp": tp}, None, distributed.group_device(), dp_group, tp_group)


def check_mesh(mesh: Optional[Mesh], who: str) -> None:
    """Raise ``ValueError`` for a tp mesh without its process group: no
    group of ``dp * tp`` ranks, or (dp > 1) no dp and tp subgroups."""
    if mesh is None or mesh.tp == 1:
        return
    n = distributed.world_size()
    if (not dist.is_initialized() or n != mesh.dp * mesh.tp
            or (mesh.dp > 1 and (mesh.dp_group is None or mesh.tp_group is None))):
        raise ValueError(f"{who}: {NO_GROUP}; got mesh {mesh.shape} over {n} process(es)")


def tensor_parallel(mesh: Optional[Mesh]) -> Optional[TPGroup]:
    """The mesh's ``TPGroup`` for this rank (None without a mesh, or at tp 1)."""
    if mesh is None or mesh.tp == 1:
        return None
    return TPGroup(mesh.tp_group, mesh.tp, mesh.tp_rank)


# ---------------------------------------------------------------------------
# dp: rows
# ---------------------------------------------------------------------------


def local_rows(n: int, mesh: Mesh) -> Tuple[int, int, int]:
    """``(lo, hi, shard)``: this rank's rows ``[lo, hi)`` of ``n`` rows split
    in shards of ``ceil(n / dp)`` by ``dp_rank`` (the last dp ranks may hold
    fewer, or none)."""
    shard = -(-n // mesh.dp)
    lo = min(mesh.dp_rank * shard, n)
    return lo, min(lo + shard, n), shard


def gather_rows(x: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """The ``n``-row global result from each rank's ``local_rows`` part
    ``x``: padded to the shard, gathered over the dp group in dp order, the
    pad dropped. Every rank calls it and gets the same rows."""
    if mesh.dp == 1:
        return x[:n]
    shard = -(-n // mesh.dp)
    if x.shape[0] < shard:
        x = F.pad(x, (0, 0) * (x.dim() - 1) + (0, shard - x.shape[0]))
    return distributed.all_gather_rows(x, mesh.dp_group)[:n]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows (by ``dp_rank``) of a globally ordered batch (a
    tensor, an array, a list, or a tuple of them); the batch must divide
    over dp."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(b, mesh) for b in batch)
    n = len(batch)
    if n % mesh.dp:
        raise ValueError(f"batch of {n} rows does not divide over dp={mesh.dp}")
    per = n // mesh.dp
    return batch[mesh.dp_rank * per:(mesh.dp_rank + 1) * per]


# ---------------------------------------------------------------------------
# tp: the split of each leaf
# ---------------------------------------------------------------------------


def param_spec(name: str) -> Optional[str]:
    """How the leaf ``name`` (a ``CLIP`` state_dict key) splits over tp:
    ``"qkv"``, ``"col"``, ``"row"``, ``"vocab"``, or None (replicated)."""
    if name == VOCAB_LEAF:
        return "vocab"
    for suffix, split in _SPLITS:
        if name.endswith("." + suffix):
            return split
    return None


def vocab_shard(vocab: int, t: int, tp: int) -> Tuple[int, int]:
    """``[lo, hi)``: rank t's vocabulary rows, shards of ``ceil(vocab / tp)``."""
    per = -(-vocab // tp)
    lo = min(t * per, vocab)
    return lo, min(lo + per, vocab)


def shard_tensor(full: torch.Tensor, spec: Optional[str], t: int, tp: int) -> torch.Tensor:
    """Rank t's share of the full leaf (a new contiguous tensor): ``"qkv"``
    the q, k and v columns of its heads, ``"col"`` / ``"row"`` its chunk of
    the last / second-last axis, ``"vocab"`` its vocabulary rows; a
    replicated leaf (``spec`` None) is ``full`` itself."""
    if spec is None or tp == 1:
        return full
    if spec == "qkv":
        cols = full.shape[-1] // 3 // tp
        return full.unflatten(-1, (3, tp, cols))[..., t, :].flatten(-2).contiguous()
    if spec == "vocab":
        lo, hi = vocab_shard(full.shape[0], t, tp)
        return full[lo:hi].contiguous()
    dim = -1 if spec == "col" else -2
    size = full.shape[dim] // tp
    return full.narrow(dim, t * size, size).contiguous()


def gather_tensor(parts: List[torch.Tensor], spec: Optional[str]) -> torch.Tensor:
    """The full leaf from the ranks' shares in tp order: ``shard_tensor``'s
    inverse."""
    if spec is None or len(parts) == 1:
        return parts[0]
    if spec == "qkv":
        cols = parts[0].shape[-1] // 3
        return torch.stack([p.unflatten(-1, (3, cols)) for p in parts], -2).flatten(-3)
    return torch.cat(parts, {"col": -1, "row": -2, "vocab": 0}[spec])


def check_heads(cfg, tp: int) -> None:
    """Raise ``ValueError`` unless ``tp`` divides each tower's heads."""
    for name, tower in (("vision", cfg.vision), ("text", cfg.text)):
        if tower.heads % tp:
            raise ValueError(
                f"tp={tp} does not divide the {name} tower's {tower.heads} heads: the port "
                "shards whole heads (GSPMD would pad the split)")


def shard_tree(tree: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A full ``{name: tensor}`` tree (parameters, or their optimizer
    moments) -> this rank's shares."""
    return {k: shard_tensor(v, param_spec(k), mesh.tp_rank, mesh.tp) for k, v in tree.items()}


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def gather_tree(tree: Mapping[str, torch.Tensor], mesh: Optional[Mesh]
                ) -> Dict[str, torch.Tensor]:
    """The full tree from every rank's shares (``shard_tree``'s inverse), on
    every rank of the tp group: one all-gather a split leaf. Every rank
    calls it. Replicated leaves come back as they are."""
    if mesh is None or mesh.tp == 1:
        return dict(tree)
    out = {}
    for k, v in tree.items():
        spec = param_spec(k)
        if spec is None:
            out[k] = v
            continue
        v = v.detach().contiguous()
        if spec == "vocab":  # a ceil split: pad to the first shard's rows, then trim
            sizes = _all_gather(torch.tensor([v.shape[0]], device=v.device), mesh.tp_group)
            rows = [int(s) for s in sizes]
            parts = _all_gather(F.pad(v, (0, 0, 0, rows[0] - v.shape[0])), mesh.tp_group)
            parts = [p[:r] for p, r in zip(parts, rows)]
        else:
            parts = _all_gather(v, mesh.tp_group)
        out[k] = gather_tensor(parts, spec)
    return out


def gather_params(model: torch.nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The full state_dict of a ``shard_params`` model, on every rank (the
    one-process state_dict without a tp mesh). Every rank calls it."""
    return gather_tree(model.state_dict(), mesh)


@torch.no_grad()
def replicate_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every leaf of ``model`` (parameters and buffers) set, in place, to the
    first rank's of its group: over the dp group, and a replicated leaf also
    over the tp group. Without tp this is rank 0's everywhere."""
    for name, t in model.state_dict(keep_vars=True).items():
        if mesh.dp > 1:
            distributed.broadcast_(t.data, group=mesh.dp_group)
        if mesh.tp > 1 and param_spec(name) is None:
            distributed.broadcast_(t.data, group=mesh.tp_group)
    return model


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Place a full ``CLIP`` on the mesh, in place (the JAX ``shard_params``):
    under tp each split leaf becomes this rank's share and the blocks and the
    text tower get their ``TPGroup``; then ``replicate_params``. Raises
    before any weight moves where tp does not divide a tower's heads, or
    the mesh has no group (``check_mesh``)."""
    if mesh is None:
        return model
    check_heads(model.cfg, mesh.tp)
    check_mesh(mesh, "shard_params")
    tp = tensor_parallel(mesh)
    if tp is not None:
        for name, leaf in model.state_dict(keep_vars=True).items():
            spec = param_spec(name)
            if spec is not None:
                leaf.data = shard_tensor(leaf.data, spec, tp.rank, tp.size)
        for block in (*model.visual.blocks, *model.text.blocks):
            block.tp = tp
        model.text.tp = tp
        model.text.vocab_start = vocab_shard(model.cfg.text.vocab_size, tp.rank, tp.size)[0]
    return replicate_params(model, mesh)
