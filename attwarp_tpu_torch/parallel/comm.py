"""The port's collectives: every exchange between ranks goes through here.

JAX's parallel layer names shardings and lets XLA's SPMD partitioner insert
the collectives. PyTorch has no partitioner that reaches the port's kernels
or its dict-of-tensors models, so the port places them by hand, Megatron
style, one process per device; this module is the one place that calls
``torch.distributed``.

``Group`` is one mesh axis as a rank sees it: its process group (None when
the axis holds one rank, and then every collective is the identity), the
rank's index on it and its size.

- ``all_reduce`` (sum or max, in place), ``all_gather`` (concatenated
  along a dim) and ``ring_shift`` (each rank sends to the next on the axis
  and receives from the previous, ``batch_isend_irecv``: JAX's
  ``ppermute``).
- ``copy_to_group`` and ``gather_from_group``: the two autograd functions
  of a column-parallel layer whose next layer needs full channels. The
  first is the identity forward and sums the input's gradient over the
  group backward; the second gathers forward and keeps the rank's own
  slice backward. (``torch.distributed.nn.functional.all_gather`` sums the
  gradient slices backward, which counts a loss computed alike on every
  rank ``size`` times.)

gloo, the CPU backend, takes only ``broadcast`` and ``all_reduce`` on CUDA
tensors. Where the group's backend is gloo and the tensor is on the card,
``all_gather`` and ``ring_shift`` therefore copy it to the host, exchange
and copy back: ``host_staged`` counts those calls. That is how several
ranks share one card (NCCL refuses two ranks on one GPU); the compute
stays on the card. Under NCCL every collective is direct.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """One mesh axis as this rank sees it."""

    pg: Any                 # torch.distributed ProcessGroup, None for one rank
    rank: int               # this rank's index on the axis
    size: int
    ranks: Tuple[int, ...]  # the axis's global ranks, in axis order

    @property
    def staged(self) -> bool:
        """Collectives other than all_reduce go through the host for CUDA
        tensors (gloo)."""
        return self.pg is not None and dist.get_backend(self.pg) == "gloo"


SOLO = Group(None, 0, 1, (0,))


def host_staged() -> int:
    return host_staged.calls


host_staged.calls = 0


def _staged(x: torch.Tensor, group: Group) -> bool:
    if group.staged and x.device.type == "cuda":
        host_staged.calls += 1
        return True
    return False


def all_reduce(x: torch.Tensor, group: Optional[Group], op: str = "sum") -> torch.Tensor:
    """Sum (or max, ``op="max"``) of ``x`` over the group, in place;
    returns ``x``. The identity for no group or a group of one."""
    if group is None or group.size == 1:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group.pg)
    return x


def all_gather(x: torch.Tensor, group: Optional[Group], dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along ``dim`` in
    axis order."""
    if group is None or group.size == 1:
        return x
    staged = _staged(x, group)
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def ring_shift(tensors: Sequence[torch.Tensor], group: Group) -> Tuple[torch.Tensor, ...]:
    """Each rank sends ``tensors`` to the next rank on the axis and gets the
    previous rank's: JAX's ``ppermute`` with ``perm = [(i, (i + 1) % n)]``."""
    if group.size == 1:
        return tuple(tensors)
    dev = tensors[0].device
    staged = _staged(tensors[0], group)
    send = [(t.cpu() if staged else t).contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    nxt = group.ranks[(group.rank + 1) % group.size]
    prv = group.ranks[(group.rank - 1) % group.size]
    ops = ([dist.P2POp(dist.isend, t, nxt, group.pg) for t in send]
           + [dist.P2POp(dist.irecv, t, prv, group.pg) for t in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(t.to(dev) for t in recv) if staged else tuple(recv)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        own = grad.narrow(ctx.dim, ctx.group.rank * ctx.width, ctx.width)
        return own.contiguous(), None, None


def copy_to_group(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward (the
    input of a column-parallel layer)."""
    if group is None or group.size == 1 or not x.requires_grad:
        return x
    return _CopyToGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group: Optional[Group], dim: int) -> torch.Tensor:
    """``all_gather`` forward; the rank's own slice of the gradient
    backward (the output of a column-parallel layer)."""
    if group is None or group.size == 1:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return all_gather(x, group, dim)
    return _GatherFromGroup.apply(x, group, dim)


@dataclass(frozen=True)
class ModelShard:
    """How a model's parameter tree is split over the ``model`` axis; a
    sharded tree carries it under ``"tp"`` (at the tower or decoder level
    and in every layer), and the model code places its collectives by it.
    A tree without ``"tp"`` runs unsharded: no collective at all."""

    group: Group
    kv_heads: int = 0    # a decoder rank's kv heads (the ones its heads read)
    attn: bool = False   # heads split: the attention's output projection all-reduces
    mlp: bool = False    # FFN split: its second linear all-reduces
    vocab: bool = False  # embedding and LM head split by vocabulary rows
    patch: bool = False  # the patch embedding's output channels split


def split_group(tree, part: str) -> Optional[Group]:
    """The group over which ``part`` ("attn", "mlp", "vocab" or "patch") of
    ``tree`` is split, or None where it is whole."""
    shard = tree.get("tp") if isinstance(tree, dict) else None
    if shard is None or not getattr(shard, part):
        return None
    return shard.group
