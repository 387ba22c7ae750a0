"""Meshes of ranks and the MarginalNet sharding rules (counterpart of
``attwarp_tpu/parallel/mesh.py``).

One process per device. ``make_mesh(n_data, n_model)`` lays the
``torch.distributed`` world out as JAX lays its devices out, rank ``r`` at
row ``r // n_model`` and column ``r % n_model`` of a ``(data, model)``
grid, with one process group per row (the ``model`` axis: tensor
parallelism) and one per column (the ``data`` axis: data parallelism).
The backend is explicit: ``nccl`` for one GPU per rank, ``gloo`` for CPU
ranks or for several ranks sharing one GPU (``parallel/comm.py``). With no
process group initialized the mesh is the one-rank ``(1, 1)`` grid.

A sharded tensor is held as its rank's slice (no global view exists):

- ``shard_batch`` returns the rank's slice of the leading (batch) axis on
  ``data``;
- ``param_sharding_rules`` keeps JAX's rule on the flax layout, the last
  axis of a kernel of two or more axes on ``model`` when it is at least
  128 wide. A torch weight is ``(out, in, ...)``, so the rule reads and
  shards dim 0; the spec returned is the flax kernel's, as JAX's;
- ``shard_params`` turns every such layer of a MarginalNet into a
  column-parallel layer over ``model`` (``ColumnParallel``);
- ``param_shardings``/``batch_shardings``/``replicated`` give the specs
  (tuples of axis names or None: JAX's ``PartitionSpec``) of a tree.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from attwarp_tpu_torch.parallel.comm import (
    SOLO,
    Group,
    all_gather,
    copy_to_group,
    gather_from_group,
)

# a rank that dies leaves the others inside a collective: they give up after this
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def init_ranks(backend: str, rank: Optional[int] = None, world_size: Optional[int] = None,
               init_method: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` with the collectives'
    timeout: from ``torchrun``'s environment by default, or from an explicit
    ``rank``, ``world_size`` and ``init_method`` (e.g.
    ``tcp://localhost:29500`` or ``file:///tmp/rdv``)."""
    kw = {} if rank is None else {"rank": rank, "world_size": world_size}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=COLLECTIVE_TIMEOUT, **kw)


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of ranks as this rank sees it."""

    data: Group
    model: Group
    backend: Optional[str]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data.size, "model": self.model.size}

    def axis(self, name: str) -> Group:
        return {"data": self.data, "model": self.model}[name]


_current: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    """The mesh ``make_mesh`` built last in this process, or None."""
    return _current


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """A 2-D ``(data, model)`` mesh over the whole initialized world (every
    rank calls it, in the same order)."""
    global _current
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} devices")
    if world == 1:
        _current = Mesh(SOLO, SOLO, None)
        return _current
    me = dist.get_rank()
    backend = dist.get_backend()
    rows = [tuple(d * n_model + m for m in range(n_model)) for d in range(n_data)]
    cols = [tuple(d * n_model + m for d in range(n_data)) for m in range(n_model)]

    def groups(lines):
        # every rank creates every group, in the same order
        mine = None
        for line in lines:
            pg = dist.new_group(list(line), timeout=COLLECTIVE_TIMEOUT) if len(line) > 1 else None
            if me in line:
                mine = Group(pg, line.index(me), len(line), line)
        return mine

    model = groups(rows)
    data = groups(cols)
    _current = Mesh(data, model, backend)
    return _current


def _slice(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * n, n)


def shard_batch(tree, mesh: Mesh):
    """The rank's slice of every tensor's leading (batch) axis over
    ``data`` (a 0-d tensor, a string list or a non-tensor passes whole)."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.ndim >= 1:
        if tree.shape[0] % mesh.data.size:
            raise ValueError(f"shard_batch: batch {tree.shape[0]} not divisible by "
                             f"data={mesh.data.size}")
        return _slice(tree, mesh.data).contiguous()
    return tree


def param_sharding_rules(path: str, shape) -> tuple:
    """JAX's tensor-parallel rule for a MarginalNet parameter, on the torch
    shape ``(out, in, ...)``: a kernel of two or more axes whose output
    channels number at least 128 goes on ``model`` (the flax kernel's last
    axis, which the returned spec names), anything else is replicated."""
    if len(shape) >= 2 and shape[0] >= 128:
        return (None,) * (len(shape) - 1) + ("model",)
    return (None,) * len(shape)


def _spec(name: str, shape, mesh: Mesh) -> tuple:
    spec = param_sharding_rules(name, shape)
    # only shard if the axis divides evenly over the model dimension
    if "model" in spec and shape[0] % mesh.model.size:
        return (None,) * len(shape)
    return spec


def param_shardings(params: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, tuple]:
    """The spec of every entry of a state dict (divisibility applied)."""
    return {k: _spec(k, tuple(v.shape), mesh) for k, v in params.items()}


def batch_shardings(tree, mesh: Mesh):
    def one(x):
        return ("data",) + (None,) * (x.ndim - 1) if x.ndim >= 1 else ()

    if isinstance(tree, dict):
        return {k: batch_shardings(v, mesh) for k, v in tree.items()}
    return one(tree)


def replicated(mesh: Mesh) -> tuple:
    return ()


class ColumnParallel(nn.Module):
    """A Linear/Conv1d/Conv2d whose output channels are split over a group:
    the weight is the rank's slice of dim 0, the bias stays whole
    (replicated, as JAX's rule leaves 1-D parameters). Forward: the input
    enters with ``copy_to_group``, the rank's channels are computed, all
    channels gathered (``gather_from_group``) and the bias added, so that
    the next layer reads full channels and the bias's gradient is whole on
    every rank."""

    def __init__(self, layer: nn.Module, group: Group):
        super().__init__()
        self.group = group
        self.kind = type(layer).__name__
        self.conv = {k: getattr(layer, k) for k in ("stride", "padding", "dilation", "groups")
                     if hasattr(layer, k)}
        self.weight = nn.Parameter(_slice(layer.weight.detach(), group).clone())
        self.bias = nn.Parameter(layer.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_group(x, self.group)
        if self.kind == "Linear":
            y = gather_from_group(F.linear(x, self.weight), self.group, -1)
            return y + self.bias.to(y.dtype)
        conv = F.conv2d if self.kind == "Conv2d" else F.conv1d
        y = gather_from_group(conv(x, self.weight, None, **self.conv), self.group, 1)
        return y + self.bias.to(y.dtype).reshape(-1, *([1] * (y.ndim - 2)))


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Apply ``param_sharding_rules`` to a MarginalNet in place: every child
    layer whose weight the rule puts on ``model`` (and whose output
    channels divide over it) becomes a ``ColumnParallel``. Returns the
    model; ``sharded_names`` lists the parameters held as slices."""
    names = []
    if mesh.model.size > 1:
        for name, layer in list(model.named_children()):
            w = getattr(layer, "weight", None)
            if w is not None and "model" in _spec(name, tuple(w.shape), mesh):
                setattr(model, name, ColumnParallel(layer, mesh.model))
                names.append(f"{name}.weight")
    model.sharded_names = frozenset(names)
    return model


def gather_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The full (unsharded) state dict of a model ``shard_params`` split:
    each sharded weight gathered over ``model`` along dim 0."""
    out = {}
    for k, v in model.state_dict().items():
        if k in getattr(model, "sharded_names", ()):
            v = all_gather(v.detach(), mesh.model, 0)
        out[k] = v.detach()
    return out
