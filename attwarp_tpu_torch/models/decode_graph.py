"""The decode step replayed from CUDA graphs, and the pool of KV caches it
needs.

A decode step is ~30 kernels a decoder layer (~1,000 at LLaVA-1.5-7B's
32), most of them small; dispatching them from the host takes several
times the ~11 ms the card needs for them at the pipeline's widths.
``DecodeGraphs`` captures the step's work between its attention calls as
CUDA graphs, once per key, and replays them: one step
is then a copy of its inputs into static buffers, then for each segment a
replay, followed by the attention of the layer that ends it. That
attention runs eagerly (kernel K3 on an int8 cache, through
``models/llama.py::attend_cache``), so K3 keeps its Python entry and is
called once a layer a step, as in the eager step. The segments are
``models/llama.py::decode_segment``, the same functions the eager step
runs.

A graph holds the addresses of the tensors it was captured over: the
weights, the static inputs and the KV cache. ``KVPool`` therefore lends
caches: one owner at a time, zeroed on every lease, and a released cache
goes back to the pool with the graphs captured over it, so the next
generate call or serving engine of the same shape replays them instead of
capturing anew. A second owner of a shape while the first holds it gets
buffers of its own, and with them graphs of its own. A released cache is
kept only while some parameter tree whose graphs it carries is alive;
otherwise it is freed.

The graphs engage only where ``graphs_for`` finds all of: a CUDA tensor, a
tree with no ``"tp"`` shard (a tensor-parallel rank's collectives cannot be
captured) and a cache leased from the pool. Everything else (CPU tensors,
tensor-parallel ranks, callers that pass a cache of their own) runs the
same segments eagerly.

Counters (``utils/profiling.py``, while the recorder is on):
``decode_graph.captures`` (one per key captured), ``decode_graph.replays``
(one per replayed step) and ``decode_graph.eager`` (one per step run
eagerly, the step before a key's capture included); the span
``decode_graph.capture`` (``B``, ``S``) covers a capture.
"""

from __future__ import annotations

import operator
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from attwarp_tpu_torch.kernels.rope_append import rope_append_int8
from attwarp_tpu_torch.numerics.quant import int8_matmul
from attwarp_tpu_torch.utils import profiling

# Python launch counters that code inside a segment bumps: a capture runs
# that code once without launching anything, so the capture's increments
# are taken back and each replay adds them
REPLAYED_COUNTERS = ((int8_matmul, "launches"), (int8_matmul, "padded"),
                     (rope_append_int8, "launches"))


def tree_tensors(tree: Any, out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """Every tensor of a parameter tree, in a fixed order (~0.1 ms for a
    7B decoder's tree: it is walked every step)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            tree_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tree_tensors(v, out)
    return out


class DecodeGraphs:
    """The CUDA graphs of one key: the parameter tree (held by weak
    references, so the graphs never keep a tree alive), the cache they were
    captured over, the extract spec and the dtype. The first step of a key
    runs eagerly and ``capture`` follows it; every later step ``replay``s."""

    def __init__(self, leaves: List[torch.Tensor]):
        self.refs = tuple(weakref.ref(t) for t in leaves)
        self.graphs: Tuple[torch.cuda.CUDAGraph, ...] = ()

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)

    def holds(self, leaves: List[torch.Tensor]) -> bool:
        """Whether the tree still has the tensors the graphs read."""
        return (len(leaves) == len(self.refs)
                and all(map(operator.is_, (r() for r in self.refs), leaves)))

    def capture(self, segment: Callable, attend: Callable, ends: Tuple[int, ...],
                token_embeds, cos, sin, kv_mask, attn_width: int) -> None:
        """Capture one graph per segment over static copies of the step's
        inputs, all in one memory pool, and keep every tensor a graph reads
        or writes alive with the graphs (their addresses are in them).
        ``segment(lo, hi, x, attn, pos, cos, sin, kv_mask)`` runs the work
        from after layer ``lo``'s attention to layer ``hi``'s (``lo`` -1:
        from the embeddings, ``hi`` the layer count: to the logits) and
        returns (x, q or logits, rows); ``attend(layer, q, kv_mask, out)``
        is layer ``layer``'s attention into ``out``. Nothing runs on the
        card here."""
        dev = token_embeds.device
        B = token_embeds.shape[0]
        self.attend = attend
        self.ends = ends
        self.x = torch.empty_like(token_embeds)
        self.cos, self.sin = torch.empty_like(cos), torch.empty_like(sin)
        self.mask = torch.empty_like(kv_mask)
        self.pos = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.attn = torch.zeros((B, 1, attn_width), dtype=token_embeds.dtype, device=dev)
        before = [getattr(obj, name) for obj, name in REPLAYED_COUNTERS]
        pool = torch.cuda.graph_pool_handle()
        graphs, outs = [], []
        with profiling.span("decode_graph.capture", B=B, S=kv_mask.shape[1]), \
                torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                x, lo = self.x, -1
                for hi in ends:
                    g = torch.cuda.CUDAGraph()
                    g.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        x, out, rows = segment(lo, hi, x, self.attn, self.pos, self.cos,
                                               self.sin, self.mask)
                    finally:
                        g.capture_end()
                    graphs.append(g)
                    outs.append((x, out, rows))
                    lo = hi
            torch.cuda.current_stream().wait_stream(side)
        self.deltas = []
        for (obj, name), n in zip(REPLAYED_COUNTERS, before):
            self.deltas.append(getattr(obj, name) - n)
            setattr(obj, name, n)
        self.graphs, self.outs = tuple(graphs), outs
        profiling.count("decode_graph.captures")

    def replay(self, token_embeds, cur_len, cos, sin, kv_mask):
        """One step: the inputs copied in (``cur_len``, an int or a (B,)
        tensor, by a fill or a copy on the card), each segment replayed
        and the attention that ends it run eagerly. Returns (logits, {layer:
        row}), copies that the next step does not overwrite."""
        with torch.cuda.device(self.x.device):
            self.x.copy_(token_embeds)
            self.cos.copy_(cos)
            self.sin.copy_(sin)
            # an eager copy: the mask's version moves every step, as the
            # caller's own mask's does
            self.mask.copy_(kv_mask)
            if isinstance(cur_len, int):
                self.pos.fill_(cur_len)
            else:
                self.pos.copy_(cur_len)
            rows: Dict[int, torch.Tensor] = {}
            last = len(self.graphs) - 1
            for k, (g, hi, (_, out, r)) in enumerate(zip(self.graphs, self.ends, self.outs)):
                g.replay()
                rows.update(r)
                if k < last:
                    self.attend(hi, out, self.mask, self.attn)
            logits = self.outs[last][1].clone()
            rows = {i: row.clone() for i, row in rows.items()}
        for (obj, name), n in zip(REPLAYED_COUNTERS, self.deltas):
            setattr(obj, name, getattr(obj, name) + n)
        profiling.count("decode_graph.replays")
        return logits, rows


class _Entry:
    """One cache of the pool, with the graphs captured over it by key."""

    __slots__ = ("key", "cache", "graphs")

    def __init__(self, key: tuple, cache):
        self.key = key
        self.cache = cache
        self.graphs: Dict[tuple, DecodeGraphs] = {}

    def prune(self) -> bool:
        """Drop the graphs of trees that are gone; whether any are left."""
        for k in [k for k, g in self.graphs.items() if not g.alive()]:
            del self.graphs[k]
        return bool(self.graphs)


class KVPool:
    """KV caches lent one owner at a time, by key (the cache's kind and
    shape, dtype and device)."""

    def __init__(self):
        self._free: Dict[tuple, List[_Entry]] = {}
        self._leased: Dict[int, _Entry] = {}   # id of the cache's first tensor

    def lease(self, key: tuple, make: Callable):
        """A cache for ``key``: a released one zeroed, or ``make()``'s (a
        zeroed new cache)."""
        self._prune()
        free = self._free.get(key)
        if free:
            entry = free.pop()
            for t in entry.cache:
                t.zero_()
        else:
            entry = _Entry(key, make())
        self._leased[id(entry.cache[0])] = entry
        return entry.cache

    def release(self, cache) -> None:
        """Take ``cache`` back; it is kept for the next owner of its key
        while it carries the graphs of a live tree."""
        entry = self.entry(cache)
        if entry is None:
            return
        del self._leased[id(cache[0])]
        if entry.prune():
            self._free.setdefault(entry.key, []).append(entry)

    def entry(self, cache) -> Optional[_Entry]:
        """The pool's record of a leased ``cache``, or None where it was not
        lent by the pool."""
        entry = self._leased.get(id(cache[0]))
        return entry if entry is not None and entry.cache[0] is cache[0] else None

    def _prune(self) -> None:
        for key in list(self._free):
            kept = [e for e in self._free[key] if e.prune()]
            if kept:
                self._free[key] = kept
            else:
                del self._free[key]


KV_POOL = KVPool()


def graphs_for(params: Dict[str, Any], kv, x: torch.Tensor, spec: tuple
               ) -> Optional[DecodeGraphs]:
    """The graphs of a decode step of ``params`` over ``kv``, keyed by the
    tree and ``spec`` (what else fixes the step: config, extract layers,
    dtype); new ones where the key has none or its tree changed. None where
    the step runs eagerly: a CPU tensor, a tensor-parallel tree, or a cache
    the pool did not lend."""
    if not x.is_cuda or "tp" in params:
        return None
    entry = KV_POOL.entry(kv)
    if entry is None:
        return None
    key = (id(params), spec)
    leaves = tree_tensors(params)
    g = entry.graphs.get(key)
    if g is None or not g.holds(leaves):
        g = entry.graphs[key] = DecodeGraphs(leaves)
    return g
