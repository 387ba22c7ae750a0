"""The dynamic-capacity mixture of experts of Uni-MoE-2.0-Omni's decoder
(HF ``grin_qwen2_vl``): a float32 router over the routed experts and the
null experts, Top-P routing cut at ``top_k`` entries, and shared experts
run on every token.

For one row ``u`` (the post-attention RMSNorm's output, width D):

- ``p = softmax(W_r u)`` in float32; ``W_r`` is (routed + null, D), the
  routed entries first, then the null ones;
- R(u): ``p`` sorted in descending order (ties to the lower index), the
  shortest prefix whose cumulative sum reaches ``top_p``, cut to at most
  ``top_k`` entries, with the null entries dropped from it (a null expert
  outputs zero);
- ``FFN(u) = sum_s S_s(u) + sum_{e in R(u)} p_e E_e(u)``, each expert
  ``down(silu(gate u) * up u)``. The weights are the raw probabilities
  (not renormalised over R(u)) and the shared experts are summed without a
  gate.

Two forms compute the same sum, in float32 over bfloat16 expert outputs:

- grouped (prefill): each routed expert runs on the rows that chose it,
  gathered into one GEMM, scaled and added back, so no work is spent on a
  pair the routing did not choose. The experts' row counts are read on the
  host once a layer, copied while the shared experts run.
- static (decode): every routed expert on every row, scaled by its weight
  where chosen and by 0 elsewhere. The shapes are static and nothing is
  read on the host, so a decode step can be captured as a CUDA graph. At
  the decode batches of the two-pass pipeline (B=8 over 4 experts) some
  row chooses every expert, so each expert's weights are streamed once in
  either form.

A layer's ``"moe"`` tree: ``router`` (routed + null, D) float32;
``gate_up`` (routed, 2F, D), each routed expert's gate rows then its up
rows; ``down`` (routed, D, F); ``shared_gate_up`` (shared, 2Fs, D) and
``shared_down`` (shared, D, Fs); and, set by ``MoETally.attach``,
``tally`` (the layer's row of the tally) and ``layer`` (its index).

``MoETally`` counts, on the device and in place, the routed pairs by
(layer, expert), the pairs whose prefix held a null expert and the rows
through each layer, over the rows that are tokens (a prompt's padding is
not). It never reads the device: ``utils/profiling.py``'s recorder reads
it once when ``tracing`` closes, as the counters ``moe.routed_pairs``,
``moe.null_pairs`` and ``moe.rows``. Asked to (``log_routing``), it also
keeps each token row's chosen experts, in a ring on the device, so that a
check can hold a reference to the sets the program chose.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from attwarp_tpu_torch.utils import profiling


@dataclass(frozen=True)
class MoEConfig:
    routed: int = 4                 # mlp_dynamic_expert_num
    null: int = 1                   # mlp_dynamic_null_expert_num
    shared: int = 2                 # mlp_fixed_expert_num
    routed_width: int = 18944       # dynamic_intermediate_size
    shared_width: int = 2368        # shared_intermediate_size
    top_p: float = 0.7              # mlp_dynamic_top_p
    top_k: int = 2                  # mlp_dynamic_top_k, read as a cap


def refuse_experts(tree: Dict[str, Any], path: str) -> None:
    """A clear error where ``path`` meets a decoder tree with experts."""
    if any("moe" in lp for lp in tree.get("layers", ())):
        raise ValueError(f"{path} does not take a decoder with routed experts "
                         f"(models/moe.py); it runs dense decoders only")


def route(u: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Rows ``u`` (N, D) -> (chosen (N, routed) bool, their weights (N,
    routed) float32, 0 where not chosen, and (N,) whether the prefix held
    a null expert), by the rule of the module's docstring."""
    p = torch.softmax(F.linear(u.to(torch.float32), router.to(torch.float32)), dim=-1)
    ps, order = torch.sort(p, dim=-1, descending=True, stable=True)
    before = F.pad(torch.cumsum(ps, dim=-1)[:, :-1], (1, 0))   # the sum ahead of each entry
    rank = torch.arange(p.shape[-1], device=p.device)
    keep = torch.zeros_like(p, dtype=torch.bool).scatter_(
        -1, order, (before < cfg.top_p) & (rank < cfg.top_k))
    chosen = keep[:, :cfg.routed]
    return chosen, torch.where(chosen, p[:, :cfg.routed], 0.0), keep[:, cfg.routed:].any(-1)


def _swiglu(h: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """``down(silu(gate h) * up h)`` of rows h (n, D) through one expert."""
    g, up = F.linear(h, gate_up).chunk(2, dim=-1)
    return F.linear(F.silu(g) * up, down)


def _stacked(h: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """Every expert of a stack on every row: (n, D) -> (experts, n, D)."""
    g, up = torch.matmul(h, gate_up.transpose(1, 2)).chunk(2, dim=-1)
    return torch.matmul(F.silu(g) * up, down.transpose(1, 2))


def _grouped(m: Dict[str, Any], u: torch.Tensor, chosen: torch.Tensor, w: torch.Tensor,
             counts: Sequence[int]) -> torch.Tensor:
    """The routed sum, each expert over the ``counts[e]`` rows that chose
    it (f32)."""
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    # each expert's rows first, in row order
    order = torch.argsort(chosen.t().to(torch.uint8), dim=1, descending=True, stable=True)
    for e, n in enumerate(counts):
        if n:
            rows = order[e, :n]
            y = _swiglu(u[rows], m["gate_up"][e], m["down"][e])
            out.index_add_(0, rows, y.to(torch.float32) * w[rows, e, None])
    return out


def moe_ffn(m: Dict[str, Any], cfg: MoEConfig, h: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FFN of normed rows ``h`` (..., D), in ``h``'s dtype. ``valid``
    (h's leading shape, bool) marks the rows that are tokens (a prefill's
    attention mask): the grouped form runs over those alone, the others
    take the shared experts only. Without it every row is a token and the
    static form runs (a decode step)."""
    shape = h.shape
    u = h.reshape(-1, shape[-1])
    with profiling.span("moe", layer=m.get("layer"), rows=u.shape[0]):
        chosen, w, null = route(u, m["router"], cfg)
        if valid is not None:
            v = valid.reshape(-1, 1)
            chosen, w, null = chosen & v, w * v, null & v[:, 0]
            # the layer's one read on the host: the experts' row counts, copied
            # while the shared experts run, so that the card has work meanwhile
            counts = chosen.sum(0).to("cpu", non_blocking=True)
            copied = torch.cuda.Event() if u.is_cuda else None
            if copied is not None:
                copied.record()
        else:
            y = _stacked(u, m["gate_up"], m["down"])
            routed = (y.to(torch.float32) * w.t()[:, :, None]).sum(0)
        shared = _stacked(u, m["shared_gate_up"], m["shared_down"]).to(torch.float32).sum(0)
        if valid is not None:
            if copied is not None:
                copied.synchronize()
            routed = _grouped(m, u, chosen, w, counts.tolist())
        tally = m.get("tally")
        if tally is not None:
            rows = torch.ones_like(null) if valid is None else valid.reshape(-1)
            log = m.get("log")
            if log is not None:   # each token row at its place in the layer's count
                ring = log.shape[0] - 1
                at = torch.where(rows, (tally[-1] + torch.cumsum(rows, 0) - 1) % ring, ring)
                log.index_copy_(0, at, chosen)
            tally.add_(torch.cat([chosen.sum(0), null.sum()[None], rows.sum()[None]]))
        return (routed + shared).to(h.dtype).reshape(shape)


class MoETally:
    """Routed pairs by (layer, expert), null pairs and rows by layer: an
    int64 (layers, routed + 2) tensor on the device, updated in place by
    every ``moe_ffn`` of the layers it is attached to (so also inside
    replayed decode graphs)."""

    def __init__(self, layers: int, cfg: MoEConfig, device):
        self.routed = cfg.routed
        self.counts = torch.zeros((layers, cfg.routed + 2), dtype=torch.int64, device=device)
        self.log: Optional[torch.Tensor] = None
        self._layers: Sequence[Dict[str, Any]] = ()

    def attach(self, layers: Sequence[Dict[str, Any]]) -> "MoETally":
        """Give each expert layer of a decoder its row of the tally, and
        let the recorder of ``utils/profiling.py`` read it."""
        for i, lp in enumerate(layers):
            lp["moe"]["tally"] = self.counts[i]
            lp["moe"]["layer"] = i
        self._layers = layers
        profiling.watch(self)
        return self

    def log_routing(self, rows: int) -> None:
        """Keep each token row's chosen experts as well, a layer's rows in
        a ring of ``rows`` (``log``, (layers, rows + 1, routed) bool; the
        last row takes a prefill's padding), each at its place in the
        layer's count of rows: the row counted as the n-th sits at n mod
        ``rows``. Call it before a decode step is captured, so that the
        graphs write the ring too."""
        self.log = torch.zeros((self.counts.shape[0], rows + 1, self.routed), dtype=torch.bool,
                               device=self.counts.device)
        for lp, ring in zip(self._layers, self.log):
            lp["moe"]["log"] = ring

    def routes(self, start: int, stop: int) -> torch.Tensor:
        """The chosen experts of the rows counted from ``start`` to
        ``stop`` (counts of ``rows``, as two snapshots give them): (layers,
        stop - start, routed) bool. Rows the ring has written over since
        are refused."""
        ring = self.log.shape[1] - 1
        now = int(self.counts[0, -1])
        if now - start > ring:
            raise ValueError(f"rows {start}..{stop} are gone from the routing log "
                             f"({ring} rows, {now} counted)")
        return self.log[:, torch.arange(start, stop, device=self.log.device) % ring]

    def snapshot(self) -> torch.Tensor:
        """A device copy of the counts (no read on the host)."""
        return self.counts.clone()

    def counters(self, since: Optional[torch.Tensor] = None) -> Dict[str, int]:
        """The totals gained since the snapshot ``since`` (all of them
        where None), read on the host."""
        return self.totals(self.counts if since is None else self.counts - since)

    def totals(self, counts: torch.Tensor) -> Dict[str, int]:
        """Named totals of counts in the tally's layout (a difference of two
        snapshots, say), read on the host."""
        d = counts.sum(0).tolist()
        return {"moe.routed_pairs": sum(d[:self.routed]), "moe.null_pairs": d[self.routed],
                "moe.rows": d[self.routed + 1]}
