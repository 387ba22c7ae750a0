"""Chunked-prefill co-scheduling (counterpart of
``attwarp_tpu/serving/chunked.py``): an admitting prompt rides the decode
steps in P-token chunks instead of a dedicated prefill.

Each decode step carries one chunk of one admitting prompt through the
same projections and MLP as the decode rows: their hidden states are
concatenated to (B + P, D), so the weights are read once for both. A
640-token prompt admits in ceil(640 / P) steps.

Numerics are those of the monolithic admission (``ServeEngine``):

- the chunk's attention reads a **staging buffer** that holds the prompt's
  exact K/V so far (never the int8 cache): query position g sees exactly the
  keys [pad, g], as in the one-shot prefill;
- each chunk's K/V is **written through** to the slot cache after the layer
  loop (quantized per (token, head) with ``kv_quant``, the scales the
  one-shot prefill would give), so when the last chunk lands the slot holds
  what ``_prefill_group`` would have inserted;
- the first generated token is the argmax over the prompt's last row.

Which rows write is explicit. The decode rows of slots that are free or
mid-admission write nothing: the step writes only the active slots' rows
(one advanced-index write per cache tensor), and every row's positions are
in bounds. (JAX parks those rows at ``cur_len = max_seq`` and relies on
XLA dropping the out-of-bounds scatter; it also keeps a sink slot and a
scratch staging region for steps without a chunk. None of that is ported:
a step without an admitting chunk runs the decode rows alone, a step
without decoding slots the chunk alone, and a prompt's last chunk is cut at
its bucket's end.)

Scheduling (host side): admissions are FIFO; one chunk per step; a
prompt's chunks are contiguous, so the single staging buffer is reused only
after the previous prompt's last chunk.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from attwarp_tpu_torch.models.llama import (
    QuantKVCache,
    _attn,
    append_token,
    apply_rope,
    attend_cache,
    embed,
    final_logits,
    layer_project,
    layer_residuals,
    local_kv_heads,
)
from attwarp_tpu_torch.numerics.quant import quantize_kv
from attwarp_tpu_torch.serving.engine import Request, ServeEngine, sample_tokens
from attwarp_tpu_torch.utils import profiling


@dataclass
class _Admission:
    slot: int
    req: Request
    Tb: int                # bucketed prompt length
    pad: int               # left pad inside the bucket
    embeds: torch.Tensor   # (Tb, D) prompt embeddings
    cos: torch.Tensor      # (Tb, hd) rotary tables of the prompt positions
    sin: torch.Tensor
    next_dst: int = 0      # next chunk offset


def chunk_mask(dst: int, n: int, pad: int, device) -> torch.Tensor:
    """(1, n, dst + n) mask of chunk rows [dst, dst + n) over [staging
    history | fresh chunk]: history keys are the prompt's positions
    [pad, dst), fresh keys are causal within the chunk and not padding.
    Together: the one-shot prefill's row [pad, g] for query g."""
    k = torch.arange(dst + n, device=device)[None, :]
    g = torch.arange(dst, dst + n, device=device)[:, None]
    return ((k >= pad) & (k <= g))[None]


class ChunkedPrefillEngine(ServeEngine):
    """``ServeEngine`` whose admission prefill rides the decode ticks in
    P-token chunks. Same request semantics and the same greedy tokens as
    the base engine, for both families and both cache types.

    >>> eng = ChunkedPrefillEngine(model, slots=16, max_seq=768,
    ...                            kv_quant=True, prefill_chunk=128)
    """

    def __init__(self, model, slots: int = 8, prefill_chunk: int = 128, **kw):
        super().__init__(model, slots=slots, **kw)
        self.P = prefill_chunk
        # the admitting prompt's exact K/V, any bucket ``submit`` accepts
        t = self.tcfg
        shape = (t.num_hidden_layers, self.max_seq, local_kv_heads(self.text_params, t),
                 t.head_dim)
        dt = self.text_params["embed_tokens"].dtype
        self.stage_k = torch.zeros(shape, dtype=dt, device=self.device)
        self.stage_v = torch.zeros(shape, dtype=dt, device=self.device)
        self._admitting: deque = deque()   # _Admission FIFO, chunks left

    def run(self) -> Dict[int, List[int]]:
        while (self.queue or self._admitting
               or any(s.active or s.pending for s in self._slots)):
            self._start_admissions()
            self._tick_fused()
        return self.results

    # ── internals ──────────────────────────────────────────────────────
    def _start_admissions(self):
        """Assign queued requests to free slots and embed their prompts
        (vision tower included); the ticks carry their chunks. A failed
        embedding puts the request back at the head of the queue. Logs one
        admission wave per call that admits."""
        t0 = time.perf_counter()
        free = [b for b, s in enumerate(self._slots) if not (s.active or s.pending)]
        if not (free and self.queue):
            return
        with profiling.span("serve.admit"):
            n = 0
            for b in free[:len(self.queue)]:
                req = self.queue.popleft()
                self._admitted(req)
                Tb = -(-len(req.input_ids) // self.bucket) * self.bucket
                try:
                    embeds, _, cos, sin = self._embed_group(
                        Tb, req.pixel_values is not None, [(b, req)])
                except Exception:
                    self.queue.appendleft(req)
                    raise
                self._slots[b].pending = True
                self._slots[b].rid = req.rid
                self._admitting.append(_Admission(b, req, Tb, Tb - len(req.input_ids),
                                                  embeds[0], cos[0], sin[0]))
                n += 1
            if n:
                self.admit_log.append((t0, time.perf_counter(), n))

    def _next_chunk(self):
        """The next (admission, dst, n) in FIFO order, or None."""
        if not self._admitting:
            return None
        a = self._admitting[0]
        dst = a.next_dst
        n = min(self.P, a.Tb - dst)
        a.next_dst += n
        if a.next_dst == a.Tb:
            self._admitting.popleft()
        return a, dst, n

    def _fused_step(self, tokens, cur, starts, offsets, rows, chunk):
        """One decode step of every slot (when ``rows``, the active slots,
        is given) and one prompt chunk (when ``chunk`` is given), sharing
        the projections and MLP. Returns (decode logits (B, vocab) or None,
        the first-token logits (vocab,) when the chunk completes its
        prompt, else None)."""
        p, t = self.text_params, self.tcfg
        hd = t.head_dim
        B = 0 if rows is None else tokens.shape[0]
        parts = []
        if B:
            cos, sin = self.model.decode_rope(cur + offsets)
            mask = self._slot_mask(cur, starts)
            at = (rows, cur[rows])
            parts.append(embed(p, tokens))
        if chunk is not None:
            a, dst, n = chunk
            ccos, csin = a.cos[None, dst:dst + n], a.sin[None, dst:dst + n]
            cmask = chunk_mask(dst, n, a.pad, self.device)
            parts.append(a.embeds[dst:dst + n])
            kcs, vcs = [], []
        x = torch.cat(parts)                                   # (B + n, D)
        for i, lp in enumerate(p["layers"]):
            q, k, v = layer_project(lp, t, x)
            outs = []
            if B:
                qd, kd = apply_rope(q[:B].reshape(B, 1, -1, hd),
                                    k[:B].reshape(B, 1, -1, hd), cos, sin)
                append_token(self.kv, i, at, kd[rows, 0], v[:B].reshape(B, -1, hd)[rows])
                outs.append(attend_cache(self.kv, i, qd, mask, t)[:, 0])
            if chunk is not None:
                qc, kc = apply_rope(q[B:].reshape(1, n, -1, hd),
                                    k[B:].reshape(1, n, -1, hd), ccos, csin)
                vc = v[B:].reshape(1, n, -1, hd)
                k_all = torch.cat([self.stage_k[i, None, :dst], kc], dim=1)
                v_all = torch.cat([self.stage_v[i, None, :dst], vc], dim=1)
                outs.append(_attn(qc, k_all, v_all, cmask, t, want_probs=False)[0][0])
                kcs.append(kc[0])
                vcs.append(vc[0])
            x = layer_residuals(lp, t, x, torch.cat(outs))
        first = None
        if chunk is not None:
            self._write_chunk(a.slot, dst, torch.stack(kcs), torch.stack(vcs))
            if dst + n == a.Tb:
                first = B + n - 1
        keep = list(range(B)) + ([] if first is None else [first])
        if not keep:
            return None, None
        logits = final_logits(p, t, x[keep])
        return (logits[:B] if B else None), (logits[B] if first is not None else None)

    def _write_chunk(self, slot: int, dst: int, ks, vs) -> None:
        """All layers' chunk K/V (L, n, kvH, hd): exact into staging rows
        [dst, dst + n), and through to the slot's cache positions."""
        n = ks.shape[1]
        self.stage_k[:, dst:dst + n] = ks
        self.stage_v[:, dst:dst + n] = vs
        kv = self.kv
        if isinstance(kv, QuantKVCache):
            kv.k_q[:, slot, dst:dst + n], kv.k_s[:, slot, dst:dst + n] = quantize_kv(ks)
            kv.v_q[:, slot, dst:dst + n], kv.v_s[:, slot, dst:dst + n] = quantize_kv(vs)
        else:
            kv.k[:, slot, dst:dst + n] = ks
            kv.v[:, slot, dst:dst + n] = vs

    def _tick_fused(self):
        """``steps_per_tick`` fused steps, one host fetch, then the harvest
        and the activation of every prompt whose last chunk rode the tick.
        Without decoding slots the tick runs only the chunks there are."""
        with profiling.span("serve.tick"):
            K, B = self.steps_per_tick, self.slots
            active = [b for b, s in enumerate(self._slots) if s.active]
            rows = torch.as_tensor(active, device=self.device) if active else None
            tokens, cur, starts, offsets = self._slot_tensors()
            steps, firsts = [], []
            for _ in range(K):
                chunk = self._next_chunk()
                if rows is None and chunk is None:
                    break
                if rows is not None:
                    profiling.count("decode_steps")
                with profiling.span("decode_step"):
                    logits, flogits = self._fused_step(tokens, cur, starts, offsets, rows, chunk)
                    if rows is not None:
                        tokens = sample_tokens(logits, self.temps, self._gens, self.top_k)
                        cur = cur + 1
                        steps.append(tokens)
                    if flogits is not None:
                        firsts.append((chunk[0], torch.argmax(flogits)))
            if rows is not None:
                self.decode_steps += K
            # ONE fetch: the decode tokens and the completed prompts' first tokens
            parts = [t.reshape(-1) for t in steps] + [f.reshape(1) for _, f in firsts]
            with profiling.span("serve.fetch"):
                fetched = torch.cat(parts).tolist() if parts else []
            n_dec = len(steps) * B
            self._harvest(np.asarray(fetched[:n_dec], np.int64).reshape(K, B) if steps
                          else np.zeros((K, B), np.int64))
            now = time.perf_counter()
            for (a, _), tok in zip(firsts, fetched[n_dec:]):
                self._activate(a.slot, a.req, int(tok), now)
