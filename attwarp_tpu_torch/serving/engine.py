"""Continuous-batching serving engine (counterpart of
``attwarp_tpu/serving/engine.py``).

A fixed pool of ``slots`` decodes in lock-step while requests stream in and
out: a finished slot is refilled from the queue on the next tick, so short
answers never hold up long ones. The engine knows a model family only
through its seam (``models/mllm.py``): LLaVA-1.5 and Qwen2-VL both serve.

- **Slot cache**: one ``(L, slots, max_seq, kvH, hd)`` KV cache, dense or
  int8 (``kv_quant``), leased from the pool (``models/llama.py::
  lease_kv_cache``) and given back when the engine is freed, so the next
  engine of the same shape replays the decode step's CUDA graphs captured
  over it (``models/decode_graph.py``). Each prompt is left-padded inside its 64-token
  bucket: cache positions ``[0, start)`` hold masked padding,
  ``[start, cur_len)`` the prompt, and the rotary position of a new token
  is ``cur_len + offset``, the request's offset from the model's prompt.
- **Admission**: queued requests are batched by (bucket, pixel shape) in
  power-of-two groups (``admit_batch`` while slots decode, the wider
  ``admit_batch_cold`` while the pool is idle) and prefilled together,
  through kernel K2 with ``use_flash``; the group's K/V block is copied into
  its slots and the first tokens come from the prefill logits. A failed
  prefill puts the group's requests back at the head of the queue.
- **Tick**: ``steps_per_tick`` decode steps of every slot, each through
  ``decoder_decode_step`` with per-slot positions (write the new token at
  ``cur_lens[b]``, then attend ``[starts[b], cur_lens[b]]``; through kernel
  K3 on the int8 cache), then ONE host fetch of the tokens. A slot retires
  on EOS at any step of the tick or at its ``max_new_tokens``; the steps it
  ran past that are discarded.

Sampling: temperature 0 is greedy; above 0 each request samples (top-k
truncated when ``top_k`` > 0) from its own ``torch.Generator`` seeded from
``(seed, rid)``. JAX's threefry streams are not reproduced, so sampled
tokens are reproducible by seed but differ from JAX's; greedy tokens equal
JAX's.

Not ported: ``chunk_impl`` (JAX's scan/unrolled decode loop) and the
carried decode-kernel operands (``make_decode_prep``), both XLA workarounds.
The reference's unbounded ``tick_log``/``admit_log`` are bounded here
(``LOG_LEN``), and the cold admission cap reads the device's real free
memory and the cache's real element sizes.
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from attwarp_tpu_torch.models.llama import (
    decoder_decode_step,
    decoder_prefill,
    embed,
    lease_kv_cache,
    local_kv_heads,
    release_kv_cache,
)
from attwarp_tpu_torch.models.moe import refuse_experts
from attwarp_tpu_torch.utils import profiling


@dataclass
class Request:
    rid: int
    input_ids: np.ndarray                        # (T,) expanded image tokens
    pixel_values: Optional[np.ndarray] = None   # (S, S, 3) normalized, or None
    max_new_tokens: int = 64
    temperature: float = 0.0                     # 0 = greedy


@dataclass
class _Slot:
    rid: int = -1
    generated: List[int] = field(default_factory=list)
    remaining: int = 0
    active: bool = False
    pending: bool = False   # prefill ran, first token not fetched yet


def sample_tokens(logits: torch.Tensor, temps: np.ndarray, gens: List,
                  top_k: int) -> torch.Tensor:
    """Per-slot token choice from f32 ``logits`` (B, vocab): greedy where
    ``temps[b] == 0``, else temperature sampling (top-k truncated when
    ``top_k`` > 0) from slot b's generator ``gens[b]``."""
    tokens = torch.argmax(logits, dim=-1)
    for b in np.flatnonzero(temps > 0):
        scaled = logits[b] / max(float(temps[b]), 1e-6)
        if top_k > 0:
            kth = torch.topk(scaled, top_k).values[-1]
            scaled = torch.where(scaled >= kth, scaled, float("-inf"))
        probs = torch.softmax(scaled, dim=-1)
        tokens[b] = torch.multinomial(probs, 1, generator=gens[b])[0]
    return tokens


class ServeEngine:
    """Continuous-batching engine over a model of any family
    (``models/mllm.py::MLLM``) on the model's device.

    >>> eng = ServeEngine(model, slots=8, max_seq=768, kv_quant=True)
    >>> eng.submit(ids, pixels, max_new_tokens=32)   # any number of times
    >>> results = eng.run()                          # {rid: [token, ...]}
    """

    LOG_LEN = 4096   # entries kept in tick_log and in admit_log

    def __init__(self, model, slots: int = 8, max_seq: int = 768,
                 bucket: int = 64, kv_quant: bool = False,
                 steps_per_tick: int = 8, top_k: int = 0, seed: int = 0,
                 use_flash: bool = False, admit_batch: int = 4,
                 admit_batch_cold: int = 0):
        self.model = model
        self.cfg = model.cfg
        self.tcfg = model.cfg.text
        self.device = model.device
        self.slots = slots
        if kv_quant:
            # as JAX: the int8 slot cache is a multiple of 64 positions
            # (the extra positions stay masked)
            max_seq = -(-max_seq // 64) * 64
        self.max_seq = max_seq
        self.bucket = bucket
        self.kv_quant = kv_quant
        # tokens decoded per host fetch, at the cost of <= steps_per_tick-1
        # discarded steps per finished slot
        self.steps_per_tick = max(1, steps_per_tick)
        # widest admission group while slots decode (its KV block and
        # activations sit beside the resident cache)
        self.admit_batch = max(1, admit_batch)
        # startup ramp: an idle pool has no decode to stall, so the first
        # wave admits in wider groups; 0 = min(slots, 8), clamped to the
        # device's free memory once the cache is allocated
        self.admit_batch_cold = max(
            self.admit_batch,
            min(slots, 8) if admit_batch_cold == 0 else admit_batch_cold)
        self.text_params = model.text_params
        # an expert model's prompts, positions and the chunked engine's
        # fused step (one FFN call over decode rows and a padded chunk) are
        # not built for it
        refuse_experts(self.text_params, "ServeEngine / ChunkedPrefillEngine")
        self.use_flash = use_flash
        # the model admission prefills run on (``DisaggServeEngine`` puts
        # another copy of the weights on another device here)
        self.prefill_model = model
        self.kv_transfers = 0   # KV blocks moved from the prefill model's device
        # a tensor-parallel model's slot cache holds its rank's kv heads
        kvh = local_kv_heads(self.text_params, self.tcfg)
        self.kv = lease_kv_cache(self.tcfg, slots, max_seq, self.device, kvh,
                                 None if kv_quant else self.text_params["embed_tokens"].dtype)
        weakref.finalize(self, release_kv_cache, self.kv)
        if admit_batch_cold == 0:
            self.admit_batch_cold = self._fit_cold_cap(self.admit_batch_cold)
        self._positions = torch.arange(max_seq, device=self.device)

        self._slots = [_Slot() for _ in range(slots)]
        self.tokens = np.zeros((slots,), np.int64)
        self.cur_lens = np.zeros((slots,), np.int64)
        self.starts = np.zeros((slots,), np.int64)
        self.offsets = np.zeros((slots,), np.int64)   # rotary position - cache slot
        self.top_k = top_k
        self.seed = seed
        self.temps = np.zeros((slots,), np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * slots
        self.queue: deque = deque()
        self._pending: List[Tuple[int, Request, torch.Tensor]] = []
        self.results: Dict[int, List[int]] = {}
        # per-request host wall clock: rid -> {submit, admitted, first_token,
        # done}; queue wait is admitted - submit
        self.request_stats: Dict[int, Dict[str, float]] = {}
        # rid -> its open ``serve.queued`` span, while the recorder is on
        self._queued: Dict[int, object] = {}
        # cadence records, the last LOG_LEN of each: one per tick (tick-end
        # clock, {rid: tokens consumed}) and one per admission wave (start,
        # end, requests admitted)
        self.tick_log: deque = deque(maxlen=self.LOG_LEN)
        self.admit_log: deque = deque(maxlen=self.LOG_LEN)
        # work counts: decode steps run (each launches K3 once per layer on
        # the int8 cache) and admission prefill groups (K2 once per layer
        # with use_flash on a long bucket)
        self.decode_steps = 0
        self.prefill_groups = 0
        self._next_rid = 0

    def _admission_bytes(self) -> int:
        """Device bytes one request adds to an admission group at the
        longest bucket: its slot row of every cache tensor (the KV block,
        at the cache's real element sizes) plus the prefill's live
        activations, taken as ten hidden-wide and three FFN-wide rows per
        token, and with the dense prefill three f32 (H, T, T) score
        tensors."""
        t = self.tcfg
        row = sum(x[:, 0].numel() * x.element_size() for x in self.kv)
        elem = self.text_params["embed_tokens"].element_size()
        row += self.max_seq * (10 * t.hidden_size + 3 * t.intermediate_size) * elem
        if not self.use_flash:
            row += 3 * 4 * t.num_attention_heads * self.max_seq ** 2
        return row

    def _fit_cold_cap(self, want: int) -> int:
        """Halve the startup-ramp cap until its admission groups fit in the
        device's free memory (read after the weights and the slot cache are
        allocated) less a 1 GiB margin and 8% for fragmentation. The CPU
        counts as unlimited, as in JAX."""
        if self.device.type != "cuda":
            return want
        free, _ = torch.cuda.mem_get_info(self.device)
        budget = int(free * 0.92) - (1 << 30)
        row = self._admission_bytes()
        cap = want
        while cap > self.admit_batch and cap * row > budget:
            cap //= 2
        cap = max(self.admit_batch, cap)
        if cap < want:
            print(f"ServeEngine: startup-ramp cold cap {want} -> {cap} "
                  f"({row / 2**20:.0f} MiB per admitted request at "
                  f"max_seq={self.max_seq}, {max(budget, 0) / 2**30:.2f} GiB free)")
        return cap

    # ── public API ─────────────────────────────────────────────────────
    def submit(self, input_ids, pixel_values=None, max_new_tokens: int = 64,
               temperature: float = 0.0) -> int:
        ids = np.asarray(input_ids, np.int64).reshape(-1)
        Tb = -(-len(ids) // self.bucket) * self.bucket
        need = Tb + max_new_tokens + self.steps_per_tick
        if need > self.max_seq:
            raise ValueError(
                f"prompt bucket {Tb} + max_new {max_new_tokens} (+chunk "
                f"slack {self.steps_per_tick}) exceeds max_seq {self.max_seq}")
        rid = self._next_rid
        self._next_rid += 1
        self.request_stats[rid] = {"submit": time.perf_counter()}
        queued = profiling.begin("serve.queued", rid=rid)
        if queued is not None:
            self._queued[rid] = queued
        self.queue.append(Request(rid, ids,
                                  None if pixel_values is None
                                  else np.asarray(pixel_values, np.float32),
                                  max_new_tokens, float(temperature)))
        return rid

    def run(self) -> Dict[int, List[int]]:
        """Drive until queue and slots drain; returns {rid: generated ids}."""
        while self.queue or any(s.active or s.pending for s in self._slots):
            self._admit()
            if any(s.active for s in self._slots):
                self._tick()
            elif self._pending:
                # nothing decoding: fetch the admissions' first tokens now
                self._activate_pending(
                    torch.stack([f for _, _, f in self._pending]).tolist())
        return self.results

    # ── admission ──────────────────────────────────────────────────────
    def _admitted(self, req: Request) -> None:
        """``req`` leaves the queue: its queue wait ends."""
        self.request_stats[req.rid]["admitted"] = time.perf_counter()
        queued = self._queued.pop(req.rid, None)
        if queued is not None:
            queued.end()

    def _admit(self):
        """Prefill queued requests into every free slot, batched by (length
        bucket, pixel shape) in power-of-two groups. The first tokens stay
        on the device and are fetched with the next tick's tokens; a pending
        slot joins the decode after that fetch. On a failed prefill the
        requests not yet admitted go back to the head of the queue, in
        order, and their slots are freed, before the error propagates."""
        free = [b for b, s in enumerate(self._slots)
                if not (s.active or s.pending)]
        n = min(len(free), len(self.queue))
        if n == 0:
            return
        with profiling.span("serve.admit"):
            t0 = time.perf_counter()
            pairs = []
            for b in free[:n]:
                req = self.queue.popleft()
                self._admitted(req)
                self._slots[b].pending = True
                self._slots[b].rid = req.rid
                pairs.append((b, req))
            admitted = set()
            # startup ramp: pending slots do not count as decoding
            cap = (self.admit_batch if any(s.active for s in self._slots)
                   else self.admit_batch_cold)
            try:
                groups: Dict[Tuple[int, Optional[Tuple[int, ...]]], List] = {}
                for b, req in pairs:
                    Tb = -(-len(req.input_ids) // self.bucket) * self.bucket
                    pix = (None if req.pixel_values is None
                           else tuple(req.pixel_values.shape))
                    groups.setdefault((Tb, pix), []).append((b, req))
                for (Tb, pix), members in groups.items():
                    i = 0
                    while i < len(members):
                        size = min(1 << ((len(members) - i).bit_length() - 1), cap)
                        chunk = members[i:i + size]
                        self._prefill_group(Tb, pix is not None, chunk)
                        admitted.update(b for b, _ in chunk)
                        i += size
            except Exception:
                for b, req in reversed([(b, r) for b, r in pairs if b not in admitted]):
                    self._slots[b].pending = False
                    self._slots[b].rid = -1
                    self.queue.appendleft(req)
                raise
            if admitted:
                self.admit_log.append((t0, time.perf_counter(), len(admitted)))

    def _embed_group(self, Tb: int, with_image: bool, chunk):
        """Left-pad ``chunk`` = [(slot, request), ...] (one bucket, one
        pixel shape) into its bucket and embed it through the prefill
        model's ``prompt``: the vision tower runs once over the group's
        images and its features replace the image tokens. Sets each slot's
        next write position (``Tb``), pad offset and rotary offset. Returns
        embeds (n, Tb, D), mask (n, Tb) bool and the rotary cos/sin (n, Tb,
        hd) of every position, on the prefill model's device."""
        model = self.prefill_model
        dev = model.device
        n = len(chunk)
        ids_np = np.zeros((n, Tb), np.int64)
        mask_np = np.zeros((n, Tb), bool)
        for j, (b, req) in enumerate(chunk):
            pad = Tb - len(req.input_ids)
            ids_np[j, pad:] = req.input_ids
            mask_np[j, pad:] = True
            self.cur_lens[b] = Tb
            self.starts[b] = pad
        if profiling.recording():
            profiling.count("prefill_tokens", int(mask_np.sum()))
        ids = torch.as_tensor(ids_np, device=dev)
        mask = torch.as_tensor(mask_np, device=dev)
        image = (model.image_input(torch.as_tensor(
            np.stack([r.pixel_values for _, r in chunk]), device=dev)) if with_image else None)
        embeds, cos, sin, offset = model.prompt(ids, mask, image, (ids_np, mask_np))
        for j, (b, _) in enumerate(chunk):
            self.offsets[b] = offset[j]
        return embeds, mask, cos, sin

    def _prefill_group(self, Tb: int, with_image: bool, chunk) -> None:
        """One batched prefill (kernel K2 with ``use_flash`` where JAX's gate
        allows) on the prefill model and one grouped insert for ``chunk``."""
        with profiling.span("serve.prefill_group", n=len(chunk), Tb=Tb):
            embeds, mask, cos, sin = self._embed_group(Tb, with_image, chunk)
            logits, block, _ = decoder_prefill(
                self.prefill_model.text_params, self.tcfg, embeds, mask, cos, sin, max_seq=Tb,
                use_flash=self.use_flash, kv_quant=self.kv_quant)
            firsts = torch.argmax(logits, dim=-1)
            if self.prefill_model is not self.model:
                # one transfer per admission group: the finished block
                block = type(block)(*(t.to(self.device) for t in block))
                firsts = firsts.to(self.device)
                self.kv_transfers += 1
            self._insert(block, chunk, Tb, firsts)

    def _insert(self, block, chunk, Tb: int, firsts: torch.Tensor) -> None:
        """Copy a group's prefill cache block (L, n, Tb, ...) into its
        slots' positions [0, Tb) (one indexed write per cache tensor) and
        queue the unfetched first tokens."""
        slots = torch.as_tensor([b for b, _ in chunk], device=self.device)
        for big, small in zip(self.kv, block):
            big[:, slots, :Tb] = small.to(big.dtype)
        self.prefill_groups += 1
        for j, (b, req) in enumerate(chunk):
            self._pending.append((b, req, firsts[j]))

    def _activate(self, b: int, req: Request, tok: int, now: float) -> None:
        """Slot ``b`` starts decoding ``req`` from its first token."""
        slot = self._slots[b]
        self.tokens[b] = tok
        self.request_stats[req.rid]["first_token"] = now
        self.temps[b] = req.temperature
        if req.temperature > 0:   # the request's own stream, from (seed, rid)
            seed = np.random.SeedSequence((self.seed, req.rid)).generate_state(1, np.uint64)
            self._gens[b] = torch.Generator(device=self.device).manual_seed(int(seed[0]))
        slot.generated = [tok]
        slot.remaining = req.max_new_tokens - 1
        slot.pending = False
        slot.active = True
        if tok == self.cfg.eos_token_id or slot.remaining <= 0:
            self._retire(b)

    def _activate_pending(self, firsts) -> None:
        now = time.perf_counter()
        for (b, req, _), tok in zip(self._pending, firsts):
            self._activate(b, req, int(tok), now)
        self._pending.clear()

    # ── decode ─────────────────────────────────────────────────────────
    def _slot_tensors(self):
        """The host slot state on the device: tokens, cur_lens, starts,
        offsets (all (slots,) long)."""
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in (self.tokens, self.cur_lens, self.starts, self.offsets))

    def _slot_mask(self, cur, starts) -> torch.Tensor:
        """(B, max_seq): slot b attends [starts[b], cur[b]], the token
        written this step included."""
        ar = self._positions[None, :]
        return (ar >= starts[:, None]) & (ar <= cur[:, None])

    def _decode_step(self, tokens, cur, starts, offsets) -> torch.Tensor:
        """Every slot one token; returns the f32 logits (B, vocab)."""
        cos, sin = self.model.decode_rope(cur + offsets)
        emb = embed(self.text_params, tokens)[:, None, :]
        logits, _, _ = decoder_decode_step(self.text_params, self.tcfg, emb, self.kv,
                                           cur, cos, sin, self._slot_mask(cur, starts))
        return logits

    def _tick(self):
        with profiling.span("serve.tick"):
            K, B = self.steps_per_tick, self.slots
            tokens, cur, starts, offsets = self._slot_tensors()
            steps = []
            for _ in range(K):
                profiling.count("decode_steps")
                with profiling.span("decode_step"):
                    logits = self._decode_step(tokens, cur, starts, offsets)
                    tokens = sample_tokens(logits, self.temps, self._gens, self.top_k)
                    cur = cur + 1
                    steps.append(tokens)
            self.decode_steps += K
            # ONE fetch: the tick's tokens and the pending admissions' first
            # tokens (pending slots join the next tick)
            with profiling.span("serve.fetch"):
                fetched = torch.cat([torch.stack(steps).reshape(-1)]
                                    + [f.reshape(1) for _, _, f in self._pending]).tolist()
            chunk = np.asarray(fetched[:K * B], np.int64).reshape(K, B)
            self._harvest(chunk)
            if self._pending:
                self._activate_pending(fetched[K * B:])

    @profiling.span("serve.harvest")
    def _harvest(self, chunk: np.ndarray) -> None:
        """Hand a tick's tokens (K, B) to the active slots. A slot consumes
        tokens up to and including EOS (at any step, the last one too) or
        its ``max_new_tokens``. Its device position advanced K steps, so the
        host's does too; a slot retires when finished or when another tick
        would pass ``max_seq``."""
        K = chunk.shape[0]
        took: Dict[int, int] = {}
        for b, slot in enumerate(self._slots):
            if not slot.active:
                continue
            finished = False
            consumed = 0
            for j in range(K):
                tok = int(chunk[j, b])
                slot.generated.append(tok)
                slot.remaining -= 1
                consumed = j + 1
                if tok == self.cfg.eos_token_id or slot.remaining <= 0:
                    finished = True
                    break
            took[slot.rid] = consumed
            self.cur_lens[b] += K
            self.tokens[b] = int(chunk[K - 1, b])
            if finished or self.cur_lens[b] + K >= self.max_seq:
                self._retire(b)
        self.tick_log.append((time.perf_counter(), took))

    def _retire(self, b: int):
        slot = self._slots[b]
        self.results[slot.rid] = slot.generated
        self.request_stats[slot.rid]["done"] = time.perf_counter()
        slot.active = False
        slot.rid = -1
        self.cur_lens[b] = 0
        self.starts[b] = 0
        self.offsets[b] = 0
        self.temps[b] = 0.0
        self.tokens[b] = 0
        self._gens[b] = None
