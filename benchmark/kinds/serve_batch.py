"""Traffic kind ``serve_batch``: closed-loop batches of image questions,
each batch submitted whole to the program's serving entry,
``cli.serve.serve`` (one ``ServeEngine`` a batch, drained by ``run``).

Mix parameters (``traffic/<mix>.json``): ``requests`` a batch; ``slots``,
``steps_per_tick`` and ``admit_batch`` of the engine; ``image_hw``, one raw
image a request; ``question_words``, a range every batch spreads evenly
over; ``max_new_tokens`` [lo, hi], spread log-uniformly over every batch
(standing in for the EOS that random weights never reach, so that slots
retire and refill unevenly); ``order_seed``, which fixes the order of both
spreads, the same in every batch of every run (the engine's schedule
follows the order, so the seed changes only the images and the words);
``pool_batches``.
Each request's ids and pixels are made at set-up by the backend's own
``build_ids`` and ``_preprocess``, as ``cli.serve.main`` makes them before
it calls ``serve``. ``max_seq`` is sized as the evaluation harness's
``EngineAnswerBackend`` sizes it: the longest prompt bucket, the longest
answer and one tick.

The check: ``check_requests`` finished requests of the window, drawn from
the seed with the longest among them; the gap by which each served token's
logit lies below the plain reference's best, the reference run once over
the prompt and the served tokens.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.kinds.twopass import WORDS, _gap
from benchmark.reference import image as rimg


class ServeBatch:
    unit = "tokens"

    def __init__(self, family, c: Dict[str, Any], mix: Dict[str, Any], seed: int, device):
        self.family, self.c, self.mix, self.seed, self.device = family, c, mix, seed, device
        self.params = family.make_params(c, seed, device)
        self.backend = family.make_backend(c, self.params)
        self.pool = [self._make_batch(i) for i in range(mix["pool_batches"])]
        self.records: List[Dict[str, Any]] = []
        self.batch_units = 0

    def _make_batch(self, i: int, n: int = 0):
        rng = np.random.default_rng([self.seed % 2**63, 2, i])
        n = n or self.mix["requests"]
        order = np.random.default_rng(self.mix["order_seed"])
        lo, hi = self.mix["question_words"]
        words = np.round(np.linspace(lo, hi, n)).astype(int)[order.permutation(n)]
        a, b = self.mix["max_new_tokens"]
        mnt = np.round(np.exp(np.linspace(np.log(a), np.log(b), n))).astype(int)[order.permutation(n)]
        h, w = self.mix["image_hw"]
        reqs = []
        for k in range(n):
            im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            q = " ".join(rng.choice(WORDS, words[k]))
            reqs.append({"image": im, "input_ids": self.backend.build_ids(q),
                         "pixel_values": self.backend._preprocess(im),
                         "max_new_tokens": int(mnt[k])})
        bucketed = max(-(-len(r["input_ids"]) // 64) * 64 for r in reqs)
        max_seq = bucketed + int(mnt.max()) + self.mix["steps_per_tick"]
        return reqs, max_seq

    def _serve(self, reqs, max_seq):
        from attwarp_tpu_torch.cli.serve import serve

        return serve(self.backend, [{k: r[k] for k in ("input_ids", "pixel_values",
                                                       "max_new_tokens")} for r in reqs],
                     slots=self.mix["slots"], max_seq=max_seq,
                     steps_per_tick=self.mix["steps_per_tick"])

    def warm_up(self) -> None:
        """Every admission-group size and both buckets once, short answers."""
        reqs, max_seq = self._make_batch(1 << 30, n=2 * self.mix["slots"])
        for r in reqs:
            r["max_new_tokens"] = min(r["max_new_tokens"], 2 * self.mix["steps_per_tick"])
        self._serve(reqs, max_seq)

    def step(self, i: int) -> int:
        reqs, max_seq = self.pool[i % len(self.pool)]
        self.batch_units = sum(r["max_new_tokens"] for r in reqs)   # counted failed if it raises
        engine, outs = self._serve(reqs, max_seq)
        bad = [k for k, (r, o) in enumerate(zip(reqs, outs))
               if not 1 <= len(o) <= r["max_new_tokens"]]
        if bad:   # an answer that never came, or ran past its length
            raise RuntimeError(f"{len(bad)} of {len(reqs)} requests served no answer or "
                               f"more tokens than asked")
        n = sum(len(o) for o in outs)
        self.records.append({"pool": i % len(self.pool), "outs": outs,
                             "decode_steps": engine.decode_steps,
                             "prefill_groups": engine.prefill_groups,
                             "admit_log": list(engine.admit_log), "tick_log": list(engine.tick_log),
                             "slots": engine.slots})
        return n

    def spans(self) -> List[tuple]:
        return []

    def trace_unit(self, i: int, start, stop) -> None:
        """One batch, traced from its ``trace_ticks[0]``-th tick to its
        ``trace_ticks[1]``-th (a whole batch would trace ~1 GB)."""
        from attwarp_tpu_torch.serving import engine as eng_mod

        a, b = self.mix["trace_ticks"]
        orig = eng_mod.ServeEngine._tick
        count = {"n": 0}

        def tick(engine_self):
            if count["n"] == a:
                start()
            orig(engine_self)
            count["n"] += 1
            if count["n"] == b:
                stop()
        eng_mod.ServeEngine._tick = tick
        try:
            self.step(i)
        finally:
            eng_mod.ServeEngine._tick = orig
            if a <= count["n"] < b:
                stop()

    def counters(self, window_records: List[Dict[str, Any]]) -> Dict[str, float]:
        per_image = self.family.image_flops(self.c)
        flops, kept, slot_steps, admit = 0, 0, 0, 0.0
        for rec in window_records:
            reqs, _ = self.pool[rec["pool"]]
            for r, out in zip(reqs, rec["outs"]):
                g = len(out)
                flops += self.family.request_flops(self.c, len(r["input_ids"]), g - 1, g)
                flops += per_image
            kept += sum(sum(took.values()) for _, took in rec["tick_log"])
            slot_steps += rec["decode_steps"] * rec["slots"]
            admit += sum(e - s for s, e, _ in rec["admit_log"])
        return {"model_flops": float(flops), "tokens_kept": float(kept),
                "slot_steps": float(slot_steps), "admission_s": admit}

    def check(self, n_window: int, rng: np.random.Generator, precision: str = "f32",
              control: bool = False) -> Dict[str, float]:
        picks = [(bi, k) for bi in range(n_window)
                 for k in range(len(self.records[bi]["outs"]))]
        longest = max(picks, key=lambda p: len(self.records[p[0]]["outs"][p[1]]))
        n = min(self.mix["check_requests"], len(picks))
        others = [picks[j] for j in rng.choice(len(picks), n, replace=False) if picks[j] != longest]
        chosen = [longest] + others[:n - 1]
        ref = self.family.reference(self.c, self.params, "f32")
        ctl = self.family.reference(self.c, self.params, precision) if control else None
        dev = self.device
        size = self.family.image_size(self.c)
        eos = self.family.eos_token(self.c)
        seqs, starts, served, pix = [], [], [], []
        for bi, k in chosen:
            r = self.pool[self.records[bi]["pool"]][0][k]
            out = torch.as_tensor(self.records[bi]["outs"][k], device=dev)
            ids = torch.as_tensor(r["input_ids"], device=dev)
            seqs.append(torch.cat([ids, out[:-1]]))
            starts.append(int(ids.shape[0]) - 1)
            served.append(out)
            pix.append(rimg.resize(torch.as_tensor(r["image"], device=dev)[None],
                                   (size, size))[0] / 255.0)
        pix = torch.stack(pix).float()
        gaps = []
        for j in range(0, len(seqs), 4):   # the reference in blocks of four requests
            sl = slice(j, j + 4)
            out_r = ref.forward(seqs[sl], ref.image_features(pix[sl]), starts[sl])
            if ctl is not None:
                out_c = ctl.forward(seqs[sl], ctl.image_features(pix[sl]), starts[sl])
                gaps.append(_gap([lr for lr, _ in out_r], [lc.argmax(-1) for lc, _ in out_c],
                                 served[sl], eos))
            else:
                gaps.append(_gap([lr for lr, _ in out_r], served[sl], served[sl], eos))
        self.check_info = {"requests_checked": len(chosen),
                           "served_tokens_checked": sum(len(s) for s in served)}
        return {"logit_gap": max(gaps)}


DRIVER = ServeBatch
