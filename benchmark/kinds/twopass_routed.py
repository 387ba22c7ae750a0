"""Traffic kind ``twopass_routed``: the ``twopass`` kind's closed-loop
batches through ``AttWarpPipeline.run`` (``kinds/twopass.py``), over a
model whose FFNs route tokens to experts.

The experts a token takes depend on its router's probabilities, so the
routed work of a batch cannot be counted from its token counts. The
program keeps a tally of routed (token, layer, expert) pairs on the device
(the backend's ``moe_tally``, ``models/moe.py::MoETally``); this kind
copies it on the device before and after each batch, with no host read,
and reads the differences after the window. ``counters`` adds
``routed_pairs`` and ``routed_rows`` (token rows through an expert layer),
and the routed pairs' FLOPs (``family.routed_pair_flops``) to
``model_flops``, beside what ``family.request_flops`` counts.

The check is the ``twopass`` kind's, with the float32 reference holding
to the routing of what it checks. A bfloat16 hidden state falls on the
other side of a near-tie (a cumulative sum at ``top_p``, two experts of
equal probability) from the float32 one now and then, and a flipped set
moves a token's logits as far as the control's rounding does. So the
program keeps every token row's chosen experts (``MoETally.log_routing``)
and the reference follows the program's sets for the checked batch; it
counts, as ``routing_mismatch``, the share of the decisions with a margin
above ``reference/unimoe.py::ROUTING_EPS`` whose set differs from its own.
The control, in the program's place, is held the same way to its own
sets.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import torch

from benchmark.kinds.twopass import TwoPass

# rows of the program's routing log a layer: a 30 s window of this mix
# counts ~13,000 rows a batch, ~230,000 in all
LOG_ROWS = 1 << 20


class TwoPassRouted(TwoPass):
    def __init__(self, family, c: Dict[str, Any], mix: Dict[str, Any], seed: int, device):
        super().__init__(family, c, mix, seed, device)
        self.tally = self.backend.moe_tally
        self.tally.log_routing(LOG_ROWS)

    def step(self, i: int) -> int:
        before = self.tally.snapshot()
        done = super().step(i)
        self.records[-1]["tally"] = (before, self.tally.snapshot())
        return done

    def counters(self, window_records: List[Dict[str, Any]]) -> Dict[str, float]:
        out = super().counters(window_records)
        pairs = rows = 0
        for rec in window_records:
            before, after = rec["tally"]
            t = self.tally.totals(after - before)
            pairs += t["moe.routed_pairs"]
            rows += t["moe.rows"]
        out["routed_pairs"] = float(pairs)
        out["routed_rows"] = float(rows)
        out["model_flops"] += float(pairs * self.family.routed_pair_flops(self.c))
        return out

    # ── the check ───────────────────────────────────────────────────
    def program_routes(self, rec: Dict[str, Any]):
        """The program's sets for a batch's two passes, per sequence as the
        check feeds them (the prompt, then the fed tokens): two lists of
        (layers, n, routed) bool. The rows ran in this order: pass 1's
        prefill (the prompts' token rows), its decode steps (a row a
        sequence), then pass 2's."""
        K = self.mix["max_new_tokens"]
        start, stop = (int(t[0, -1]) for t in rec["tally"])
        log = self.tally.routes(start, stop)
        out, at = [], 0
        for mask, fed in ((rec["mask1"], K), (rec["mask2"], K - 1)):
            lens = mask.sum(dim=1).tolist()
            B, n = len(lens), sum(lens)
            pre = log[:, at:at + n]
            steps = log[:, at + n:at + n + K * B].reshape(log.shape[0], K, B, -1)
            at += n + K * B
            offs = [sum(lens[:b]) for b in range(B)]
            out.append([torch.cat([pre[:, o:o + m], steps[:, :fed, b]], dim=1)
                        for b, (o, m) in enumerate(zip(offs, lens))])
        if at != stop - start:
            raise ValueError(f"the routing log holds {stop - start} rows for the batch, "
                             f"its passes {at}")
        return out

    def check(self, n_window: int, rng, precision: str = "f32",
              control: bool = False) -> Dict[str, float]:
        rec = self.records[int(copy.deepcopy(rng).integers(n_window))]  # TwoPass.check's draw
        follow = _Following(self.family, None if control else self.program_routes(rec),
                            precision)
        family, self.family = self.family, follow
        try:
            out = super().check(n_window, rng, precision, control)
        finally:
            self.family = family
        sure, off = (sum(r.routing[i] for r in follow.refs) for i in (0, 1))
        out["routing_mismatch"] = off / max(sure, 1)
        return out


class _Following:
    """The family for ``TwoPass.check``, its float32 reference following
    the routing of what is checked: the program's logged sets, pass by
    pass (``routes``), or where ``routes`` is None the control's own (the
    control run once more on the same tokens before the reference)."""

    def __init__(self, family, routes, precision: str):
        self.family, self.routes, self.precision = family, routes, precision
        self.refs: List[Any] = []

    def __getattr__(self, name):
        return getattr(self.family, name)

    def reference(self, c, params, precision: str = "f32"):
        ref = self.family.reference(c, params, precision)
        if precision != "f32":
            return ref
        self.refs.append(ref)
        return _FollowingRef(ref, self._sets(c, params))

    def _sets(self, c, params):
        queue = list(self.routes) if self.routes is not None else None

        def sets(seqs, pixels, args):
            if queue is not None:
                routes = queue.pop(0)
            else:
                ctl = self.family.reference(c, params, self.precision)
                ctl.forward(seqs, ctl.image_features(pixels), *args)
                routes = ctl.last_routes
            if [r.shape[1] for r in routes] != [len(s) for s in seqs]:
                raise ValueError("the routing sets do not cover the sequences checked")
            return routes
        return sets


class _FollowingRef:
    """A reference whose ``forward`` follows the sets ``sets(seqs, pixels,
    args)`` gives (``pixels`` the images its ``image_features`` last
    took)."""

    def __init__(self, ref, sets):
        self.ref, self.sets, self.pixels = ref, sets, None

    def image_features(self, pixels):
        self.pixels = pixels
        return self.ref.image_features(pixels)

    def forward(self, seqs, feats, *args):
        return self.ref.forward(seqs, feats, *args, routes=self.sets(seqs, self.pixels, args))


DRIVER = TwoPassRouted
