"""Traffic kind ``twopass``: closed-loop batches of fresh seeded images and
questions through the program's two-pass pipeline,
``AttWarpPipeline.run`` (pass 1 extracts the attention and answers, the
MOTA mask and the warp run between the passes, pass 2 answers on the warped
image).

Mix parameters (``traffic/<mix>.json``): ``batch``; ``shapes_hw``, the raw
image sizes, every batch holding each equally often, in an order drawn from
the seed; ``question_words``, the range of words a question has, every batch
holding the same evenly spread lengths in a drawn order; ``max_new_tokens``
a pass; ``warp_size``; ``pool_batches``, the distinct batches made at
set-up and cycled through.

The check (one batch drawn from the seed, every sample of it), against the
plain reference: pass 1's served tokens, the gap by which each lies below
the reference's best logit; the attention map, against the reference's
extract-layer rows over the same tokens; the MOTA mask, against the
reference's of the program's map; the warped image, against the reference's
grid and resample of the program's mask and the raw image; pass 2's served
tokens, with the reference fed the program's warped image.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.reference import image as rimg

WORDS = ("what is shown here read label text code on tag in image answer single word or key "
         "phrase the gives helpful detailed polite answers to user questions chat between "
         "curious human and an artificial intelligence assistant").split()


def bucket(n: int, b: int = 64, cap: int = 1024) -> int:
    return min(-(-n // b) * b, cap)


class TwoPass:
    unit = "samples"

    def __init__(self, family, c: Dict[str, Any], mix: Dict[str, Any], seed: int, device):
        from attwarp_tpu_torch.pipeline import AttWarpPipeline

        self.family, self.c, self.mix, self.seed, self.device = family, c, mix, seed, device
        self.params = family.make_params(c, seed, device)
        self.backend = family.make_backend(c, self.params)
        self.pipe = AttWarpPipeline(self.backend, warp_size=mix["warp_size"],
                                    max_new_tokens=mix["max_new_tokens"])
        self.batch_units = mix["batch"]
        self.pool = [self._make_batch(i) for i in range(mix["pool_batches"])]
        self.records: List[Dict[str, Any]] = []
        self._calls: List[tuple] = []
        gen = self.backend._generate

        def captured(*args, **kwargs):
            out = gen(*args, **kwargs)
            self._calls.append((args[0], args[1], out[0]))   # ids, mask, generated ids
            return out
        self.backend._generate = captured

    # ── traffic ──────────────────────────────────────────────────────
    def _make_batch(self, i: int):
        rng = np.random.default_rng([self.seed % 2**63, 1, i])
        B = self.mix["batch"]
        shapes = [tuple(s) for s in self.mix["shapes_hw"]]
        hw = [shapes[j % len(shapes)] for j in range(B)]
        hw = [hw[j] for j in rng.permutation(B)]
        lo, hi = self.mix["question_words"]
        lens = np.round(np.linspace(lo, hi, B)).astype(int)[rng.permutation(B)]
        images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in hw]
        questions = [" ".join(rng.choice(WORDS, n)) for n in lens]
        return images, questions

    def warm_up(self) -> None:
        images, questions = self._make_batch(1 << 30)
        self.pipe.run(images, questions)
        self._calls.clear()

    # ── the timed path ──────────────────────────────────────────────
    def step(self, i: int) -> int:
        images, questions = self.pool[i % len(self.pool)]
        self._calls.clear()
        res = self.pipe.run(images, questions)
        (ids1, mask1, gen1), (ids2, mask2, gen2) = self._calls
        self.records.append({"pool": i % len(self.pool), "result": res, "ids1": ids1,
                             "mask1": mask1, "gen1": gen1, "ids2": ids2, "mask2": mask2,
                             "gen2": gen2})
        return self.batch_units

    def spans(self) -> List[tuple]:
        """(object, attribute, span name) the traced run wraps."""
        return [(self.backend, "extract", "pass1"), (self.backend, "answer_batch", "pass2"),
                (self.pipe, "run", "batch")]

    def trace_unit(self, i: int, start, stop) -> None:
        start()
        self.step(i)
        stop()

    # ── counts for the per-layer metrics ────────────────────────────
    def model_flops(self, rec: Dict[str, Any]) -> int:
        """What one batch's two passes need, as the family counts it."""
        K = self.mix["max_new_tokens"]
        per_image = self.family.image_flops(self.c)
        total = 0
        for mask, fed, part in ((rec["mask1"], K - 1, 1), (rec["mask2"], K - 1, 0)):
            for n in mask.sum(dim=1).tolist():
                total += self.family.request_flops(self.c, int(n), fed, K, n_partial=part,
                                                   partial_layers=self.c["extract_layer"] + 1)
                total += per_image
        return total

    def counters(self, window_records: List[Dict[str, Any]]) -> Dict[str, float]:
        return {"model_flops": float(sum(self.model_flops(r) for r in window_records))}

    # ── the check ───────────────────────────────────────────────────
    def check(self, n_window: int, rng: np.random.Generator, precision: str = "f32",
              control: bool = False) -> Dict[str, float]:
        """The compared numbers of one batch of the window drawn by ``rng``.
        With ``control`` the reference in ``precision`` takes the program's
        place (``control.py``)."""
        rec = self.records[int(rng.integers(n_window))]
        images, _ = self.pool[rec["pool"]]
        ref = self.family.reference(self.c, self.params, "f32")
        ctl = self.family.reference(self.c, self.params, precision) if control else None
        res = rec["result"]
        dev = self.device
        K = self.mix["max_new_tokens"]
        size = self.family.image_size(self.c)
        eos = self.family.eos_token(self.c)
        img_tok = self.family.image_token(self.c)
        n_img = self.family.map_side(self.c) ** 2
        side = self.family.map_side(self.c)

        def prompts(ids, mask):
            return [ids[b][mask[b]] for b in range(ids.shape[0])]

        # pass 1: the served tokens and the attention map
        p1 = prompts(rec["ids1"], rec["mask1"])
        gen1 = rec["gen1"]
        pix1 = torch.stack([rimg.resize(torch.as_tensor(im, device=dev)[None], (size, size))[0]
                            for im in images]) / 255.0
        seqs = [torch.cat([p, gen1[b, :K]]) for b, p in enumerate(p1)]
        starts = [int(p.shape[0]) - 1 for p in p1]
        layer = self.c["extract_layer"]
        out_r = ref.forward(seqs, ref.image_features(pix1.float()), starts, layer, starts)
        maps_r = [self._map(rows, p, img_tok, n_img, side) for (_, rows), p in zip(out_r, p1)]
        if ctl is not None:
            out_c = ctl.forward(seqs, ctl.image_features(pix1.float()), starts, layer, starts)
            maps_c = [self._map(rows, p, img_tok, n_img, side) for (_, rows), p in zip(out_c, p1)]
            gap1 = _gap([lr[:K] for lr, _ in out_r], [lc[:K].argmax(-1) for lc, _ in out_c],
                        [gen1[b, :K] for b in range(len(p1))], eos)
            maps_p = torch.stack(maps_c)
        else:
            gap1 = _gap([lr[:K] for lr, _ in out_r], [gen1[b, :K] for b in range(len(p1))],
                        [gen1[b, :K] for b in range(len(p1))], eos)
            maps_p = torch.as_tensor(res.attention_maps, device=dev)
        maps_ref = torch.stack(maps_r)
        map_err = max(float((maps_p[b].double() - maps_ref[b].double()).abs().max()
                            / maps_ref[b].double().max()) for b in range(len(p1)))

        # between the passes: the mask of the map in use, against the
        # reference's in float32 (the stage's own precision: its 8-bit
        # truncations flip by one level on rounding, so a pixel counts as off
        # where the two differ by more); the grid and resample of the mask in
        # use, against the reference's in float64
        S = self.mix["warp_size"]
        warp_err, off, n_px, warped_in = 0.0, 0, 0, []
        for b, im in enumerate(images):
            tgt = (bucket(im.shape[0]), bucket(im.shape[1]))
            src = rimg.resize(torch.as_tensor(im, device=dev)[None].double(), tgt)[0]
            ref_m = rimg.mota_mask(maps_p[b], tgt, dtype=torch.float32)
            if ctl is not None:
                mask = rimg.mota_mask(maps_p[b], tgt, dtype=torch.bfloat16)
                got = rimg.warp(src, mask, S, S, dtype=torch.bfloat16).double()
            else:
                mask = torch.as_tensor(res.mota_masks[b], device=dev)
                got = torch.as_tensor(res.warped[b], device=dev).double()
            off += int(((mask.double() - ref_m.double()).abs() > 1).sum())
            n_px += mask.numel()
            ref_w = rimg.warp(src, mask, S, S)
            warp_err = max(warp_err, float((got - ref_w).abs().max()) / 255.0)
            warped_in.append(got)
        mask_off = off / n_px

        # pass 2: the served tokens on the warped image
        p2 = prompts(rec["ids2"], rec["mask2"])
        gen2 = rec["gen2"]
        pix2 = rimg.resize(torch.stack(warped_in) / 255.0, (size, size)).float()
        seqs2 = [torch.cat([p, gen2[b, :K - 1]]) for b, p in enumerate(p2)]
        starts2 = [int(p.shape[0]) - 1 for p in p2]
        out2 = ref.forward(seqs2, ref.image_features(pix2), starts2)
        served2 = [gen2[b, :K] for b in range(len(p2))]
        if ctl is not None:
            out2c = ctl.forward(seqs2, ctl.image_features(pix2), starts2)
            gap2 = _gap([lr for lr, _ in out2], [lc.argmax(-1) for lc, _ in out2c], served2, eos)
        else:
            gap2 = _gap([lr for lr, _ in out2], served2, served2, eos)
        return {"pass1_logit_gap": gap1, "map_rel_err": map_err, "mask_px_off": mask_off,
                "warp_err": warp_err, "pass2_logit_gap": gap2}

    @staticmethod
    def _map(rows: torch.Tensor, prompt: torch.Tensor, img_tok: int, n_img: int,
             side: int) -> torch.Tensor:
        """The map of one sample from its extract-layer rows (steps, H, n):
        each step's row over the image span, renormalised per head, averaged
        over heads, then over steps."""
        st = int((prompt == img_tok).nonzero()[0, 0])
        r = rows[:, :, st:st + n_img].double()
        r = r / (r.sum(dim=-1, keepdim=True) + 1e-12)
        return r.mean(dim=1).mean(dim=0).reshape(side, -1)


def _gap(ref_logits: List[torch.Tensor], chosen: List[torch.Tensor],
         served: List[torch.Tensor], eos: int) -> float:
    """Widest gap by which a chosen token's reference logit lies below the
    reference's best, over every position whose served token is greedy (up
    to and including the first EOS)."""
    worst = 0.0
    for lg, ch, sv in zip(ref_logits, chosen, served):
        n = sv.shape[0]
        sv_l = sv.tolist()
        valid = n if eos not in sv_l else sv_l.index(eos) + 1
        lg = lg[:valid].double()
        ch = ch[:valid].to(lg.device)
        g = lg.max(dim=-1).values - lg.gather(1, ch[:, None].long())[:, 0]
        if g.numel():
            worst = max(worst, float(g.max()))
    return worst


DRIVER = TwoPass
