"""Plain Uni-MoE-2.0-Omni for the benchmark's check (HF ``grin_qwen2_vl``,
one 384 px image a sequence): the SigLIP tower (pixels normalized by mean
and std 0.5, each 14 x 14 patch embedded with a bias, learned positions, no
class token and no pre-layernorm, pre-LN blocks of full attention with
tanh-GELU MLPs, the hidden state of the block before the last with no
post-layernorm), the linear aligner, and the Qwen2 decoder of
``reference/qwen2vl.py`` (q/k/v biases, M-RoPE over the image's 27 x 27
grid with no merge) with every FFN the dynamic mixture of experts:

- ``p = softmax(W_r u)`` in float32 over the routed experts, then the null
  expert;
- the entries sorted by descending ``p``, ties to the lower index; the
  shortest prefix whose cumulative sum reaches ``mlp_dynamic_top_p``, cut
  to ``mlp_dynamic_top_k`` entries; the null entry dropped;
- ``FFN(u) = S_1(u) + S_2(u) + sum over the rest of p_e E_e(u)``, each a
  SwiGLU; the weights the raw probabilities.

Each expert runs on the rows that chose it (the result is the
equations'). Where a check holds the reference to the program's routing,
``forward(..., routes=...)`` follows given sets instead of its own, and
counts the decisions it departs from that are no near-tie (``ffn``): a
bfloat16 hidden state can fall on the other side of ``top_p`` or of an
order from the float32 one, and a flip moves a token's output far. The layers run in the outer loop, so that each layer's
weights are cast once for every sequence (~3.3 GB of float32 experts a
layer at the published widths). Reads the weights in the program's tree
layout as the benchmark made them (a routed expert's ``gate_up`` rows are
its gate rows, then its up rows); imports nothing of the program.

``precision`` as ``reference/decoder.py``'s: ``"fp8"`` (the control) rounds
every bfloat16 linear layer's rows to float8, and the float32 router's
input and weights to bfloat16, the step below each.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.decoder import attention, rms_norm, rotate_half, splice
from benchmark.reference.qwen2vl import Qwen2VLReference


def _ln(x, p, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["weight"].float() + p["bias"].float()


# a routing decision nearer a flip than this (in probability) is a near-tie
ROUTING_EPS = 0.02


class UniMoEReference(Qwen2VLReference):
    def __init__(self, c: Dict[str, Any], params: Dict[str, Any], precision: str = "f32"):
        super().__init__(c, params, precision)
        self.routed = c["mlp_dynamic_expert_num"]
        # (decisions followed with a margin above ROUTING_EPS, those whose set differed)
        self.routing = [0, 0]
        self.last_routes: List[torch.Tensor] = []

    def image_features(self, pixels01: torch.Tensor) -> torch.Tensor:
        """Images (B, S, S, 3) in [0, 1] -> aligned features (B, n_img, D)."""
        v, mm, vp = self.c["vision_config"], self.mm, self.p["vision"]
        x = (pixels01.to(torch.float32) - 0.5) / 0.5
        B, S, P, E = x.shape[0], x.shape[1], v["patch_size"], v["hidden_size"]
        H, eps = v["num_attention_heads"], v["layer_norm_eps"]
        hd, n = E // H, S // P
        x = x[:, :n * P, :n * P]   # a stride-P convolution drops the rest
        patches = x.reshape(B, n, P, n, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, n * n, -1)
        h = mm(patches, mm.prep(vp["patch_weight"]), vp["patch_bias"])
        h = h + vp["position_embedding"].float()[None]
        run = self.c["vision_feature_layer"] % (v["num_hidden_layers"] + 1)
        for lp in vp["layers"][:run]:
            W = {k: mm.prep(lp[k]["weight"]) for k in ("q_proj", "k_proj", "v_proj",
                                                       "out_proj", "fc1", "fc2")}
            a = _ln(h, lp["layer_norm1"], eps)
            q, k, vv = (mm(a, W[w], lp[w]["bias"]).reshape(B, -1, H, hd)
                        for w in ("q_proj", "k_proj", "v_proj"))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vv).reshape(B, -1, E)
            del s
            h = h + mm(o, W["out_proj"], lp["out_proj"]["bias"])
            f = mm(_ln(h, lp["layer_norm2"], eps), W["fc1"], lp["fc1"]["bias"])
            h = h + mm(F.gelu(f, approximate="tanh"), W["fc2"], lp["fc2"]["bias"])
        al = self.p["aligner"]
        return mm(h, mm.prep(al["weight"]), al["bias"])

    def route(self, u: torch.Tensor, router: torch.Tensor):
        """Rows u (n, D) -> (each row's probabilities (n, routed + null),
        R(u) as a mask over the routed experts (n, routed), and the
        decision's margin (n,): the least distance of a cumulative sum that
        could end the prefix from ``top_p``, or of the last entry taken from
        the first left out)."""
        w = router.to(torch.float32)
        if self.mm.fp8:
            u, w = u.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
        p = torch.softmax(u @ w.t(), dim=-1)
        top_p, top_k = self.c["mlp_dynamic_top_p"], self.c["mlp_dynamic_top_k"]
        ps, order = torch.sort(p, dim=-1, descending=True, stable=True)
        c = torch.cumsum(ps, dim=-1)
        before = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)   # sum ahead
        rank = torch.arange(p.shape[1], device=p.device)
        taken = (before < top_p) & (rank < top_k)
        mask = torch.zeros_like(taken).scatter(1, order, taken)[:, :self.routed]
        n = taken.sum(1, keepdim=True)
        edge = ps.gather(1, n - 1) - ps.gather(1, torch.clamp(n, max=ps.shape[1] - 1))
        margin = torch.minimum((c[:, :top_k - 1] - top_p).abs().amin(1), edge[:, 0])
        return p, mask, margin

    def ffn(self, u: torch.Tensor, ex: Dict[str, List[torch.Tensor]], router: torch.Tensor,
            follow=None) -> torch.Tensor:
        """The FFN of rows u; with ``follow`` (n, routed) bool, the experts
        of those sets in place of R(u), each weighted by its probability
        here (the decisions it departs from by more than ``ROUTING_EPS``
        counted in ``routing``). Returns (y, the sets used)."""
        mm = self.mm

        def swiglu(x, gate_up, down):
            g, up = mm(x, gate_up).chunk(2, dim=-1)
            return mm(F.silu(g) * up, down)

        y = sum(swiglu(u, gu, d) for gu, d in zip(ex["shared_gate_up"], ex["shared_down"]))
        p, mask, margin = self.route(u, router)
        if follow is not None:
            follow = follow.to(mask.device)
            sure = margin > ROUTING_EPS
            self.routing[0] += int(sure.sum())
            self.routing[1] += int(((follow != mask).any(1) & sure).sum())
            mask = follow
        w = torch.where(mask, p[:, :self.routed], torch.zeros_like(p[:, :self.routed]))
        for e, (gu, d) in enumerate(zip(ex["gate_up"], ex["down"])):
            rows = w[:, e].nonzero()[:, 0]
            if rows.numel():
                y[rows] += w[rows, e, None] * swiglu(u[rows], gu, d)
        return y, mask

    def forward(self, ids_list: List[torch.Tensor], feats: torch.Tensor, logit_from: List[int],
                row_layer=None, row_from=None, routes=None):
        """As ``Qwen2VLReference.forward``: per sequence (logits from
        ``logit_from[i]``, the ``row_layer`` attention rows from
        ``row_from[i]``). With ``routes`` (per sequence, (layers, n_i,
        routed) bool) every expert layer follows those sets (``ffn``).
        ``last_routes`` keeps the sets used, per sequence."""
        tp, dims, mm = self.p["text"], self.dims, self.mm
        n_img = feats.shape[1]
        side = int(math.isqrt(n_img))
        hd = dims.head_dim
        xs, tables = [], []
        for i, ids in enumerate(ids_list):
            xs.append(splice(tp["embed_tokens"], ids, self.c["image_token_id"], feats[i]))
            tables.append(self.mrope(ids, n_img, side))
        rows: List[Any] = [None] * len(xs)
        used: List[List[torch.Tensor]] = [[] for _ in xs]
        for li, lp in enumerate(tp["layers"]):
            w = {k: mm.prep(lp[k]["weight"] if isinstance(lp[k], dict) else lp[k])
                 for k in ("q_proj", "k_proj", "v_proj", "o_proj")}
            bias = {k: lp[k]["bias"] for k in ("q_proj", "k_proj", "v_proj")}
            m = lp["moe"]
            ex = {k: [mm.prep(t) for t in m[k]]
                  for k in ("gate_up", "down", "shared_gate_up", "shared_down")}
            for i, x in enumerate(xs):
                n = x.shape[0]
                cos, sin = tables[i]
                h = rms_norm(x, lp["input_layernorm"], dims.eps)
                q = mm(h, w["q_proj"], bias["q_proj"]).reshape(n, dims.heads, hd)
                k = mm(h, w["k_proj"], bias["k_proj"]).reshape(n, dims.kv_heads, hd)
                v = mm(h, w["v_proj"], bias["v_proj"]).reshape(n, dims.kv_heads, hd)
                q = q * cos[:, None] + rotate_half(q) * sin[:, None]
                k = k * cos[:, None] + rotate_half(k) * sin[:, None]
                out, p = attention(q, k, v, dims)
                if li == row_layer:
                    rows[i] = p[:, row_from[i]:, :].permute(1, 0, 2).contiguous()
                del p
                x = x + mm(out, w["o_proj"])
                y, sets = self.ffn(rms_norm(x, lp["post_attention_layernorm"], dims.eps), ex,
                                   m["router"], None if routes is None else routes[i][li])
                xs[i] = x + y
                used[i].append(sets)
            del w, ex
        self.last_routes = [torch.stack(u) for u in used]
        head = mm.prep(tp["lm_head"])
        return [(mm(rms_norm(x[logit_from[i]:], tp["norm"], dims.eps), head), rows[i])
                for i, x in enumerate(xs)]
