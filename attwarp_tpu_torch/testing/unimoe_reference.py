"""A plain float32 forward of Uni-MoE-2.0-Omni for one image a sequence,
for the tests to hold ``models/unimoe.py`` to.

Straight from the published description, one unpadded sequence at a time,
with no cache, no kernel and no batching, and nothing else of the port
imported (TF32 is off):

- the SigLIP tower: pixels in [0, 1] normalized by mean and std 0.5, each
  14 x 14 patch flattened (row, column, channel) and embedded with a bias,
  learned positions, pre-LN blocks of full attention with tanh-GELU MLPs,
  the hidden state after block ``layers_run``; then the linear aligner;
- the Qwen2 decoder: RMSNorm, q/k/v with biases, M-RoPE over the image's
  grid with no merge (text before the image at 0..s-1 on all three
  streams, image token (r, c) at (s, s + r, s + c), the rest from the
  largest position on), causal grouped-query attention;
- in every layer the mixture of experts, row by row: ``p = softmax(W_r
  u)``; the entries sorted by descending ``p``, ties to the lower index;
  the shortest prefix whose cumulative sum reaches ``top_p``, cut to
  ``top_k`` entries; the null entries (the last ``null`` of ``W_r``'s
  rows) dropped; ``FFN(u) = sum of the shared experts + sum over the rest
  of p_e E_e(u)``.

Departures, all of the program's layout: the weights are the port's tree
(``models/unimoe.py::random_params``), whose stacked ``gate_up`` rows are
each expert's gate rows then its up rows; the shared experts are the
tree's ``shared_*`` stack.

``hp`` holds the hyperparameters as plain values: ``vision`` (``hidden``,
``heads``, ``patch``, ``eps``, ``layers_run``), ``text`` (``hidden``,
``heads``, ``kv_heads``, ``eps``, ``rope_theta``, ``mrope_section``,
``routed``, ``null``, ``top_p``, ``top_k``) and ``image_token_id``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _lin(x, p):
    return x @ _f(p["weight"]).t() + _f(p["bias"])


def _ln(x, p, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * _f(p["weight"]) + _f(p["bias"])


def _rms(x, w, eps):
    return x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + eps) * _f(w)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _swiglu(u, gate, up, down):
    return (torch.nn.functional.silu(u @ gate.t()) * (u @ up.t())) @ down.t()


class UniMoEReference:
    def __init__(self, params: Dict[str, Any], hp: Dict[str, Any]):
        no_tf32()
        self.p, self.hp = params, hp

    # ── vision ──────────────────────────────────────────────────────
    def image_features(self, pixels01: torch.Tensor) -> torch.Tensor:
        """Images (B, S, S, 3) in [0, 1] -> aligned features (B, n, D)."""
        v, vp = self.hp["vision"], self.p["vision"]
        x = (_f(pixels01) - 0.5) / 0.5
        B, S, P, E = x.shape[0], x.shape[1], v["patch"], v["hidden"]
        n = S // P
        x = x[:, :n * P, :n * P]   # a stride-P convolution drops the rest
        patches = x.reshape(B, n, P, n, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, n * n, -1)
        h = patches @ _f(vp["patch_weight"]).t() + _f(vp["patch_bias"])
        h = h + _f(vp["position_embedding"])[None]
        H = v["heads"]
        hd = E // H
        for lp in vp["layers"][:v["layers_run"]]:
            a = _ln(h, lp["layer_norm1"], v["eps"])
            q, k, vv = (_lin(a, lp[w]).reshape(B, -1, H, hd)
                        for w in ("q_proj", "k_proj", "v_proj"))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vv).reshape(B, -1, E)
            h = h + _lin(o, lp["out_proj"])
            m = _lin(_ln(h, lp["layer_norm2"], v["eps"]), lp["fc1"])
            h = h + _lin(torch.nn.functional.gelu(m, approximate="tanh"), lp["fc2"])
        return _lin(h, self.p["aligner"])

    # ── the mixture of experts ──────────────────────────────────────
    def route(self, router: torch.Tensor, u: torch.Tensor):
        """One row ``u`` (D,) through ``router`` -> ({routed expert: p_e},
        whether the prefix held a null expert)."""
        t = self.hp["text"]
        p = torch.softmax(_f(u) @ _f(router).t(), dim=-1).tolist()
        ranked = sorted(range(len(p)), key=lambda i: (-p[i], i))
        prefix, total = [], 0.0
        for i in ranked:
            if total >= t["top_p"] or len(prefix) == t["top_k"]:
                break
            prefix.append(i)
            total += p[i]
        return ({i: p[i] for i in prefix if i < t["routed"]},
                any(i >= t["routed"] for i in prefix))

    def ffn(self, m: Dict[str, Any], u: torch.Tensor) -> torch.Tensor:
        """The FFN of a layer's ``"moe"`` tree ``m`` of rows u (n, D), row
        by row."""
        out = []
        for row in u:
            y = torch.zeros_like(row)
            for s in range(m["shared_down"].shape[0]):
                g, up = _f(m["shared_gate_up"][s]).chunk(2, dim=0)
                y = y + _swiglu(row, g, up, _f(m["shared_down"][s]))
            for e, pe in self.route(m["router"], row)[0].items():
                g, up = _f(m["gate_up"][e]).chunk(2, dim=0)
                y = y + pe * _swiglu(row, g, up, _f(m["down"][e]))
            out.append(y)
        return torch.stack(out)

    # ── the decoder ─────────────────────────────────────────────────
    def mrope(self, ids: torch.Tensor, side: int):
        """cos, sin (n, hd) of one unpadded sequence."""
        t = self.hp["text"]
        n = ids.shape[0]
        s = int((ids == self.hp["image_token_id"]).nonzero()[0, 0])
        n_img = side * side
        pos = torch.zeros((3, n), dtype=torch.float64)
        pos[:, :s] = torch.arange(s)
        i = torch.arange(n_img)
        pos[0, s:s + n_img] = s
        pos[1, s:s + n_img] = s + (i // side).double()
        pos[2, s:s + n_img] = s + (i % side).double()
        pos[:, s + n_img:] = pos[:, s:s + n_img].max() + 1 + torch.arange(n - s - n_img)
        hd = t["hidden"] // t["heads"]
        inv = 1.0 / (t["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd))
        emb = torch.cat([pos[..., None] * inv] * 2, dim=-1)          # (3, n, hd)
        cs, sn, off = [], [], 0
        for j, w in enumerate(list(t["mrope_section"]) * 2):
            cs.append(torch.cos(emb[j % 3, :, off:off + w]))
            sn.append(torch.sin(emb[j % 3, :, off:off + w]))
            off += w
        return torch.cat(cs, -1).float(), torch.cat(sn, -1).float()

    def forward(self, ids_list: List[torch.Tensor], feats: torch.Tensor,
                logit_from: List[int], row_layer: Optional[int] = None,
                row_from: Optional[List[int]] = None):
        """Each sequence ``ids_list[i]`` (prompt and fed tokens, on the
        CPU) with image ``feats[i]`` (n_img, D): (logits (n - logit_from[i],
        vocab) of the positions from ``logit_from[i]`` on, and with
        ``row_layer`` that layer's attention rows (n - row_from[i], H, n) of
        the queries from ``row_from[i]`` on)."""
        t, tp = self.hp["text"], self.p["text"]
        H, kvH, eps = t["heads"], t["kv_heads"], t["eps"]
        hd = t["hidden"] // H
        side = int(math.isqrt(feats.shape[1]))
        out = []
        for i, ids in enumerate(ids_list):
            x = _f(tp["embed_tokens"])[ids]
            at = (ids == self.hp["image_token_id"]).nonzero()[:, 0]
            x[at] = _f(feats[i])
            cos, sin = self.mrope(ids, side)
            n = x.shape[0]
            rows = None
            for li, lp in enumerate(tp["layers"]):
                h = _rms(x, lp["input_layernorm"], eps)
                q = _lin(h, lp["q_proj"]).reshape(n, H, hd)
                k = _lin(h, lp["k_proj"]).reshape(n, kvH, hd)
                v = _lin(h, lp["v_proj"]).reshape(n, kvH, hd)
                q = q * cos[:, None] + _rotate_half(q) * sin[:, None]
                k = k * cos[:, None] + _rotate_half(k) * sin[:, None]
                k, v = (z.repeat_interleave(H // kvH, dim=1) for z in (k, v))
                s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
                s = s.masked_fill(~torch.ones((n, n), dtype=torch.bool).tril(), float("-inf"))
                pr = torch.softmax(s, dim=-1)
                if li == row_layer:
                    rows = pr[:, row_from[i]:].permute(1, 0, 2)
                x = x + torch.einsum("hqk,khd->qhd", pr, v).reshape(n, -1) @ _f(lp["o_proj"]).t()
                x = x + self.ffn(lp["moe"], _rms(x, lp["post_attention_layernorm"], eps))
            h = _rms(x[logit_from[i]:], tp["norm"], eps)
            out.append((h @ _f(tp["lm_head"]).t(), rows))
        return out
