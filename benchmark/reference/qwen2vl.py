"""Plain Qwen2-VL for the benchmark's check (HF ``Qwen2VLForConditional
Generation``, one image a sequence): the vision tower (3-D patch embedding
of an image repeated over the temporal pair, 2-D rotary embeddings over the
merge-ordered patch grid, pre-LN blocks of full attention with QuickGELU
MLPs, the 2x2 patch merger) and the Qwen2 decoder of
``reference/decoder.py`` (q/k/v biases) under M-RoPE. Reads the weights as
the benchmark made them; imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from benchmark.reference.decoder import Dims, Matmul, decoder_forward, no_tf32, rotate_half, splice
from benchmark.reference.llava import clip_normalize


def _ln(x, p, eps=1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["weight"].float() + p["bias"].float()


class Qwen2VLReference:
    def __init__(self, c: Dict[str, Any], params: Dict[str, Any], precision: str = "f32"):
        no_tf32()
        self.c, self.p = c, params
        self.mm = Matmul(precision)
        self.dims = Dims(c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"],
                         c["rms_norm_eps"])

    def _patches(self, x: torch.Tensor):
        """(S, S, 3) normalized -> (N, C*T*P*P) in the merge-ordered layout
        of HF's image processor, and the patch grid (gh, gw)."""
        v = self.c["vision_config"]
        P, M, T = v["patch_size"], v["spatial_merge_size"], v["temporal_patch_size"]
        H, W, C = x.shape
        gh, gw = H // P, W // P
        t = x.permute(2, 0, 1)[None].expand(T, C, H, W)
        t = t.reshape(T, C, gh // M, M, P, gw // M, M, P).permute(2, 5, 3, 6, 1, 0, 4, 7)
        return t.reshape(gh * gw, C * T * P * P), (gh, gw)

    def _rot(self, gh: int, gw: int, device):
        v = self.c["vision_config"]
        M, hd = v["spatial_merge_size"], v["embed_dim"] // v["num_heads"]
        h = torch.arange(gh, device=device)[:, None].expand(gh, gw)
        w = torch.arange(gw, device=device)[None, :].expand(gh, gw)

        def merged(a):
            return a.reshape(gh // M, M, gw // M, M).permute(0, 2, 1, 3).reshape(-1)

        dim = hd // 2
        inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim))
        f = torch.cat([merged(h).double()[:, None] * inv, merged(w).double()[:, None] * inv], -1)
        emb = torch.cat([f, f], dim=-1)
        return torch.cos(emb).float()[:, None], torch.sin(emb).float()[:, None]

    def image_features(self, pixels01: torch.Tensor) -> torch.Tensor:
        """Images (B, S, S, 3) in [0, 1] -> merged features (B, n_img, D)."""
        v, mm, vp = self.c["vision_config"], self.mm, self.p["vision"]
        E, H = v["embed_dim"], v["num_heads"]
        hd = E // H
        out = []
        for img in clip_normalize(pixels01):
            patches, (gh, gw) = self._patches(img)
            x = mm(patches, mm.prep(vp["patch_weight"]))
            cos, sin = self._rot(gh, gw, x.device)
            for blk in vp["blocks"]:
                qkv = mm(_ln(x, blk["norm1"]), mm.prep(blk["qkv"]["weight"]), blk["qkv"]["bias"])
                q, k, vv = qkv.reshape(-1, 3, H, hd).unbind(1)
                q = q * cos + rotate_half(q) * sin
                k = k * cos + rotate_half(k) * sin
                s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
                o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), vv).reshape(-1, E)
                del s
                x = x + mm(o, mm.prep(blk["proj"]["weight"]), blk["proj"]["bias"])
                f = mm(_ln(x, blk["norm2"]), mm.prep(blk["fc1"]["weight"]), blk["fc1"]["bias"])
                x = x + mm(f * torch.sigmoid(1.702 * f), mm.prep(blk["fc2"]["weight"]),
                           blk["fc2"]["bias"])
            mg = vp["merger"]
            y = _ln(x, mg["ln_q"]).reshape(-1, E * v["spatial_merge_size"] ** 2)
            y = torch.nn.functional.gelu(mm(y, mm.prep(mg["fc1"]["weight"]), mg["fc1"]["bias"]))
            out.append(mm(y, mm.prep(mg["fc2"]["weight"]), mg["fc2"]["bias"]))
        return torch.stack(out)

    def mrope(self, ids: torch.Tensor, n_img: int, side_w: int):
        """cos, sin (n, hd) of one unpadded sequence under M-RoPE: text
        before the image at 0..s-1 on all three streams, the image's tokens
        at (s, s + row, s + column), the rest continuing from the largest
        position."""
        n = ids.shape[0]
        s = int((ids == self.c["image_token_id"]).nonzero()[0, 0])
        pos = torch.zeros((3, n), dtype=torch.float64, device=ids.device)
        pos[:, :s] = torch.arange(s, device=ids.device)
        i = torch.arange(n_img, device=ids.device)
        pos[0, s:s + n_img] = s
        pos[1, s:s + n_img] = s + (i // side_w).double()
        pos[2, s:s + n_img] = s + (i % side_w).double()
        nxt = pos[:, s:s + n_img].max() + 1
        pos[:, s + n_img:] = nxt + torch.arange(n - s - n_img, device=ids.device)
        hd = self.dims.head_dim
        inv = 1.0 / (self.c["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                                           device=ids.device) / hd))
        f = pos[..., None] * inv                       # (3, n, hd/2)
        emb = torch.cat([f, f], dim=-1)                # (3, n, hd)
        sec = list(self.c["rope_scaling"]["mrope_section"]) * 2
        cs, sn, off = [], [], 0
        for j, w in enumerate(sec):
            cs.append(torch.cos(emb[j % 3, :, off:off + w]))
            sn.append(torch.sin(emb[j % 3, :, off:off + w]))
            off += w
        return torch.cat(cs, -1).float(), torch.cat(sn, -1).float()

    def forward(self, ids_list: List[torch.Tensor], feats: torch.Tensor, logit_from: List[int],
                row_layer=None, row_from=None):
        """As ``LlavaReference.forward``."""
        tp = self.p["text"]
        n_img = feats.shape[1]
        side_w = int(math.isqrt(n_img))
        xs, tables = [], []
        for i, ids in enumerate(ids_list):
            xs.append(splice(tp["embed_tokens"], ids, self.c["image_token_id"], feats[i]))
            tables.append(self.mrope(ids, n_img, side_w))
        return decoder_forward(tp["layers"], tp["norm"], tp["lm_head"], self.dims, xs, tables,
                               logit_from, self.mm, row_layer, row_from)
