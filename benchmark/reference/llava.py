"""Plain LLaVA-1.5 for the benchmark's check: CLIP ViT (pre-LN, QuickGELU,
class token, learned positions) to its second-to-last layer, the two-layer
GELU projector, and the LLaMA decoder of ``reference/decoder.py``. Reads
the weights as the benchmark made them; imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from benchmark.reference.decoder import Dims, Matmul, decoder_forward, no_tf32, rope_tables, splice

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(pixels01: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) in [0, 1] -> CLIP-normalized float32."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=pixels01.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=pixels01.device)
    return (pixels01.to(torch.float32) - mean) / std


def _ln(x, p, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["weight"].float() + p["bias"].float()


class LlavaReference:
    def __init__(self, c: Dict[str, Any], params: Dict[str, Any], precision: str = "f32"):
        no_tf32()
        self.c, self.p = c, params
        self.mm = Matmul(precision)
        t = c["text_config"]
        self.dims = Dims(t["hidden_size"], t["num_attention_heads"],
                         t["num_key_value_heads"], t["rms_norm_eps"])

    def image_features(self, pixels01: torch.Tensor) -> torch.Tensor:
        """Images (B, S, S, 3) in [0, 1] -> projected features (B, n_img, D)."""
        v, mm = self.c["vision_config"], self.mm
        vp = self.p["vision"]
        x = clip_normalize(pixels01)
        B, S = x.shape[0], x.shape[1]
        P, Dv, H = v["patch_size"], v["hidden_size"], v["num_attention_heads"]
        n = S // P
        patches = x.reshape(B, n, P, n, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, n * n, P * P * 3)
        h = mm(patches, mm.prep(vp["patch_weight"]))
        cls = vp["class_embedding"].float().expand(B, 1, Dv)
        h = torch.cat([cls, h], dim=1) + vp["position_embedding"].float()[None]
        eps = v["layer_norm_eps"]
        h = _ln(h, vp["pre_layrnorm"], eps)
        run = self.c["vision_feature_layer"] % (v["num_hidden_layers"] + 1)
        hd = Dv // H
        for lp in vp["layers"][:run]:
            W = {k: mm.prep(lp[k]["weight"]) for k in ("q_proj", "k_proj", "v_proj",
                                                       "out_proj", "fc1", "fc2")}
            a = _ln(h, lp["layer_norm1"], eps)
            q, k, vv = (mm(a, W[n_], lp[n_]["bias"]).reshape(B, -1, H, hd)
                        for n_ in ("q_proj", "k_proj", "v_proj"))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vv).reshape(B, -1, Dv)
            h = h + mm(o, W["out_proj"], lp["out_proj"]["bias"])
            f = mm(_ln(h, lp["layer_norm2"], eps), W["fc1"], lp["fc1"]["bias"])
            h = h + mm(f * torch.sigmoid(1.702 * f), W["fc2"], lp["fc2"]["bias"])
        feats = h[:, 1:]
        pr = self.p["projector"]
        y = torch.nn.functional.gelu(mm(feats, mm.prep(pr["linear_1"]["weight"]),
                                        pr["linear_1"]["bias"]))
        return mm(y, mm.prep(pr["linear_2"]["weight"]), pr["linear_2"]["bias"])

    def forward(self, ids_list: List[torch.Tensor], feats: torch.Tensor, logit_from: List[int],
                row_layer=None, row_from=None):
        """Each unpadded sequence ``ids_list[i]`` (prompt and served tokens)
        with image ``feats[i]``: (logits from ``logit_from[i]``, the
        ``row_layer`` attention rows from ``row_from[i]``), as
        ``decoder_forward``. Rotary positions count from 0."""
        lm = self.p["llama"]
        t = self.c["text_config"]
        xs, tables = [], []
        for i, ids in enumerate(ids_list):
            xs.append(splice(lm["embed_tokens"], ids, self.c["image_token_index"], feats[i]))
            pos = torch.arange(ids.shape[0], device=ids.device)
            tables.append(rope_tables(pos, self.dims.head_dim, t["rope_theta"]))
        return decoder_forward(lm["layers"], lm["norm"], lm["lm_head"], self.dims, xs, tables,
                               logit_from, self.mm, row_layer, row_from)
