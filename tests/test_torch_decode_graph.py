"""The decode step as segments split at the attention calls, the pool of
KV caches, the cached rotary ``inv_freq``, and on the card the step
replayed from CUDA graphs (``models/decode_graph.py``).

On the CPU the segmented step runs eagerly and must equal the decode step
as it was written before it was split (``_unsplit_decode_step``, a copy
kept here) bit for bit. The tests marked ``cuda`` replay the graphs on the
card against the same segments run eagerly, at the mini widths of both
families (head_dim 128, the one K3 takes). This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graph.py -q
"""

import json

import numpy as np
import pytest
import torch

from attwarp_tpu_torch.models import decode_graph, llama, qwen2vl
from attwarp_tpu_torch.models.llama import (
    LlamaConfig,
    QuantKVCache,
    _attn,
    _attn_quantcache,
    _check_layer,
    _qkv,
    _stack_rows,
    append_token,
    attend_cache,
    decoder_decode_step,
    final_logits,
    init_kv_cache,
    init_quant_kv_cache,
    layer_residuals,
    rope_cos_sin,
)
from attwarp_tpu_torch.parallel.comm import SOLO, ModelShard
from attwarp_tpu_torch.utils import profiling


def _unsplit_decode_step(params, cfg, token_embeds, kv, cur_len, cos, sin, kv_mask,
                         extract_layer=None):
    """``decoder_decode_step`` as it was before the step was split into
    segments: one loop over the layers."""
    want = _check_layer(extract_layer, cfg)
    at = ((slice(None), cur_len) if isinstance(cur_len, int) else
          (torch.arange(token_embeds.shape[0], device=token_embeds.device), cur_len))
    x = token_embeds
    rows = {}
    for i, lp in enumerate(params["layers"]):
        q, k1, v1 = _qkv(lp, cfg, x, cos, sin)
        append_token(kv, i, at, k1[:, 0], v1[:, 0])
        if i not in want:
            attn = attend_cache(kv, i, q, kv_mask, cfg)
        elif isinstance(kv, QuantKVCache):
            attn, rows[i] = _attn_quantcache(
                q, kv.k_q[i], kv.k_s[i], kv.v_q[i], kv.v_s[i],
                kv_mask[:, None, :], cfg, want_probs=True)
        else:
            attn, rows[i] = _attn(q, kv.k[i], kv.v[i], kv_mask[:, None, :], cfg,
                                  want_probs=True)
        x = layer_residuals(lp, cfg, x, attn)
    return final_logits(params, cfg, x[:, 0]), kv, _stack_rows(rows, extract_layer, params)


def _decoder_tree(cfg, g, dtype=torch.float32, device="cpu", bias=False):
    """Random decoder weights (LLaMA's tree; Qwen2's q/k/v with biases)."""
    D, F, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    kvd = cfg.num_key_value_heads * hd if cfg.num_key_value_heads else D

    def r(*shape, std=0.05):
        return (torch.randn(shape, generator=g) * std).to(device=device, dtype=dtype)

    def lin(n_out, n_in):
        return {"weight": r(n_out, n_in), "bias": r(n_out)} if bias else r(n_out, n_in)

    return {
        "embed_tokens": r(cfg.vocab_size, D, std=0.5),
        "norm": 1.0 + r(D),
        "lm_head": r(cfg.vocab_size, D),
        "layers": [{
            "input_layernorm": 1.0 + r(D), "post_attention_layernorm": 1.0 + r(D),
            "q_proj": lin(D, D), "k_proj": lin(kvd, D), "v_proj": lin(kvd, D),
            "o_proj": r(D, D), "gate_proj": r(F, D), "up_proj": r(F, D), "down_proj": r(D, F),
        } for _ in range(cfg.num_hidden_layers)],
    }


LLAMA22 = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=22,
                      num_attention_heads=4)
QWEN4 = qwen2vl.Qwen2VLTextConfig(vocab_size=64, hidden_size=48, intermediate_size=64,
                                  num_hidden_layers=4, num_attention_heads=4,
                                  num_key_value_heads=2, rope_theta=10000.0,
                                  mrope_section=(2, 2, 2))

# (name, family, cache, extract spec, per-slot positions, tensor-parallel tree)
STEP_CASES = [
    ("llama-mha-int8-layer20", "llama", "int8", 20, False, False),
    ("llama-mha-int8-none", "llama", "int8", None, False, False),
    ("llama-mha-int8-sequence", "llama", "int8", (20, 3, 7), False, False),
    ("qwen-gqa-mrope-int8", "qwen", "int8", 1, False, False),
    ("llama-dense", "llama", "dense", 2, False, False),
    ("llama-int8-per-slot", "llama", "int8", 5, True, False),
    ("llama-int8-tp-tree", "llama", "int8", 4, False, True),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_segmented_step_equals_unsplit_step(case):
    """Four steps of the segmented step against the unsplit one, each on
    its own copy of one prefilled cache: logits, rows and every cache
    tensor bit for bit, and every step counted as eager."""
    _, family, cache, spec, per_slot, tp = case
    cfg = LLAMA22 if family == "llama" else QWEN4
    g = torch.Generator().manual_seed(7)
    params = _decoder_tree(cfg, g, bias=family == "qwen")
    if tp:   # a rank's tree on a one-rank model axis: the collective paths, eagerly
        params = dict(params, tp=ModelShard(SOLO, kv_heads=cfg.kv_heads, attn=True, mlp=True),
                      layers=[dict(lp, tp=ModelShard(SOLO, attn=True, mlp=True))
                              for lp in params["layers"]])
    B, S, T = 3, 24, 9
    if cache == "int8":
        kv0 = init_quant_kv_cache(cfg, B, S, "cpu")
        for t in (kv0.k_q, kv0.v_q):
            t[:, :, :T] = torch.randint(-127, 128, t[:, :, :T].shape, generator=g,
                                        dtype=torch.int8)
        for t in (kv0.k_s, kv0.v_s):
            t[:, :, :T] = torch.rand(t[:, :, :T].shape, generator=g) * 0.02
    else:
        kv0 = init_kv_cache(cfg, B, S, torch.float32, "cpu")
        for t in kv0:
            t[:, :, :T] = torch.randn(t[:, :, :T].shape, generator=g)
    mask = torch.zeros((B, S), dtype=torch.bool)
    mask[:, :T] = True
    mask[0, :2] = False   # a left-padded row
    kvs = [type(kv0)(*(t.clone() for t in kv0)) for _ in range(2)]
    steps = 4
    with profiling.tracing() as rec:
        for step in range(steps):
            cur = T + step
            mask[:, cur] = True
            pos = torch.tensor([cur - 2, cur, cur]) + 3
            if family == "llama":
                cos, sin = rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta)
            else:
                cos, sin = qwen2vl.mrope_cos_sin(pos[None, :, None].expand(3, B, 1), cfg)
            emb = torch.randn((B, 1, cfg.hidden_size), generator=g)
            cur_len = torch.tensor([cur, cur - 1, cur]) if per_slot else cur
            got = decoder_decode_step(params, cfg, emb, kvs[0], cur_len, cos, sin, mask,
                                      extract_layer=spec)
            want = _unsplit_decode_step(params, cfg, emb, kvs[1], cur_len, cos, sin, mask,
                                        extract_layer=spec)
            assert torch.equal(got[0], want[0])
            assert (got[2] is None) == (spec is None)
            if spec is not None:
                assert torch.equal(got[2], want[2])
            for a, b in zip(*kvs):
                assert torch.equal(a, b)
    assert rec.counters.get("decode_graph.eager") == steps
    assert "decode_graph.replays" not in rec.counters
    assert "decode_graph.captures" not in rec.counters


@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_rope_inv_freq_made_once_with_the_same_values(family):
    """The rotary tables from the cached ``inv_freq`` equal those of the
    frequencies computed afresh, as both functions computed them before,
    and a second call reuses the first's tensor."""
    pos = torch.arange(40)[None, :].expand(2, -1)
    if family == "llama":
        hd, theta = 128, 10000.0
        cos, sin = rope_cos_sin(pos, hd, theta)
    else:
        cfg = qwen2vl.Qwen2VLTextConfig(hidden_size=256, num_attention_heads=2)
        hd, theta = cfg.head_dim, cfg.rope_theta
        cos, sin = qwen2vl.mrope_cos_sin(pos[None].expand(3, -1, -1), cfg)
    inv = torch.as_tensor(1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd)),
                          dtype=torch.float32)
    emb = torch.cat([pos[..., None].float() * inv] * 2, dim=-1)
    assert torch.equal(cos, torch.cos(emb)) and torch.equal(sin, torch.sin(emb))
    assert llama.rope_inv_freq(hd, theta, pos.device) is llama.rope_inv_freq(
        hd, theta, pos.device)


@pytest.mark.parametrize("cache,dtype", [("int8", torch.bfloat16), ("int8", torch.float32),
                                         ("dense", torch.float32)])
def test_attention_writes_into_out(cache, dtype):
    """``attend_cache``'s ``out`` (the graphs' static buffer): K3's entry, or
    the dense cache's attention, writes its result there, equal to the
    result it returns without one."""
    cfg = LlamaConfig(vocab_size=16, hidden_size=256, intermediate_size=8, num_hidden_layers=2,
                      num_attention_heads=2)
    g = torch.Generator().manual_seed(1)
    if cache == "int8":
        kv = init_quant_kv_cache(cfg, 2, 16, "cpu")
        for t in (kv.k_q, kv.v_q):
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
        for t in (kv.k_s, kv.v_s):
            t.copy_(torch.rand(t.shape, generator=g) * 0.02)
    else:
        kv = init_kv_cache(cfg, 2, 16, dtype, "cpu")
        for t in kv:
            t.copy_(torch.randn(t.shape, generator=g))
    q = torch.randn((2, 1, 2, 128), generator=g).to(dtype)
    mask = torch.ones((2, 16), dtype=torch.bool)
    mask[0, :5] = False
    out = torch.empty((2, 1, 256), dtype=dtype)
    got = attend_cache(kv, 1, q, mask, cfg, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, attend_cache(kv, 1, q, mask, cfg))


def test_pool_lends_one_owner_at_a_time_and_zeros_every_lease():
    """Two live owners of one shape get different buffers; a released cache
    that carries a live tree's graphs goes to the next owner, zeroed; one
    whose trees are gone is freed; a cache the pool did not lend is not
    taken back, and a step over it on the CPU finds no graphs."""
    cfg = LlamaConfig(vocab_size=16, hidden_size=8, intermediate_size=8, num_hidden_layers=2,
                      num_attention_heads=2)
    a = llama.lease_kv_cache(cfg, 2, 8, "cpu", 2)
    b = llama.lease_kv_cache(cfg, 2, 8, "cpu", 2)
    assert isinstance(a, QuantKVCache)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a, b))
    for t in a:
        t.fill_(3)
    entry = decode_graph.KV_POOL.entry(a)
    tree_leaf = torch.ones(1)   # a live tree that has graphs over ``a``
    entry.graphs["key"] = decode_graph.DecodeGraphs([tree_leaf])
    llama.release_kv_cache(a)
    assert decode_graph.KV_POOL.entry(a) is None
    c = llama.lease_kv_cache(cfg, 2, 8, "cpu", 2)
    assert all(x is y for x, y in zip(a, c))
    assert all(not t.any() for t in c)
    llama.release_kv_cache(c)
    del tree_leaf   # the tree is gone: its graphs and the cache are dropped
    d = llama.lease_kv_cache(cfg, 2, 8, "cpu", 2)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a, d)) and not d.k_q.any()
    dense = llama.lease_kv_cache(cfg, 2, 8, "cpu", 2, torch.float32)
    assert type(dense) is llama.LlamaKVCache and dense.k.dtype == torch.float32
    own = init_quant_kv_cache(cfg, 2, 8, "cpu")
    llama.release_kv_cache(own)
    assert decode_graph.KV_POOL.entry(own) is None
    assert decode_graph.graphs_for({"layers": []}, d, torch.zeros(1), ()) is None
    for kv in (b, d, dense):
        llama.release_kv_cache(kv)


# ── on the card ─────────────────────────────────────────────────────────

MINI_LLAVA = dict(vocab_size=128, hidden_size=256, intermediate_size=512, num_hidden_layers=3,
                  num_attention_heads=2)
MINI_QWEN = dict(vocab_size=160, hidden_size=256, intermediate_size=512, num_hidden_layers=3,
                 num_attention_heads=2, num_key_value_heads=1, rope_theta=1000000.0,
                 mrope_section=(16, 24, 24))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernel K3; no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mini_model(family, dev):
    from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig
    from attwarp_tpu_torch.models.llava import LlavaConfig, LlavaModel, random_params

    g = torch.Generator(device=dev).manual_seed(3)
    if family == "llava":
        cfg = LlavaConfig(vision=ClipVisionConfig(hidden_size=32, intermediate_size=64,
                                                  num_hidden_layers=2, num_attention_heads=2,
                                                  image_size=28, patch_size=14),
                          text=LlamaConfig(**MINI_LLAVA), image_token_index=100,
                          pad_token_id=101, eos_token_id=127)
        return LlavaModel(cfg, random_params(cfg, g, dev))
    cfg = qwen2vl.Qwen2VLConfig(
        vision=qwen2vl.Qwen2VLVisionConfig(depth=2, embed_dim=32, hidden_size=256, num_heads=2,
                                           mlp_ratio=2),
        text=qwen2vl.Qwen2VLTextConfig(**MINI_QWEN), image_token_id=150,
        vision_start_token_id=151, vision_end_token_id=152, pad_token_id=153, eos_token_id=159)
    return qwen2vl.Qwen2VLModel(cfg, qwen2vl.random_params(cfg, g, dev))


def _generate(model, family, dev, extract_layer, steps=20, seed=0):
    """A batch of two left-padded image prompts through the generate loop."""
    g = np.random.default_rng(seed)
    cfg = model.cfg
    B = 2
    if family == "llava":
        n_img, img_tok = cfg.num_image_tokens, cfg.image_token_index
    else:
        grid = (1, 4, 4)
        n_img, img_tok = 4, cfg.image_token_id
    T = 64
    ids = np.full((B, T), cfg.pad_token_id, np.int64)
    mask = np.zeros((B, T), bool)
    for b, n in enumerate((50, 37)):
        row = g.integers(0, 90, n)
        row[5:5 + n_img] = img_tok
        if family == "qwen":
            row[4] = cfg.vision_start_token_id
        ids[b, T - n:] = row
        mask[b, T - n:] = True
    ids_t = torch.as_tensor(ids, device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    kw = dict(extract_layer=extract_layer, max_new_tokens=steps, kv_quant=True)
    if family == "llava":
        px = torch.as_tensor(g.standard_normal((B, 28, 28, 3)), dtype=torch.float32, device=dev)
        starts = torch.as_tensor(np.argmax(ids == img_tok, axis=1), device=dev)
        return model.generate_with_attention(ids_t, px, mask_t, starts, **kw)
    c = cfg.vision
    patches = torch.as_tensor(
        g.standard_normal((16, c.in_channels * c.temporal_patch_size * c.patch_size ** 2)),
        dtype=torch.float32, device=dev)
    return model.generate_with_attention(ids_t, patches, grid, mask_t, **kw)


def _eager(monkeypatch):
    monkeypatch.setattr(decode_graph, "graphs_for", lambda *a, **k: None)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["llava", "qwen"])
def test_replayed_steps_match_eager_segments(cuda, family, monkeypatch):
    """20 steps over a leased cache (replayed after the first) against the
    same segments run eagerly over a cache of their own: logits and rows
    within bf16 rounding, the caches equal, and K3's Python entry called
    once per unlisted layer per step in both."""
    model = _mini_model(family, cuda)
    tcfg = model.cfg.text
    params = model.params["llama" if family == "llava" else "text"]
    g = torch.Generator(device=cuda).manual_seed(5)
    B, S, T, steps, spec = 3, 128, 40, 20, 1
    calls = {"n": 0}
    inner = llama.decode_attn_int8

    def counted(*a, **k):
        calls["n"] += 1
        return inner(*a, **k)
    monkeypatch.setattr(llama, "decode_attn_int8", counted)
    embeds = torch.randn((B, T, tcfg.hidden_size), generator=g, device=cuda,
                         dtype=torch.bfloat16)
    amask = torch.ones((B, T), dtype=torch.bool, device=cuda)
    amask[1, :7] = False
    pos = torch.clamp(torch.cumsum(amask.long(), 1) - 1, min=0)
    if family == "llava":
        cos, sin = rope_cos_sin(pos, tcfg.head_dim, tcfg.rope_theta)
    else:
        cos, sin = qwen2vl.mrope_cos_sin(pos[None].expand(3, -1, -1), tcfg)
    toks = torch.randint(0, tcfg.vocab_size, (steps, B), generator=g, device=cuda)
    runs = []
    for leased in (True, False):
        kv = (llama.lease_kv_cache(tcfg, B, S, cuda, tcfg.num_key_value_heads or
                                   tcfg.num_attention_heads) if leased else
              init_quant_kv_cache(tcfg, B, S, cuda,
                                  tcfg.num_key_value_heads or tcfg.num_attention_heads))
        llama.decoder_prefill(params, tcfg, embeds, amask, cos, sin, S, kv_quant=True, cache=kv)
        full = torch.nn.functional.pad(amask, (0, S - T))
        out = []
        calls["n"] = 0
        with profiling.tracing() as rec:
            for step in range(steps):
                full[:, T + step] = True
                p = (amask.sum(1) + step)[:, None]
                if family == "llava":
                    c1, s1 = rope_cos_sin(p, tcfg.head_dim, tcfg.rope_theta)
                else:
                    c1, s1 = qwen2vl.mrope_cos_sin(p[None].expand(3, -1, -1), tcfg)
                emb = llama.embed(params, toks[step])[:, None, :]
                logits, _, row = decoder_decode_step(params, tcfg, emb, kv, T + step, c1, s1,
                                                     full, extract_layer=spec)
                out.append((logits, row))
        torch.cuda.synchronize()
        assert calls["n"] == (tcfg.num_hidden_layers - 1) * steps
        runs.append((out, [t.clone() for t in kv], rec.counters))
        if leased:
            llama.release_kv_cache(kv)
    (graphed, kv_g, c_g), (eager, kv_e, c_e) = runs
    assert c_g.get("decode_graph.captures") == 1
    assert c_g.get("decode_graph.replays") == steps - 1 and c_g.get("decode_graph.eager") == 1
    assert c_e.get("decode_graph.eager") == steps and "decode_graph.replays" not in c_e
    for (lg, rg), (le, re) in zip(graphed, eager):
        torch.testing.assert_close(lg, le, rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(rg, re, rtol=1e-2, atol=1e-3)
        assert torch.equal(lg.argmax(-1), le.argmax(-1))
    for a, b in zip(kv_g, kv_e):
        assert (a.float() - b.float()).abs().max().item() <= (1 if a.dtype == torch.int8
                                                               else 1e-3)



@pytest.mark.cuda
@pytest.mark.parametrize("family", ["llava", "qwen"])
def test_replayed_steps_equal_eager_steps_through_k5(cuda, family, monkeypatch):
    """Kernel K5 writes every layer's new token in both forms of the step:
    eight steps replayed from the graphs (after the first, eager) against
    the same steps run eagerly over a cache of their own, from one prefill,
    give the same logits, rows and caches bit for bit. K5's launches are
    layers x steps in both (a replay's counted through
    ``REPLAYED_COUNTERS``), and the eager rotary and append never run on
    the card's int8 cache."""
    from attwarp_tpu_torch.kernels.rope_append import rope_append_int8

    model = _mini_model(family, cuda)
    tcfg = model.cfg.text
    params = model.params["llama" if family == "llava" else "text"]
    g = torch.Generator(device=cuda).manual_seed(6)
    B, S, T, steps, spec, L = 3, 128, 40, 8, 1, tcfg.num_hidden_layers
    kvh = tcfg.num_key_value_heads or tcfg.num_attention_heads
    embeds = torch.randn((B, T, tcfg.hidden_size), generator=g, device=cuda,
                         dtype=torch.bfloat16)
    amask = torch.ones((B, T), dtype=torch.bool, device=cuda)
    amask[1, :7] = False
    pos = torch.clamp(torch.cumsum(amask.long(), 1) - 1, min=0)
    if family == "llava":
        cos, sin = rope_cos_sin(pos, tcfg.head_dim, tcfg.rope_theta)
    else:
        cos, sin = qwen2vl.mrope_cos_sin(pos[None].expand(3, -1, -1), tcfg)
    toks = torch.randint(0, tcfg.vocab_size, (steps, B), generator=g, device=cuda)
    leased = llama.lease_kv_cache(tcfg, B, S, cuda, kvh)
    own = init_quant_kv_cache(tcfg, B, S, cuda, kvh)
    try:
        for kv in (leased, own):
            llama.decoder_prefill(params, tcfg, embeds, amask, cos, sin, S, kv_quant=True,
                                  cache=kv)

        def refused(*a, **k):
            raise AssertionError("the eager rotary or append ran on the card's int8 cache")
        monkeypatch.setattr(llama, "apply_rope", refused)
        monkeypatch.setattr(llama, "append_token", refused)
        full = torch.nn.functional.pad(amask, (0, S - T))
        launches = {}
        with profiling.tracing() as rec:
            for step in range(steps):
                full[:, T + step] = True
                p = (amask.sum(1) + step)[:, None]
                if family == "llava":
                    c1, s1 = rope_cos_sin(p, tcfg.head_dim, tcfg.rope_theta)
                else:
                    c1, s1 = qwen2vl.mrope_cos_sin(p[None].expand(3, -1, -1), tcfg)
                emb = llama.embed(params, toks[step])[:, None, :]
                outs = []
                for kv in (leased, own):
                    n = rope_append_int8.launches
                    outs.append(decoder_decode_step(params, tcfg, emb, kv, T + step, c1, s1,
                                                    full, extract_layer=spec))
                    launches[kv is leased] = launches.get(kv is leased, 0) + (
                        rope_append_int8.launches - n)
                torch.cuda.synchronize()
                (lg, _, rg), (le, _, re) = outs
                assert torch.equal(lg, le) and torch.equal(rg, re), step
                for a, b in zip(leased, own):
                    assert torch.equal(a, b), step
        assert rec.counters.get("decode_graph.replays") == steps - 1
        assert launches == {True: L * steps, False: L * steps}
    finally:
        llama.release_kv_cache(leased)

@pytest.mark.cuda
@pytest.mark.parametrize("family", ["llava", "qwen"])
def test_graphs_captured_once_per_key_across_calls_and_engines(cuda, family, monkeypatch):
    """Two generate calls of one shape and spec capture once and replay
    every step of the second; their tokens and maps equal the eager loop's
    (maps within bf16 rounding). Two ``ServeEngine``s of one shape, one
    after the other, capture once between them, and a tensor-parallel tree
    never engages the graphs."""
    from attwarp_tpu_torch.serving import ServeEngine

    model = _mini_model(family, cuda)
    steps = 20
    with profiling.tracing() as rec:
        first = _generate(model, family, cuda, 1, steps)
        second = _generate(model, family, cuda, 1, steps)
        torch.cuda.synchronize()
    assert rec.counters.get("decode_graph.captures") == 1
    assert rec.counters.get("decode_graph.replays") == 2 * steps - 1
    assert rec.counters.get("decode_graph.eager") == 1
    with monkeypatch.context() as m:
        _eager(m)
        eager = _generate(model, family, cuda, 1, steps)
    for got in (first, second):
        assert torch.equal(got[0], eager[0])
        torch.testing.assert_close(got[1], eager[1], rtol=1e-2, atol=1e-4)

    text = "llama" if family == "llava" else "text"
    ids = np.arange(3, 40) % 90
    results, decode_steps = [], 0
    with profiling.tracing() as rec:
        for _ in range(2):
            eng = ServeEngine(model, slots=2, max_seq=192, kv_quant=True, steps_per_tick=4)
            for _ in range(3):
                eng.submit(ids, None, max_new_tokens=9)
            results.append(eng.run())
            decode_steps += eng.decode_steps
            del eng   # gives its cache back to the pool
    assert results[0] == results[1]
    assert rec.counters.get("decode_graph.captures") == 1
    assert rec.counters.get("decode_graph.eager") == 1
    assert rec.counters.get("decode_graph.replays") == decode_steps - 1

    tp = dict(model.params[text], tp=ModelShard(SOLO, kv_heads=model.cfg.text.num_key_value_heads
                                                or model.cfg.text.num_attention_heads))
    kv = llama.lease_kv_cache(model.cfg.text, 2, 64, cuda, tp["tp"].kv_heads)
    try:
        assert decode_graph.graphs_for(tp, kv, kv.k_s, ()) is None
        assert decode_graph.graphs_for(model.params[text], kv, kv.k_s, ()) is not None
    finally:
        llama.release_kv_cache(kv)


@pytest.mark.cuda
def test_no_host_copy_and_replays_attributed_inside_decode_steps(cuda, tmp_path):
    """Under ``torch.profiler``: no host-to-device copy is launched inside a
    ``decode_step`` span, and the kernels of the replayed graphs carry the
    correlation id of a graph launch inside the span (what the benchmark's
    ``decode_step_ms`` and ``decode_idle_pct`` read)."""
    model = _mini_model("llava", cuda)
    _generate(model, "llava", cuda, 1, 4)   # capture outside the trace
    torch.cuda.synchronize()
    with profiling.device_trace(tmp_path):
        _generate(model, "llava", cuda, 1, 6)
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == "decode_step"]
    assert len(spans) == 6
    device = {}   # correlation id -> the device operations it launched
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.setdefault((e.get("args") or {}).get("correlation"), []).append(e)
    launched = {i: [] for i in range(len(spans))}   # span -> (launch name, device op)
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        ops = device.get((e.get("args") or {}).get("correlation"), [])
        for i, (a, b, t) in enumerate(spans):
            if a <= e["ts"] <= b and t == e.get("tid"):
                launched[i] += [(e["name"], op) for op in ops]
    for ops in launched.values():
        assert not [op["name"] for _, op in ops
                    if op.get("cat") == "gpu_memcpy" and "HtoD" in op["name"]]
        assert [op for name, op in ops if "GraphLaunch" in name and op["cat"] == "kernel"]
