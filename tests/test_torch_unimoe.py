"""Uni-MoE-2.0-Omni in the port (``models/moe.py``, ``models/unimoe.py``,
the SigLIP variant of ``models/clip_vit.py``, ``extract/unimoe_backend.py``)
against the plain float32 forward of ``testing/unimoe_reference.py``, at
tiny widths with seeded random weights on the CPU: the routing rule on
hand-made probabilities, the two forms of the expert layer, prefill then
decode through the cache, the tower, the two-pass pipeline end to end, the
benchmark's copy of the reference, and the paths that refuse an expert
tree. The tests marked ``cuda`` replay the decode step's graphs over the
expert tree on the card. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_unimoe.py -q
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.extract.unimoe_backend import UniMoEBackend
from attwarp_tpu_torch.models import decode_graph, llama, moe, qwen2vl, unimoe
from attwarp_tpu_torch.models.clip_vit import SiglipVisionConfig, clip_vision_features
from attwarp_tpu_torch.pipeline import AttWarpPipeline
from attwarp_tpu_torch.testing.unimoe_reference import UniMoEReference
from attwarp_tpu_torch.utils import profiling

TINY_MOE = moe.MoEConfig(routed=4, null=1, shared=2, routed_width=32, shared_width=16)


def tiny_cfg(hidden=64, heads=4, kv_heads=2, mrope=(2, 3, 3), moe_cfg=TINY_MOE, layers=2,
             image_size=32):
    return unimoe.UniMoEConfig(
        vision=SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                                  num_attention_heads=2, image_size=image_size),
        text=unimoe.UniMoETextConfig(vocab_size=160, hidden_size=hidden, num_hidden_layers=layers,
                                     num_attention_heads=heads, num_key_value_heads=kv_heads,
                                     rope_theta=10000.0, mrope_section=mrope, moe=moe_cfg),
        image_token_id=150, vision_start_token_id=151, vision_end_token_id=152,
        pad_token_id=153, eos_token_id=159)


def hp(cfg):
    """The reference's hyperparameters from a port config."""
    v, t = cfg.vision, cfg.text
    return {"vision": {"hidden": v.hidden_size, "heads": v.num_attention_heads,
                       "patch": v.patch_size, "eps": v.layer_norm_eps,
                       "layers_run": cfg.vision_feature_layer % (v.num_hidden_layers + 1)},
            "text": {"hidden": t.hidden_size, "heads": t.num_attention_heads,
                     "kv_heads": t.num_key_value_heads, "eps": t.rms_norm_eps,
                     "rope_theta": t.rope_theta, "mrope_section": t.mrope_section,
                     **dataclasses.asdict(t.moe)},
            "image_token_id": cfg.image_token_id}


def make_model(cfg, seed=0, device="cpu", dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    return unimoe.UniMoEModel(cfg, unimoe.random_params(cfg, g, device, dtype))


@pytest.fixture(scope="module")
def model():
    return make_model(tiny_cfg())


# ── the routing rule ────────────────────────────────────────────────────

# probabilities over (e0, e1, e2, e3, null) -> (chosen experts, null in the prefix)
ROUTES = [
    ("reached-by-one", [0.05, 0.8, 0.05, 0.05, 0.05], [1], False),
    ("reached-by-two", [0.4, 0.35, 0.1, 0.1, 0.05], [0, 1], False),
    ("cut-at-the-cap", [0.3, 0.25, 0.2, 0.15, 0.1], [0, 1], False),
    ("null-first", [0.1, 0.05, 0.05, 0.05, 0.75], [], True),
    ("null-second", [0.5, 0.1, 0.05, 0.05, 0.3], [0], True),
    ("ties-to-the-lower-index", [0.3, 0.3, 0.3, 0.05, 0.05], [0, 1], False),
]


@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_routing_rule(case):
    """Router logits log(p) on a unit row: the program's and the
    reference's sets, weights (the raw probabilities) and null flag."""
    _, probs, want, null = case
    router = torch.zeros((5, 8))
    router[:, 0] = torch.log(torch.tensor(probs))
    u = torch.zeros((1, 8))
    u[0, 0] = 1.0
    chosen, w, got_null = moe.route(u, router, TINY_MOE)
    assert chosen[0].nonzero()[:, 0].tolist() == want and bool(got_null[0]) == null
    torch.testing.assert_close(w[0, want], torch.tensor(probs)[want])
    assert not w[0, [e for e in range(4) if e not in want]].any()
    ref_set, ref_null = UniMoEReference({}, hp(tiny_cfg())).route(router, u[0])
    assert sorted(ref_set) == want and ref_null == null


# ── the expert layer's two forms ────────────────────────────────────────

def test_grouped_and_static_forms_equal_the_reference(model):
    """One layer's FFN of 40 rows, 7 of them padding: the grouped form on
    the token rows and the static form on all rows against the
    reference's row-by-row sum, and the tally's counts against the
    reference's sets."""
    cfg = model.cfg
    ref = UniMoEReference(model.params, hp(cfg))
    m = model.params["text"]["layers"][1]["moe"]
    h = torch.randn((2, 20, cfg.text.hidden_size), generator=torch.Generator().manual_seed(2))
    valid = torch.ones((2, 20), dtype=torch.bool)
    valid[0, :7] = False
    before = model.tally.snapshot()
    grouped = moe.moe_ffn(m, cfg.text.moe, h, valid)
    static = moe.moe_ffn(m, cfg.text.moe, h)
    want = ref.ffn(m, h.reshape(-1, h.shape[-1])).reshape(h.shape)
    torch.testing.assert_close(grouped[valid], want[valid], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(static, want, rtol=1e-5, atol=1e-5)
    sets = [ref.route(m["router"], row) for row in h.reshape(-1, h.shape[-1])]
    n_routed = sum(len(s) for s, _ in sets)
    n_null = sum(nl for _, nl in sets)
    n_valid_routed = sum(len(s) for (s, _), v in zip(sets, valid.reshape(-1)) if v)
    n_valid_null = sum(nl for (_, nl), v in zip(sets, valid.reshape(-1)) if v)
    got = (model.tally.counts - before)[1].tolist()
    assert sum(got[:4]) == n_valid_routed + n_routed
    assert got[4] == n_valid_null + n_null and got[5] == 33 + 40
    assert not (model.tally.counts - before)[0].any()


def test_routing_log_keeps_each_token_rows_sets_in_a_ring():
    """``log_routing``: a prefill's token rows, then a step's rows, each at
    its place in the layer's count; rows the ring wrote over are refused."""
    model = make_model(tiny_cfg())
    cfg, tally = model.cfg, model.tally
    tally.log_routing(40)
    m = model.params["text"]["layers"][0]["moe"]
    g = torch.Generator().manual_seed(3)
    h = torch.randn((2, 20, cfg.text.hidden_size), generator=g)
    valid = torch.ones((2, 20), dtype=torch.bool)
    valid[0, :7] = False
    step = torch.randn((8, 1, cfg.text.hidden_size), generator=g)
    moe.moe_ffn(m, cfg.text.moe, h, valid)
    moe.moe_ffn(m, cfg.text.moe, step)
    want = torch.cat([moe.route(h[valid], m["router"], cfg.text.moe)[0],
                      moe.route(step[:, 0], m["router"], cfg.text.moe)[0]])
    assert int(tally.counts[0, -1]) == 41
    assert torch.equal(tally.routes(1, 41)[0], want[1:])
    with pytest.raises(ValueError, match="gone"):
        tally.routes(0, 41)


# ── the model against the reference ─────────────────────────────────────

def _prompts(cfg, n_img, lens, seed=0):
    """Left-padded prompts (B, T) with an image block, and their mask."""
    g = np.random.default_rng(seed)
    T = max(lens) + 3
    ids = np.full((len(lens), T), cfg.pad_token_id, np.int64)
    mask = np.zeros(ids.shape, bool)
    for b, n in enumerate(lens):
        row = g.integers(0, 90, n)
        row[3] = cfg.vision_start_token_id
        row[4:4 + n_img] = cfg.image_token_id
        row[4 + n_img] = cfg.vision_end_token_id
        ids[b, T - n:] = row
        mask[b, T - n:] = True
    return torch.as_tensor(ids), torch.as_tensor(mask)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense-cache", "int8-cache"])
def test_prefill_then_decode_equals_the_full_forward(model, kv_quant):
    """Two left-padded prompts, the prefill and four decode steps through
    the cache, against the reference's full forward over each unpadded
    sequence: every step's logits and the extract layer's rows (the plain
    int8 cache rounds the keys and values, hence its wider bar)."""
    cfg, params = model.cfg, model.params
    tcfg, layer, steps = cfg.text, 1, 4
    pix = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(4))
    ids, mask = _prompts(cfg, 4, (14, 11))
    B, T = ids.shape
    S = T + steps
    feats = model.image_features((pix - 0.5) / 0.5, (1, 2, 2))
    embeds = qwen2vl.embed_and_splice(params, cfg, ids, feats)
    pos, deltas = qwen2vl.get_mrope_positions(ids.numpy(), mask.numpy(), (1, 2, 2),
                                              cfg.image_token_id, 1)
    cos, sin = qwen2vl.mrope_cos_sin(torch.as_tensor(pos), tcfg)
    logits, kv, row = llama.decoder_prefill(params["text"], tcfg, embeds, mask, cos, sin, S,
                                            extract_layer=layer, kv_quant=kv_quant)
    out, rows = [logits], [row]
    toks = torch.randint(0, 90, (steps, B), generator=torch.Generator().manual_seed(5))
    full = torch.nn.functional.pad(mask, (0, steps))
    for s in range(steps):
        full[:, T + s] = True
        p = torch.as_tensor(T + deltas + s)
        c1, s1 = qwen2vl.mrope_cos_sin(p[None, :, None].expand(3, B, 1), tcfg)
        lg, kv, r = llama.decoder_decode_step(params["text"], tcfg,
                                              llama.embed(params["text"], toks[s])[:, None],
                                              kv, T + s, c1, s1, full, extract_layer=layer)
        out.append(lg)
        rows.append(r)
    ref = UniMoEReference(params, hp(cfg))
    ref_feats = ref.image_features(pix)
    torch.testing.assert_close(feats, ref_feats, rtol=1e-5, atol=1e-5)
    seqs = [torch.cat([ids[b][mask[b]], toks[:, b]]) for b in range(B)]
    starts = [int(mask[b].sum()) - 1 for b in range(B)]
    want = ref.forward(seqs, ref_feats, starts, layer, starts)
    tol = dict(rtol=2e-2, atol=2e-2) if kv_quant else dict(rtol=1e-4, atol=1e-4)
    for b, (lg_r, rows_r) in enumerate(want):
        pad = T - int(mask[b].sum())
        for s in range(steps + 1):
            torch.testing.assert_close(out[s][b], lg_r[s], **tol)
            torch.testing.assert_close(rows[s][b, :, pad:T + s], rows_r[s, :, :T - pad + s],
                                       **tol)


def test_siglip_tower_equals_the_reference(model):
    """The shared tower under a ``SiglipVisionConfig`` (26 of 27 blocks at
    full size, 2 of 3 here; no class token, no pre- or post-layernorm) and
    the aligner."""
    pix = torch.rand((3, 32, 32, 3), generator=torch.Generator().manual_seed(6))
    got = unimoe.unimoe_vision_features(model.params, model.cfg, (pix - 0.5) / 0.5)
    torch.testing.assert_close(got, UniMoEReference(model.params, hp(model.cfg))
                               .image_features(pix), rtol=1e-5, atol=1e-5)
    tower = clip_vision_features(model.params["vision"], model.cfg.vision,
                                 (pix - 0.5) / 0.5, feature_layer=-1)
    assert tower.shape == (3, 4, 32)


def test_pipeline_runs_end_to_end_with_the_tally_and_spans(model, tmp_path):
    """``AttWarpPipeline.run`` over the backend: both passes answer, the
    maps are 2 x 2, every ``moe`` span carries its layer and rows, and the
    recorder reads the tally: rows = layers x (the prompts' tokens + the
    decode rows of both passes)."""
    be = UniMoEBackend(model, tokenizer=DryRunTokenizer(), extract_layer=1, image_size=32,
                       kv_quant=True, use_flash=True)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((40, 60), (50, 30))]
    questions = ["what is the text on the label", "read the code"]
    K = 3
    pipe = AttWarpPipeline(be, warp_size=32, max_new_tokens=K, size_bucket=16, max_side=96)
    with profiling.tracing(tmp_path / "spans.jsonl") as rec:
        res = pipe.run(images, questions)
    assert res.attention_maps.shape == (2, 2, 2) and len(res.second_answers) == 2
    n_tokens = sum(len(be.build_ids(q)) for q in questions)
    L = model.cfg.text.num_hidden_layers
    assert rec.counters["moe.rows"] == L * 2 * (n_tokens + 2 * K)
    assert 0 < rec.counters["moe.routed_pairs"] <= 2 * rec.counters["moe.rows"]
    spans = [json.loads(x) for x in (tmp_path / "spans.jsonl").read_text().splitlines()]
    mo = [s for s in spans if s.get("name") == "moe"]
    assert {s["layer"] for s in mo} == set(range(L)) and all(s["rows"] > 0 for s in mo)
    with pytest.raises(ValueError, match="32 px"):
        UniMoEBackend(model, image_size=56)


def test_benchmark_reference_equals_the_test_reference(model):
    """The benchmark's copy (``benchmark/reference/unimoe.py``, vectorised,
    in float32) against this file's reference, one tiny model: features,
    logits and rows."""
    from benchmark.reference.unimoe import UniMoEReference as BenchReference

    cfg = model.cfg
    v, t = cfg.vision, cfg.text
    c = {"vision_config": {"hidden_size": v.hidden_size, "num_attention_heads":
                           v.num_attention_heads, "num_hidden_layers": v.num_hidden_layers,
                           "patch_size": v.patch_size, "layer_norm_eps": v.layer_norm_eps},
         "vision_feature_layer": cfg.vision_feature_layer,
         "hidden_size": t.hidden_size, "num_attention_heads": t.num_attention_heads,
         "num_key_value_heads": t.num_key_value_heads, "rms_norm_eps": t.rms_norm_eps,
         "rope_theta": t.rope_theta, "rope_scaling": {"mrope_section": list(t.mrope_section)},
         "image_token_id": cfg.image_token_id,
         "mlp_dynamic_expert_num": t.moe.routed, "mlp_dynamic_null_expert_num": t.moe.null,
         "mlp_dynamic_top_p": t.moe.top_p, "mlp_dynamic_top_k": t.moe.top_k}
    pix = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(8))
    ids, mask = _prompts(cfg, 4, (12, 9), seed=3)
    seqs = [ids[b][mask[b]] for b in range(2)]
    starts = [len(s) - 4 for s in seqs]
    ref = UniMoEReference(model.params, hp(cfg))
    bench = BenchReference(c, model.params, "f32")
    feats = ref.image_features(pix)
    torch.testing.assert_close(bench.image_features(pix), feats, rtol=1e-5, atol=1e-5)
    for (lg_b, r_b), (lg_r, r_r) in zip(bench.forward(seqs, feats, starts, 1, starts),
                                        ref.forward(seqs, feats, starts, 1, starts)):
        torch.testing.assert_close(lg_b, lg_r, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r_b, r_r, rtol=1e-5, atol=1e-5)


# ── paths that refuse an expert tree ────────────────────────────────────

def _engine(name):
    def make(m):
        from attwarp_tpu_torch import serving

        getattr(serving, name)(m, slots=2, max_seq=128)
    return make


def _sharded(m):
    from attwarp_tpu_torch.parallel.comm import SOLO
    from attwarp_tpu_torch.parallel.llava_sharding import _shard_decoder

    t = m.cfg.text
    _shard_decoder(m.params["text"], t.num_attention_heads, t.kv_heads, t.head_dim,
                   t.moe.routed_width, t.vocab_size, SOLO)


REFUSALS = {
    "chunked-engine": _engine("ChunkedPrefillEngine"),
    "serve-engine": _engine("ServeEngine"),
    "tensor-parallel": _sharded,
    "int8": lambda m: UniMoEBackend(m, extract_layer=1, image_size=32).quantize_int8(),
}


@pytest.mark.parametrize("path", sorted(REFUSALS))
def test_paths_outside_the_cell_refuse_an_expert_tree(path):
    with pytest.raises(ValueError, match="routed experts"):
        REFUSALS[path](make_model(tiny_cfg()))


# ── on the card ─────────────────────────────────────────────────────────

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernel K3; no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_model(dev):
    """Head size 128 (K3's), bf16 weights."""
    cfg = tiny_cfg(hidden=256, heads=2, kv_heads=1, mrope=(16, 24, 24), layers=3,
                   moe_cfg=moe.MoEConfig(routed_width=512, shared_width=128))
    return make_model(cfg, 3, dev, torch.bfloat16)


def _steps(model, dev, kv, steps, seed=5):
    """A prefill into ``kv``, then ``steps`` decode steps: their logits."""
    tcfg, params = model.cfg.text, model.params["text"]
    g = torch.Generator(device=dev).manual_seed(seed)
    B, T = 8, 40
    embeds = torch.randn((B, T, tcfg.hidden_size), generator=g, device=dev,
                         dtype=torch.bfloat16)
    amask = torch.ones((B, T), dtype=torch.bool, device=dev)
    amask[1, :7] = False
    pos = torch.clamp(torch.cumsum(amask.long(), 1) - 1, min=0)
    cos, sin = qwen2vl.mrope_cos_sin(pos[None].expand(3, -1, -1), tcfg)
    S = kv.k_q.shape[2]
    llama.decoder_prefill(params, tcfg, embeds, amask, cos, sin, S, kv_quant=True, cache=kv)
    full = torch.nn.functional.pad(amask, (0, S - T))
    toks = torch.randint(0, tcfg.vocab_size, (steps, B), generator=g, device=dev)
    out = []
    for s in range(steps):
        full[:, T + s] = True
        p = (amask.sum(1) + s)[:, None]
        c1, s1 = qwen2vl.mrope_cos_sin(p[None].expand(3, -1, -1), tcfg)
        emb = llama.embed(params, toks[s])[:, None]
        logits, _, _ = llama.decoder_decode_step(params, tcfg, emb, kv, T + s, c1, s1, full,
                                                 extract_layer=1)
        out.append(logits)
    return out


@pytest.mark.cuda
def test_decode_graphs_replay_the_expert_tree(cuda, monkeypatch):
    """Over a leased cache the step replays graphs (one capture, the rest
    replays, ``decode_graph.eager`` 1), its logits within bf16 rounding of
    the same step run eagerly, and the tally and the routing log after the
    replayed steps equal the eager steps' (graphs update both in place)."""
    model = _card_model(cuda)
    model.tally.log_routing(4096)
    tcfg = model.cfg.text
    steps, runs = 12, []
    for graphed in (True, False):
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(decode_graph, "graphs_for", lambda *a, **k: None)
            kv = llama.lease_kv_cache(tcfg, 8, 128, cuda, tcfg.kv_heads)
            before = model.tally.snapshot()
            with profiling.tracing() as rec:
                out = _steps(model, cuda, kv, steps)
                torch.cuda.synchronize()
            llama.release_kv_cache(kv)
        runs.append((out, (model.tally.counts - before).cpu(), rec.counters))
    (g_out, g_tally, g_c), (e_out, e_tally, e_c) = runs
    assert g_c.get("decode_graph.captures") == 1 and g_c.get("decode_graph.eager") == 1
    assert g_c.get("decode_graph.replays") == steps - 1
    assert e_c.get("decode_graph.eager") == steps
    for a, b in zip(g_out, e_out):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)
    rows = (8 * 40 - 7) + 8 * steps   # the prefill's token rows, then 8 a step
    assert torch.equal(g_tally, e_tally) and g_tally[:, 5].tolist() == [rows] * 3
    assert g_c["moe.rows"] == int(g_tally[:, 5].sum())
    assert torch.equal(model.tally.routes(0, rows), model.tally.routes(rows, 2 * rows))


@pytest.mark.cuda
def test_no_host_copy_or_sync_in_an_expert_segment(cuda, tmp_path):
    """The static form runs with the device's synchronising calls made
    errors; under ``torch.profiler`` no host-to-device copy is launched
    inside a replayed ``decode_step`` of the pipeline's generate loop."""
    model = _card_model(cuda)
    m = model.params["text"]["layers"][0]["moe"]
    h = torch.randn((8, 1, 256), device=cuda, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe.moe_ffn(m, model.cfg.text.moe, h)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    be = UniMoEBackend(model, tokenizer=DryRunTokenizer(), extract_layer=1, image_size=32,
                       kv_quant=True, use_flash=True)
    pix = torch.rand((8, 32, 32, 3), device=cuda)
    qs = ["what is the text"] * 8
    be.extract(pix, qs, max_new_tokens=4)   # captures outside the trace
    torch.cuda.synchronize()
    with profiling.device_trace(tmp_path):
        be.extract(pix, qs, max_new_tokens=6)
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == "decode_step"]
    assert len(spans) == 6
    copies = {(e.get("args") or {}).get("correlation") for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]}
    launched = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and (e.get("args") or {}).get("correlation") in copies]
    assert not [e for e in launched for a, b in spans if a <= e["ts"] <= b]
