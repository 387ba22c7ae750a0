"""The port's continuous-batching ``ServeEngine`` (and ``cli.serve``) against
the JAX engine and against per-request generate, on the same weights.

Tiny random-config HF models (as ``tests/test_serving.py`` builds them) are
ported into the JAX package, and the JAX parameter tree into the port with
``params_from_jax``. Everything runs in f32 on the CPU, where the port's
kernel wrappers run their plain versions: greedy tokens must be identical.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from attwarp_tpu.serving import ServeEngine as JServeEngine

import attwarp_tpu_torch.serving.engine as engine_mod
from attwarp_tpu_torch.serving import ServeEngine

IMG = 99                                  # LLaVA image token
Q_IMG, Q_VSTART = 97, 96                  # Qwen2-VL image and vision-start tokens


def build_llava():
    """(JAX LlavaModel, the port's LlavaModel) on the same tiny weights."""
    from transformers import CLIPVisionConfig, LlamaConfig, LlavaConfig, LlavaForConditionalGeneration

    from attwarp_tpu.extract.llava_backend import LlavaBackend as JBackend
    from attwarp_tpu.models import LlavaModel as JModel, port_hf_llava_weights
    from attwarp_tpu_torch.models.llava import LlavaModel, config_from_dict, params_from_jax

    torch.manual_seed(0)
    hf = LlavaForConditionalGeneration(LlavaConfig(
        vision_config=CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                       num_attention_heads=2, image_size=28, patch_size=14),
        text_config=LlamaConfig(vocab_size=128, hidden_size=48, intermediate_size=96,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=2),
        image_token_index=IMG, vision_feature_layer=-2)).eval()
    cfg = JBackend.config_from_hf(hf.config)
    params = port_hf_llava_weights(hf.state_dict(), cfg)
    return (JModel(cfg, params),
            LlavaModel(config_from_dict(dataclasses.asdict(cfg)),
                       params_from_jax(jax.device_get(params))))


def build_qwen():
    """(JAX Qwen2VLModel, the port's Qwen2VLModel) on the same tiny weights."""
    from transformers import Qwen2VLConfig, Qwen2VLForConditionalGeneration

    from attwarp_tpu.extract.qwen2vl_backend import Qwen2VLBackend as JBackend
    from attwarp_tpu.models.qwen2vl import Qwen2VLModel as JModel, port_hf_qwen2vl_weights
    from attwarp_tpu_torch.models.llava import params_from_jax
    from attwarp_tpu_torch.models.qwen2vl import Qwen2VLModel, config_from_dict

    torch.manual_seed(0)
    hf = Qwen2VLForConditionalGeneration(Qwen2VLConfig(
        text_config=dict(vocab_size=128, hidden_size=48, intermediate_size=96,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         rope_theta=10000.0,
                         rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]},
                         max_position_embeddings=512),
        vision_config=dict(depth=2, embed_dim=32, hidden_size=48, num_heads=2, patch_size=14,
                           spatial_merge_size=2, temporal_patch_size=2, mlp_ratio=2,
                           hidden_act="quick_gelu"),
        image_token_id=Q_IMG, video_token_id=98, vision_start_token_id=Q_VSTART)).eval()
    cfg = JBackend.config_from_hf(hf.config)
    params = port_hf_qwen2vl_weights(hf.state_dict(), cfg)
    return (JModel(cfg, params),
            Qwen2VLModel(config_from_dict(dataclasses.asdict(cfg)),
                         params_from_jax(jax.device_get(params))))


def llava_request(rng, T, image=True):
    """Prompt ids (T,) with 4 image tokens (or none) and a 28 px image."""
    ids = rng.integers(3, 90, size=(T,)).astype(np.int64)
    if image:
        ids[2:6] = IMG
    return ids, rng.standard_normal((28, 28, 3)).astype(np.float32)


def qwen_request(rng, T, side):
    """Prompt ids (T,) with a vision block for a ``side`` px image (or no
    image when ``side`` is None)."""
    ids = rng.integers(3, 90, size=(T,)).astype(np.int64)
    if side is None:
        return ids, None
    n_tok = (side // 28) ** 2
    ids[1] = Q_VSTART
    ids[2:2 + n_tok] = Q_IMG
    return ids, rng.standard_normal((side, side, 3)).astype(np.float32)


def _until_eos(row, eos):
    row = [int(t) for t in row]
    return row[: row.index(eos) + 1] if eos in row else row


def reference_tokens(model, ids, pixels, max_new, kv_quant):
    """The port's per-request greedy generate (answer-only), cut after EOS
    as the engine stops. A request without an image gets a dummy one: its
    ids hold no image token, so the splice leaves every embedding as is."""
    from attwarp_tpu_torch.models.qwen2vl import patchify_image

    T = len(ids)
    ids_t = torch.as_tensor(ids[None])
    mask = torch.ones((1, T), dtype=torch.bool)
    if hasattr(model.cfg, "vision_start_token_id"):
        img = pixels if pixels is not None else np.zeros((28, 28, 3), np.float32)
        patches, grid = patchify_image(img, model.cfg.vision)
        gen, _ = model.generate_with_attention(
            ids_t, torch.as_tensor(patches[None]), grid, mask, extract_layer=None,
            max_new_tokens=max_new, kv_quant=kv_quant)
    else:
        img = pixels if pixels is not None else np.zeros((28, 28, 3), np.float32)
        gen, _ = model.generate_with_attention(
            ids_t, torch.as_tensor(img[None]), mask,
            torch.as_tensor([int(np.argmax(ids == IMG))]), extract_layer=None,
            max_new_tokens=max_new, kv_quant=kv_quant)
    return _until_eos(gen[0].tolist(), model.cfg.eos_token_id)


def serve_both(jmodel, tmodel, reqs, max_new, **kw):
    """The same requests through the JAX engine and the port's; returns
    (JAX tokens, port tokens, the port engine)."""
    outs = []
    for E, m in ((JServeEngine, jmodel), (ServeEngine, tmodel)):
        eng = E(m, **kw)
        rids = [eng.submit(ids, px, max_new_tokens=max_new) for ids, px in reqs]
        res = eng.run()
        outs.append([[int(t) for t in res[r]] for r in rids])
    return outs[0], outs[1], eng


@pytest.fixture(scope="module")
def llava():
    return build_llava()


@pytest.fixture(scope="module")
def qwen():
    return build_qwen()


CASES = [(False, 1), (False, 4), (True, 1), (True, 4)]
CASE_IDS = ["dense-k1", "dense-k4", "kv8-k1", "kv8-k4"]


@pytest.mark.parametrize("kv_quant,steps_per_tick", CASES, ids=CASE_IDS)
def test_llava_engine_matches_jax_and_generate(llava, kv_quant, steps_per_tick):
    """More requests than slots, mixed lengths (two buckets) and one
    text-only request: tokens equal JAX's engine and per-request generate."""
    jm, tm = llava
    rng = np.random.default_rng(1)
    reqs = [llava_request(rng, T) for T in (10, 13, 17, 9, 21)]
    reqs.append((llava_request(rng, 12, image=False)[0], None))
    got_j, got_t, eng = serve_both(jm, tm, reqs, 5, slots=2, max_seq=96, bucket=16,
                                   kv_quant=kv_quant, steps_per_tick=steps_per_tick)
    assert got_t == got_j
    for (ids, px), toks in zip(reqs, got_t):
        assert toks == reference_tokens(tm, ids, px, 5, kv_quant)
    assert eng.decode_steps % steps_per_tick == 0 and eng.prefill_groups >= 3


@pytest.mark.parametrize("kv_quant,steps_per_tick", CASES, ids=CASE_IDS)
def test_qwen_engine_matches_jax_and_generate(qwen, kv_quant, steps_per_tick):
    """Qwen2-VL: per-slot M-RoPE deltas, two image sizes (two vision grids)
    and a text-only request; tokens equal JAX's engine and generate."""
    jm, tm = qwen
    rng = np.random.default_rng(2)
    reqs = [qwen_request(rng, T, side)
            for T, side in ((12, 56), (15, 84), (10, 56), (11, None), (17, 84))]
    got_j, got_t, eng = serve_both(jm, tm, reqs, 4, slots=2, max_seq=96, bucket=16,
                                   kv_quant=kv_quant, steps_per_tick=steps_per_tick)
    assert eng.family == "qwen2vl"
    assert got_t == got_j
    for (ids, px), toks in zip(reqs, got_t):
        assert toks == reference_tokens(tm, ids, px, 4, kv_quant)


def test_per_slot_decode_step_equals_shared_position(llava):
    """``decoder_decode_step`` with a (B,) tensor of equal positions gives
    the logits and cache writes of the Python-int form."""
    from attwarp_tpu_torch.models.llama import init_quant_kv_cache, llama_decode_step

    tm = llava[1]
    t = tm.cfg.text
    g = torch.Generator().manual_seed(0)
    emb = torch.randn((3, 1, t.hidden_size), generator=g)
    mask = torch.zeros((3, 64), dtype=torch.bool)
    mask[:, :11] = True
    out = []
    for cur in (10, torch.full((3,), 10)):
        kv = init_quant_kv_cache(t, 3, 64, "cpu")
        logits, kv, _ = llama_decode_step(tm.params["llama"], t, emb, kv, cur,
                                          torch.tensor([7, 8, 10]), mask)
        out.append((logits, kv))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_engine_rejects_oversized_request(llava):
    eng = ServeEngine(llava[1], slots=2, max_seq=48, bucket=16, steps_per_tick=4)
    ids, px = llava_request(np.random.default_rng(0), 17)   # 32 + 20 + 4 > 48
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(ids, px, max_new_tokens=20)


def test_engine_slot_reuse(llava):
    """11 requests through 3 slots: slots are reused and every one ends."""
    rng = np.random.default_rng(3)
    eng = ServeEngine(llava[1], slots=3, max_seq=64, bucket=16)
    rids = [eng.submit(*llava_request(rng, 9 + i % 4), max_new_tokens=3) for i in range(11)]
    out = eng.run()
    assert sorted(out) == sorted(rids)
    assert all(1 <= len(v) <= 3 for v in out.values())
    assert not any(s.active or s.pending for s in eng._slots)


def test_tick_retires_on_chunk_final_eos(llava, monkeypatch):
    """EOS on the LAST step of a tick retires the slot: nothing after it."""
    eng = ServeEngine(llava[1], slots=1, max_seq=64, bucket=16, steps_per_tick=2)
    rid = eng.submit(*llava_request(np.random.default_rng(4), 9), max_new_tokens=6)
    eng._admit()
    assert eng._slots[0].pending and not eng._slots[0].active
    eos = eng.cfg.eos_token_id
    script = iter([7, 7, 5, eos])
    monkeypatch.setattr(engine_mod, "sample_tokens",
                        lambda logits, *a: torch.tensor([next(script)]))
    eng._tick()      # the slot was pending: its tokens are dropped, it activates
    assert eng._slots[0].active and eng.results == {}
    eng._tick()      # [5, EOS]: EOS at the tick's last step
    assert not eng._slots[0].active
    assert eng.results[rid][-2:] == [5, eos] and len(eng.results[rid]) == 3


def test_text_only_requests(llava):
    eng = ServeEngine(llava[1], slots=2, max_seq=64, bucket=16)
    rng = np.random.default_rng(5)
    rid = eng.submit(rng.integers(3, 90, size=(8,)), None, max_new_tokens=4)
    assert 1 <= len(eng.run()[rid]) <= 4


def test_admission_groups_by_bucket_and_ramp(llava, monkeypatch):
    """The cold wave admits in groups up to min(slots, 8); once slots decode
    the cap is ``admit_batch``; groups key on (bucket, has image); tokens
    stay those of per-request generate."""
    tm = llava[1]
    eng = ServeEngine(tm, slots=8, max_seq=96, bucket=16, admit_batch=2)
    calls = []
    real = ServeEngine._prefill_group

    def spy(self, Tb, with_image, chunk):
        calls.append((Tb, with_image, len(chunk), any(s.active for s in self._slots)))
        return real(self, Tb, with_image, chunk)

    monkeypatch.setattr(ServeEngine, "_prefill_group", spy)
    rng = np.random.default_rng(6)
    reqs = [llava_request(rng, T) for T in (10, 13, 9, 11, 12, 17, 21)]
    rids = [eng.submit(ids, px, max_new_tokens=4) for ids, px in reqs]
    eng.submit(rng.integers(3, 90, size=(8,)), None, max_new_tokens=4)
    out = eng.run()
    assert sorted(c[:3] for c in calls[:4]) == [
        (16, False, 1), (16, True, 1), (16, True, 4), (32, True, 2)]
    assert all(c[2] <= 2 for c in calls if c[3])
    for rid, (ids, px) in zip(rids, reqs):
        assert out[rid] == reference_tokens(tm, ids, px, 4, False)


def test_admission_groups_split_by_pixel_shape(llava, monkeypatch):
    eng = ServeEngine(llava[1], slots=4, max_seq=64, bucket=16, admit_batch=4)
    chunks = []
    monkeypatch.setattr(ServeEngine, "_prefill_group", lambda self, Tb, wi, chunk: chunks.append(
        [None if r.pixel_values is None else r.pixel_values.shape for _, r in chunk]))
    rng = np.random.default_rng(7)
    for shape in ((28, 28, 3), (14, 14, 3), (28, 28, 3), None):
        px = None if shape is None else rng.standard_normal(shape).astype(np.float32)
        eng.submit(rng.integers(3, 90, size=(10,)), px, max_new_tokens=2)
    eng._admit()
    assert sorted(map(tuple, chunks), key=repr) == [
        ((14, 14, 3),), ((28, 28, 3), (28, 28, 3)), (None,)]


@pytest.mark.parametrize("family", ["llava", "qwen2vl"])
def test_failed_admission_rolls_back(llava, qwen, family, monkeypatch):
    """A failed prefill puts its requests back in order and frees their
    slots; the engine then serves them as if nothing had happened."""
    rng = np.random.default_rng(8)
    if family == "llava":
        tm = llava[1]
        reqs = [llava_request(rng, T) for T in (9, 12)]
    else:
        tm = qwen[1]
        reqs = [qwen_request(rng, T, 56) for T in (12, 14)]
    eng = ServeEngine(tm, slots=2, max_seq=64, bucket=16, steps_per_tick=4)
    rids = [eng.submit(ids, px, max_new_tokens=4) for ids, px in reqs]

    def boom(self, Tb, with_image, chunk):
        raise RuntimeError("injected prefill failure")

    real = ServeEngine._prefill_group
    monkeypatch.setattr(ServeEngine, "_prefill_group", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng._admit()
    assert [r.rid for r in eng.queue] == rids
    assert not any(s.pending or s.active for s in eng._slots) and not eng._pending
    monkeypatch.setattr(ServeEngine, "_prefill_group", real)
    out = eng.run()
    for rid, (ids, px) in zip(rids, reqs):
        assert out[rid] == reference_tokens(tm, ids, px, 4, False)


def test_cold_cap_reads_free_device_memory(llava, monkeypatch):
    """On a CUDA device the startup-ramp cap halves until its groups fit the
    free memory ``torch.cuda.mem_get_info`` reports; the CPU is unlimited."""
    eng = ServeEngine(llava[1], slots=8, max_seq=64, bucket=16, admit_batch=2,
                      kv_quant=True)
    assert eng.admit_batch_cold == 8                      # CPU: unlimited
    t = eng.tcfg
    # the priced row, written out again so a change to the model fails here:
    # int8 K/V + f32 scales of one slot, and the prefill's activations
    row = (2 * t.num_hidden_layers * 64 * t.kv_heads * (t.head_dim + 4)
           + 64 * (10 * t.hidden_size + 3 * t.intermediate_size) * 4
           + 3 * 4 * t.num_attention_heads * 64 ** 2)
    assert eng._admission_bytes() == row
    eng.device = torch.device("cuda", 0)
    caps = []
    for n in (8, 4, 2, 0):
        free = int(((1 << 30) + n * row) / 0.92) + 4096
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev, f=free: (f, 2 * f))
        caps.append(eng._fit_cold_cap(8))
    assert caps == [8, 4, 2, 2]


def test_logs_stay_bounded(llava, monkeypatch):
    monkeypatch.setattr(ServeEngine, "LOG_LEN", 3)
    rng = np.random.default_rng(9)
    eng = ServeEngine(llava[1], slots=2, max_seq=64, bucket=16, steps_per_tick=1)
    for _ in range(5):
        eng.submit(*llava_request(rng, 10), max_new_tokens=6)
    eng.run()
    assert len(eng.tick_log) == 3 and len(eng.admit_log) == 3
    assert eng.decode_steps > 3


def test_sampling_reproducible_and_greedy_limits(llava):
    """Sampled tokens repeat under one seed; temperature 0, and top_k=1 at
    any temperature, give the greedy tokens; a greedy request beside a
    sampled one is unaffected."""
    tm = llava[1]
    rng = np.random.default_rng(10)
    a, b = llava_request(rng, 11), llava_request(rng, 13)

    def run(seed, temp, top_k):
        eng = ServeEngine(tm, slots=2, max_seq=64, bucket=16, steps_per_tick=4,
                          seed=seed, top_k=top_k)
        r1 = eng.submit(*a, max_new_tokens=6)
        r2 = eng.submit(*b, max_new_tokens=6, temperature=temp)
        out = eng.run()
        return out[r1], out[r2]

    greedy = run(0, 0.0, 0)
    assert greedy == (reference_tokens(tm, *a, 6, False), reference_tokens(tm, *b, 6, False))
    assert run(0, 1.5, 1) == greedy
    s1, s2 = run(0, 5.0, 0), run(0, 5.0, 0)
    assert s1 == s2 and s1[0] == greedy[0]
    assert all(0 <= tok < tm.cfg.text.vocab_size for tok in s1[1])
    assert any(run(seed, 5.0, 0)[1] != s1[1] for seed in (1, 2, 3))


def _write_requests(tmp_path, rng):
    from PIL import Image

    img = tmp_path / "im.png"
    Image.fromarray((rng.random((40, 48, 3)) * 255).astype(np.uint8)).save(img)
    ids = rng.integers(3, 90, size=(12,)).tolist()
    ids[2:6] = [IMG] * 4
    reqs = tmp_path / "reqs.jsonl"
    with open(reqs, "w") as f:
        f.write(json.dumps({"image_path": str(img), "input_ids": ids}) + "\n")
        f.write(json.dumps({"input_ids": rng.integers(3, 90, size=(9,)).tolist()}) + "\n")
    return reqs, img


@pytest.mark.parametrize("chunked", [0, 16], ids=["engine", "chunked"])
def test_serve_cli_end_to_end(llava, tmp_path, chunked):
    """``save``, then the ``llava-ckpt:`` spec on ``--device cpu``: a JSONL
    with an image request and an ids-only request in, answers out; the
    image request's tokens are those of the engine on the backend's own
    ``_preprocess`` pixels."""
    from attwarp_tpu_torch.cli.serve import main
    from attwarp_tpu_torch.data.imageio import read_rgb
    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend

    tm = llava[1]
    be = LlavaBackend(tm)
    be.save(tmp_path / "ckpt")
    reqs, img = _write_requests(tmp_path, np.random.default_rng(11))
    out = tmp_path / "answers.jsonl"
    assert main(["--backend", f"llava-ckpt:{tmp_path / 'ckpt'}+kv8", "--device", "cpu",
                 "--jsonl", str(reqs), "--output", str(out), "--slots", "2",
                 "--max-seq", "768", "--max-new-tokens", "4", "--steps-per-tick", "2",
                 "--chunked-prefill", str(chunked)]) == 0
    rows = [json.loads(line) for line in open(out)]
    assert [r["answer"] for r in rows] == [None, None]    # no tokenizer saved
    pixels = be._preprocess(read_rgb(str(img)))
    assert pixels.shape == (28, 28, 3) and pixels.dtype == np.float32
    eng = ServeEngine(tm, slots=2, max_seq=768, steps_per_tick=2, kv_quant=True)
    lines = [json.loads(line) for line in open(reqs)]
    rids = [eng.submit(line["input_ids"], pixels if "image_path" in line else None,
                       max_new_tokens=4) for line in lines]
    res = eng.run()
    eos = tm.cfg.eos_token_id
    assert [r["tokens"] for r in rows] == [[t for t in res[rid] if t != eos] for rid in rids]


def test_checkpoint_round_trip(llava, qwen, tmp_path, monkeypatch):
    """Weights, config and the dry-run tokenizer come back from ``save``,
    with ``transformers`` made unimportable: the port reads its own
    ``tokenizer.json`` without it."""
    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer

    monkeypatch.setitem(sys.modules, "transformers", None)
    ref_tok = DryRunTokenizer()
    for name, cls, m, kw in (("l", LlavaBackend, llava[1], {}),
                             ("q", Qwen2VLBackend, qwen[1], {"image_size": 56})):
        cls(m, tokenizer=DryRunTokenizer(), extract_layer=1, **kw).save(tmp_path / name)
        be = cls.load(tmp_path / name, "cpu", extract_layer=1, **kw)
        assert be.model.cfg == m.cfg
        assert type(be.tokenizer) is DryRunTokenizer
        assert vars(be.tokenizer).keys() == vars(ref_tok).keys()
        assert all(getattr(be.tokenizer, k) == v for k, v in vars(ref_tok).items())
        assert be.build_ids("read the code on the tag") == \
            cls(m, tokenizer=ref_tok, extract_layer=1, **kw).build_ids("read the code on the tag")
        flat = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, be.model.params))
        ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, m.params))
        assert len(flat) == len(ref) and all(np.array_equal(a, b) for a, b in zip(flat, ref))


def test_checkpoint_reads_hf_saved_tokenizers(llava, tmp_path):
    """A checkpoint directory whose tokenizer ``build_dry_run_tokenizer``
    saved loads into the port's word-level tokenizer with HF's ids and
    text; one the port cannot read itself (a normalizer) comes back
    through ``transformers.AutoTokenizer``; none gives None."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from tools.make_random_7b_ckpt import build_dry_run_tokenizer

    hf = build_dry_run_tokenizer()
    LlavaBackend(llava[1]).save(tmp_path / "ckpt")
    assert LlavaBackend.load(tmp_path / "ckpt", "cpu").tokenizer is None
    hf.save_pretrained(str(tmp_path / "ckpt"))
    tok = LlavaBackend.load(tmp_path / "ckpt", "cpu").tokenizer
    assert type(tok) is DryRunTokenizer
    for text in ("USER: what is the code on the tag? ASSISTANT:", "a </s> b <s>", "Über 3.5!"):
        for special in (True, False):
            ids = hf.encode(text, add_special_tokens=special)
            assert tok.encode(text, add_special_tokens=special) == ids
            for skip in (True, False):
                assert tok.decode(ids, skip_special_tokens=skip) == \
                    hf.decode(ids, skip_special_tokens=skip)
    other = Tokenizer(models.WordLevel(vocab=hf.get_vocab(), unk_token="<unk>"))
    other.normalizer = normalizers.Lowercase()
    other.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=other, unk_token="<unk>").save_pretrained(
        str(tmp_path / "ckpt"))
    tok = LlavaBackend.load(tmp_path / "ckpt", "cpu").tokenizer
    assert isinstance(tok, PreTrainedTokenizerFast)
    assert tok.encode("READ the LABEL") == [hf.get_vocab()[w] for w in ("read", "the", "label")]


def test_make_backend_grammar(llava, qwen, tmp_path):
    """``+kv8`` and ``+flash`` compose in any order; the specs the port
    cannot load yet raise and name the ROADMAP item that brings them; the
    reader proxy loads and has no ``+kv8`` path."""
    from attwarp_tpu_torch.cli.process_dataset import make_backend, parse_layer_spec
    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend

    LlavaBackend(llava[1]).save(tmp_path / "l")
    Qwen2VLBackend(qwen[1], extract_layer=0).save(tmp_path / "q")
    assert parse_layer_spec("20") == 20 and parse_layer_spec("4,8") == (4, 8)
    for spec in ("llava-ckpt:{}/l+kv8+flash", "llava-ckpt:{}/l+flash+kv8"):
        be = make_backend(spec.format(tmp_path), 0, "cpu")
        assert isinstance(be, LlavaBackend) and be.kv_quant and be.use_flash
    be = make_backend(f"qwen2vl-ckpt:{tmp_path}/q+kv8", 1, "cpu")
    assert isinstance(be, Qwen2VLBackend) and be.kv_quant and not be.use_flash
    assert be.extract_layer == 1
    for spec, item in ((f"llava-ckpt:{tmp_path}/l+int8", "item 5"),
                       (f"llava-ckpt:{tmp_path}/l+kv8+lm8", "item 5"),
                       ("llava:llava-hf/llava-1.5-7b-hf", "item 4"),
                       ("qwen2vl:Qwen/Qwen2-VL-7B-Instruct", "item 8"),
                       ("mini", "item 3"), ("reader+kv8", "no '\\+kv8' path"),
                       ("nonsense", "unknown")):
        with pytest.raises(ValueError, match=item):
            make_backend(spec, 0, "cpu")
    assert type(make_backend("reader", 20, "cpu")).__name__ == "ReaderBackend"


def test_port_serving_imports_no_jax():
    code = ("import sys, attwarp_tpu_torch.serving.engine, attwarp_tpu_torch.cli.serve; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'PIL' not in sys.modules, 'PIL imported'")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
