"""The port's int8 weight forms (``+int8``, ``+lm8``) against the JAX
package's ``numerics/quant.py`` and its decoders, on the CPU.

The same numpy weights and inputs go through both. On the CPU the port's
int8 product is ``torch._int_mm`` (exact, like JAX's int32 ``dot_general``)
and every other step is JAX's op for op in f32, so the expected result is
bit-equal. The bars are: ``quantize_linear`` bit-equal; ``apply_linear``
within 1e-6 relative (one f32 rounding of the rescale, were the two
libraries to round one product differently); logits within 1e-5 relative
of the largest (the decoders' dense f32 arithmetic differs between XLA and
PyTorch in summation order); greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attwarp_tpu.models.llama import LlamaConfig as JLlamaConfig
from attwarp_tpu.models.llama import llama_decode_step as j_decode_step
from attwarp_tpu.models.llama import llama_prefill as j_prefill
from attwarp_tpu.numerics import quant as jq

from attwarp_tpu_torch.models.llama import LlamaConfig, llama_decode_step, llama_prefill
from attwarp_tpu_torch.models.llava import params_from_jax
from attwarp_tpu_torch.numerics import quant as tq
from test_torch_serving import build_llava, build_qwen, llava_request, qwen_request, \
    reference_tokens


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_keys(v) for v in tree]
    return None


def _same_tree(got, ref):
    """``got`` (tensors) equals ``ref`` (numpy/JAX arrays) leaf for leaf:
    same keys, dtypes and values."""
    assert _keys(got) == _keys(ref)
    for g, r in zip(_leaves(got), _leaves(ref)):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype, (g.dtype, r.dtype)
        np.testing.assert_array_equal(g.numpy(), r)


# ── quantize_linear, apply_linear, lm_logits ────────────────────────────


def _weight(rng, form, out=96, inp=128):
    w = (rng.standard_normal((out, inp)) / np.sqrt(inp)).astype(np.float32)
    if form == "dense":
        return w
    return {"weight": w, "bias": rng.standard_normal((out,)).astype(np.float32)}


def _to(tree, fn):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


@pytest.mark.parametrize("form", ["dense", "bias"])
def test_quantize_linear_bit_equal(rng, form):
    w = _weight(rng, form)
    qj = jq.quantize_linear(_to(w, jnp.asarray))
    qt = tq.quantize_linear(_to(w, torch.as_tensor))
    assert set(qt) == set(qj) == ({"q", "s"} if form == "dense" else {"q", "s", "b"})
    _same_tree(qt, qj)
    assert qt["q"].dtype == torch.int8 and qt["s"].dtype == torch.float32
    assert tq.quantize_linear(qt) is qt and tq.is_quantized(qt)


def test_quantize_linear_on_bf16_weights(rng):
    """A bf16 weight quantizes from its f32 value, as JAX's does."""
    w = (rng.standard_normal((40, 64)) * 0.02).astype(np.float32)
    qj = jq.quantize_linear(jnp.asarray(w, jnp.bfloat16))
    qt = tq.quantize_linear(torch.as_tensor(w).bfloat16())
    _same_tree(qt, qj)


@pytest.mark.parametrize("form", ["dense", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 128), (3, 7, 128)], ids=["2d", "3d"])
def test_apply_linear_w8a8_matches_jax(rng, form, dtype, shape):
    w = _weight(rng, form)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    qj = jq.quantize_linear(_to(w, jnp.asarray))
    ref = np.asarray(jq.apply_linear(jnp.asarray(x, dtype), qj).astype(jnp.float32))
    got = tq.apply_linear(torch.as_tensor(x).to(getattr(torch, dtype)),
                          tq.quantize_linear(_to(w, torch.as_tensor)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (*shape[:-1], 96)
    assert _rel(got.float(), ref) <= 1e-6


def test_apply_linear_zero_rows_and_int32_sums(rng):
    """An all-zero token row gives the bias (its scale is the 1e-12 floor);
    the int32 product is exact (against an f64 product of the same ints)."""
    w = tq.quantize_linear(_to(_weight(rng, "bias", 24, 40), torch.as_tensor))
    x = torch.as_tensor(rng.standard_normal((3, 40)).astype(np.float32))
    x[1] = 0
    y = tq.apply_linear(x, w)
    torch.testing.assert_close(y[1], w["b"], rtol=0, atol=0)
    a = torch.as_tensor(rng.integers(-127, 128, (19, 40)), dtype=torch.int8)
    s = tq.int8_matmul(a, w["q"])
    assert s.dtype == torch.int32
    assert torch.equal(s.double(), a.double() @ w["q"].double().t())
    with pytest.raises(TypeError):
        tq.int8_matmul(a.float(), w["q"])


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_lm_logits_int8_matches_jax(rng, tied):
    emb = (rng.standard_normal((97, 64)) * 0.05).astype(np.float32)
    pj = {"embed_tokens": jnp.asarray(emb)}
    pt = {"embed_tokens": torch.as_tensor(emb)}
    if not tied:
        head = (rng.standard_normal((97, 64)) * 0.05).astype(np.float32)
        pj["lm_head"], pt["lm_head"] = jnp.asarray(head), torch.as_tensor(head)
    x = rng.standard_normal((4, 64)).astype(np.float32) * 2.0
    dense_t = tq.lm_logits(torch.as_tensor(x), pt)
    assert _rel(dense_t, jq.lm_logits(jnp.asarray(x), pj)) <= 1e-6
    qj, qt = jq.quantize_lm_head(pj), tq.quantize_lm_head(pt)
    assert "q" in qt["lm_head"] and qt["embed_tokens"] is pt["embed_tokens"]
    _same_tree(qt["lm_head"], qj["lm_head"])
    ref = np.asarray(jq.lm_logits(jnp.asarray(x), qj))
    for xt in (torch.as_tensor(x), torch.as_tensor(x).bfloat16()):
        got = tq.lm_logits(xt, qt)
        assert got.dtype == torch.float32
    got = tq.lm_logits(torch.as_tensor(x), qt)
    assert _rel(got, ref) <= 1e-5


# ── decoder trees ───────────────────────────────────────────────────────


TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2)


def _rand_llama(seed=0, bias=False):
    """The tiny decoder of ``tests/test_quant.py`` as numpy (q/k/v with
    biases, as Qwen2's, where ``bias``)."""
    r = np.random.default_rng(seed)
    cfg = JLlamaConfig(**TINY)
    D, I = cfg.hidden_size, cfg.intermediate_size
    kvd = cfg.kv_heads * cfg.head_dim

    def lin(o, i):
        return (r.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)

    def qkv(o):
        w = lin(o, D)
        return {"weight": w, "bias": (r.standard_normal(o) * 0.1).astype(np.float32)} \
            if bias else w

    layers = [{"q_proj": qkv(D), "k_proj": qkv(kvd), "v_proj": qkv(kvd), "o_proj": lin(D, D),
               "gate_proj": lin(I, D), "up_proj": lin(I, D), "down_proj": lin(D, I),
               "input_layernorm": np.ones(D, np.float32),
               "post_attention_layernorm": np.ones(D, np.float32)}
              for _ in range(cfg.num_hidden_layers)]
    return {"embed_tokens": (r.standard_normal((cfg.vocab_size, D)) * 0.05).astype(np.float32),
            "norm": np.ones(D, np.float32), "layers": layers}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


FORMS = {"int8": (True, False, False), "int8+kv8": (True, False, True),
         "lm8": (False, True, False), "int8+lm8+kv8": (True, True, True)}


def _forms(form, bias=False):
    """(JAX tree, port tree, kv_quant) of the tiny decoder in ``form``: the
    JAX tree quantized by JAX, the port's by the port from the same f32
    numpy weights."""
    int8, lm8, kv8 = FORMS[form]
    base = _rand_llama(bias=bias)
    pj = _jax_tree(base)
    pt = params_from_jax(base)
    if int8:
        pj, pt = jq.quantize_decoder_params(pj), tq.quantize_decoder_params(pt)
    if lm8:
        pj, pt = jq.quantize_lm_head(pj), tq.quantize_lm_head(pt)
    return pj, pt, kv8


@pytest.mark.parametrize("bias", [False, True], ids=["llama", "qwen2-biased"])
def test_quantize_decoder_params_and_lm_head_forms(bias):
    pj, pt, _ = _forms("int8+lm8+kv8", bias=bias)
    assert _keys(pt) == _keys(jax.device_get(pj))
    _same_tree(pt, jax.device_get(pj))
    lp = pt["layers"][0]
    for k in tq.DECODER_LINEAR_KEYS:
        assert lp[k]["q"].dtype == torch.int8 and lp[k]["s"].dtype == torch.float32
        assert ("b" in lp[k]) == (bias and k in ("q_proj", "k_proj", "v_proj"))
    assert lp["input_layernorm"].dtype == torch.float32
    assert pt["embed_tokens"].dtype == torch.float32 and tq.is_quantized(pt["lm_head"])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_params_from_jax_keeps_int8(dtype):
    """A JAX tree quantized by JAX converts with its int8 form kept: ``q``
    int8, ``s`` and ``b`` f32 whatever ``dtype``; dense leaves in
    ``dtype``."""
    pj = jq.quantize_lm_head(jq.quantize_decoder_params(_jax_tree(_rand_llama(bias=True))))
    pt = params_from_jax(jax.device_get(pj), dtype=dtype)
    lp = pt["layers"][1]
    for k in tq.DECODER_LINEAR_KEYS:
        assert lp[k]["q"].dtype == torch.int8 and lp[k]["s"].dtype == torch.float32
        np.testing.assert_array_equal(lp[k]["q"].numpy(), np.asarray(pj["layers"][1][k]["q"]))
        np.testing.assert_array_equal(lp[k]["s"].numpy(), np.asarray(pj["layers"][1][k]["s"]))
    assert lp["q_proj"]["b"].dtype == torch.float32
    assert pt["lm_head"]["q"].dtype == torch.int8
    assert lp["input_layernorm"].dtype == (dtype or torch.float32)
    assert pt["embed_tokens"].dtype == (dtype or torch.float32)


def _greedy_j(params, cfg, embeds, mask, steps, kv_quant):
    T = embeds.shape[1]
    logits, kv, _ = j_prefill(params, cfg, embeds, mask, max_seq=T + steps,
                              kv_quant=kv_quant)
    out, toks = [np.asarray(logits)], []
    tok = jnp.argmax(logits, -1)
    for s in range(steps):
        toks.append(np.asarray(tok))
        kvm = jnp.broadcast_to(jnp.arange(T + steps)[None] < T + s + 1, mask.shape[:1] + (T + steps,))
        emb = params["embed_tokens"][tok][:, None, :]
        logits, kv, _ = j_decode_step(params, cfg, emb, kv, jnp.int32(T + s),
                                      jnp.full(mask.shape[:1], T + s, jnp.int32), kvm)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)
    return out, np.stack(toks, 1)


def _greedy_t(params, cfg, embeds, mask, steps, kv_quant):
    B, T = mask.shape
    logits, kv, _ = llama_prefill(params, cfg, embeds, mask, max_seq=T + steps,
                                  kv_quant=kv_quant)
    out, toks = [logits.numpy()], []
    tok = torch.argmax(logits, -1)
    for s in range(steps):
        toks.append(tok.numpy())
        kvm = (torch.arange(T + steps)[None] < T + s + 1).expand(B, -1)
        emb = params["embed_tokens"][tok][:, None, :]
        logits, kv, _ = llama_decode_step(params, cfg, emb, kv, T + s,
                                          torch.full((B,), T + s), kvm)
        out.append(logits.numpy())
        tok = torch.argmax(logits, -1)
    return out, np.stack(toks, 1)


@pytest.mark.parametrize("form", list(FORMS))
def test_prefill_and_decode_match_jax(rng, form):
    """``llama_prefill`` and 8 greedy decode steps on the int8 trees: every
    step's logits within 1e-5 relative of JAX's, the tokens equal."""
    pj, pt, kv8 = _forms(form)
    jcfg = JLlamaConfig(**TINY)
    tcfg = LlamaConfig(**dataclasses.asdict(jcfg))
    embeds = (rng.standard_normal((2, 12, 64)) * 0.5).astype(np.float32)
    mask = np.ones((2, 12), bool)
    mask[1, :3] = False                                    # left padding
    lj, tj = _greedy_j(pj, jcfg, jnp.asarray(embeds), jnp.asarray(mask), 8, kv8)
    lt, tt = _greedy_t(pt, tcfg, torch.as_tensor(embeds), torch.as_tensor(mask), 8, kv8)
    for a, b in zip(lt, lj):
        assert _rel(a, b) <= 1e-5
    np.testing.assert_array_equal(tt, tj)


def test_int8_params_are_smaller():
    _, pt, _ = _forms("int8")
    dense = params_from_jax(_rand_llama())

    def nbytes(t):
        return sum(x.numel() * x.element_size() for x in _leaves(t))

    assert nbytes(pt["layers"]) < 0.30 * nbytes(dense["layers"])


# ── backends, engines, grammar, checkpoints ─────────────────────────────


@pytest.fixture(scope="module")
def tiny_models():
    return {"llava": build_llava(), "qwen2vl": build_qwen()}


def _backend(family, tmodel):
    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
    from attwarp_tpu_torch.models.llava import LlavaModel
    from attwarp_tpu_torch.models.qwen2vl import Qwen2VLModel

    # a fresh tree per backend: the quantizers work in place
    params = jax.tree_util.tree_map(lambda t: t.clone(), tmodel.params)
    if family == "llava":
        return LlavaBackend(LlavaModel(tmodel.cfg, params), extract_layer=0)
    return Qwen2VLBackend(Qwen2VLModel(tmodel.cfg, params), extract_layer=0)


@pytest.mark.parametrize("family", ["llava", "qwen2vl"])
def test_backend_quantizers_match_jax(tiny_models, family):
    """``quantize_int8``/``quantize_lm_head`` in place on the port's
    backend give JAX's quantized tree on the same weights."""
    from attwarp_tpu.extract.llava_backend import LlavaBackend as JL
    from attwarp_tpu.extract.qwen2vl_backend import Qwen2VLBackend as JQ

    jm, tm = tiny_models[family]
    be = _backend(family, tm)
    layers = be.model.params["llama" if family == "llava" else "text"]["layers"]
    assert be.quantize_int8() is be and be.quantize_lm_head() is be
    assert layers is be.model.params["llama" if family == "llava" else "text"]["layers"]
    jb = (JL(jm) if family == "llava" else JQ(jm, extract_layer=0))
    jb.model = type(jm)(jm.cfg, dict(jm.params))
    jb.quantize_int8().quantize_lm_head()
    _same_tree(be.model.params, jax.device_get(jb.model.params))


@pytest.mark.parametrize("lm8", [False, True], ids=["dense-head", "lm8"])
@pytest.mark.parametrize("chunked", [0, 8], ids=["engine", "chunked"])
@pytest.mark.parametrize("family", ["llava", "qwen2vl"])
def test_engines_int8_kv8_match_generate(tiny_models, family, chunked, lm8):
    """``+int8+kv8`` (and ``+lm8``) through both serving engines: every
    request's tokens equal its own per-request generate on the same int8
    tree."""
    from attwarp_tpu_torch.serving import ChunkedPrefillEngine, ServeEngine

    _, tm = tiny_models[family]
    be = _backend(family, tm).quantize_int8()
    model = (be.quantize_lm_head() if lm8 else be).model
    rng = np.random.default_rng(30)
    if family == "llava":
        reqs = [llava_request(rng, T) for T in (10, 13, 17, 21)]
    else:
        reqs = [qwen_request(rng, T, side) for T, side in ((12, 56), (15, 84), (10, 56))]
    kw = dict(slots=2, max_seq=96, bucket=16, kv_quant=True, steps_per_tick=4)
    eng = (ChunkedPrefillEngine(model, prefill_chunk=chunked, **kw) if chunked
           else ServeEngine(model, **kw))
    rids = [eng.submit(ids, px, max_new_tokens=5) for ids, px in reqs]
    res = eng.run()
    for rid, (ids, px) in zip(rids, reqs):
        assert [int(t) for t in res[rid]] == reference_tokens(model, ids, px, 5, True)


@pytest.mark.parametrize("suffixes", ["+int8+kv8+flash", "+kv8+int8", "+flash+lm8+int8",
                                      "+lm8+kv8", "+int8+lm8+kv8+flash"])
def test_make_backend_int8_suffixes(tiny_models, tmp_path, suffixes):
    """``+int8`` and ``+lm8`` compose with ``+kv8``/``+flash`` in any
    order, on a ``llava-ckpt:`` directory."""
    from attwarp_tpu_torch.cli.process_dataset import make_backend

    _backend("llava", tiny_models["llava"][1]).save(tmp_path / "l")
    be = make_backend(f"llava-ckpt:{tmp_path}/l{suffixes}", 0, "cpu")
    text = be.model.params["llama"]
    parts = suffixes.split("+")
    assert tq.is_quantized(text["layers"][1]["down_proj"]) == ("int8" in parts)
    assert tq.is_quantized(text.get("lm_head", text["embed_tokens"])) == ("lm8" in parts)
    assert be.kv_quant == ("kv8" in parts) and be.use_flash == ("flash" in parts)


def test_int8_checkpoint_round_trip(tiny_models, tmp_path, rng):
    """An int8 tree (``+int8+lm8``) saves and loads exactly: int8 leaves
    stay int8, and the loaded backend's prefill logits equal the saved
    one's."""
    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.models.llava import embed_and_splice

    be = _backend("llava", tiny_models["llava"][1]).quantize_int8().quantize_lm_head()
    be.save(tmp_path / "q")
    back = LlavaBackend.load(tmp_path / "q", "cpu", extract_layer=0)
    assert _keys(back.model.params) == _keys(be.model.params)
    for a, b in zip(_leaves(back.model.params), _leaves(be.model.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ids, px = llava_request(rng, 12)
    ids_t, px_t = torch.as_tensor(ids[None]), torch.as_tensor(px[None])
    mask = torch.ones((1, 12), dtype=torch.bool)
    logits = [llama_prefill(m.params["llama"], m.cfg.text,
                            embed_and_splice(m.params, m.cfg, ids_t, px_t), mask, max_seq=12)[0]
              for m in (be.model, back.model)]
    assert torch.equal(*logits)
