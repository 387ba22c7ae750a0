"""The port's sequence-parallel prefill (``parallel/sp_prefill.py``: ring
attention over the data axis) against the JAX package.

``sp_prefill`` and ``sp_prefill_qwen`` run on spawned gloo ranks, two and
four of them (one spawn each, every case inside: ``tests/
torch_parallel_ranks.py``), and are held against JAX's dense
``llama_prefill``/``qwen2vl_prefill`` on the same weights (the JAX tests'
tiny configs and ``_params``), with and without left padding, for one
extract layer, a tuple of layers and none: logits, rows and the cache at
valid positions within 1e-5; with ``kv_quant`` the int8 caches equal and
their scales within 1e-6 (pad slots differ by construction, as in JAX).
JAX's own ``sp_prefill`` is compiled at n=2 only (its ``shard_map`` at
n=4/8 compiles for minutes on the CPU). Decode continues from the ring's
cache with the port's decode step: its greedy tokens equal those from the
dense cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from attwarp_tpu.models.llama import LlamaConfig as JLlamaConfig
from attwarp_tpu.models.llama import llama_prefill as j_prefill
from attwarp_tpu.models.qwen2vl import Qwen2VLTextConfig as JQwenText
from attwarp_tpu.models.qwen2vl import qwen2vl_prefill as j_qwen_prefill
from attwarp_tpu.parallel.sp_prefill import sp_prefill as j_sp_prefill

from attwarp_tpu_torch.models.llama import LlamaConfig, llama_prefill
from attwarp_tpu_torch.models.llava import params_from_jax
from attwarp_tpu_torch.testing.ranks import run_ranks

import torch_parallel_ranks as jobs
from test_sp_prefill import _mrope_tables, _params, _qwen_params

TEXT = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2)
QWEN = dict(TEXT, mrope_section=(2, 3, 3))
T, B, MAX_SEQ = 16, 2, 24
EXTRACTS = {"none": None, "one": 1, "tuple": (0, 2)}


def _case(pad: bool):
    rng = np.random.default_rng(21)
    embeds = (rng.standard_normal((B, T, 64)) * 0.5).astype(np.float32)
    mask = np.ones((B, T), bool)
    if pad:
        mask[1, :5] = False
    return embeds, mask


@pytest.fixture(scope="module")
def llama():
    cfg = JLlamaConfig(**TEXT)
    params = _params(cfg)
    return cfg, params, jax.device_get(params)


@pytest.fixture(scope="module")
def qwen():
    cfg = JQwenText(**QWEN)
    params = _qwen_params(cfg)
    out = {}
    for pad in (False, True):
        embeds, mask = _case(pad)
        cos, sin = _mrope_tables(cfg, mask, np.random.default_rng(0))
        out[pad] = (embeds, mask, np.asarray(cos), np.asarray(sin))
    return cfg, params, jax.device_get(params), out


def _jobs(llama, qwen, decode):
    _, _, tree = llama
    _, _, qtree, qcases = qwen
    todo = []
    for pad in (False, True):
        embeds, mask = _case(pad)
        for name, ex in EXTRACTS.items():
            for kv in (False, True):
                todo.append((("sp", pad, name, kv), "sp",
                             dict(tree=tree, cfg=TEXT, embeds=embeds, mask=mask,
                                  max_seq=MAX_SEQ, extract_layer=ex, kv_quant=kv,
                                  decode=decode if name == "none" else 0)))
        e, m, cos, sin = qcases[pad]
        for name, ex in EXTRACTS.items():
            for kv in (False, True):
                todo.append((("qwen", pad, name, kv), "sp_qwen",
                             dict(tree=qtree, cfg=QWEN, embeds=e, mask=m, cos=cos, sin=sin,
                                  max_seq=MAX_SEQ, extract_layer=ex, kv_quant=kv)))
    embeds, mask = _case(True)
    todo.append(("errors", "sp_errors", dict(tree=tree, cfg=TEXT, embeds=embeds, mask=mask)))
    return todo


@pytest.fixture(scope="module")
def ranks(llama, qwen):
    return {n: run_ranks(jobs.run_jobs, n, (_jobs(llama, qwen, decode=3),)) for n in (2, 4)}


@pytest.fixture(scope="module")
def dense(llama, qwen):
    """JAX's dense prefill of every case, (family, pad, extract, kv_quant)
    -> (logits, cache, rows), as numpy."""
    out = {}
    for pad in (False, True):
        embeds, mask = _case(pad)
        e, m, cos, sin = qwen[3][pad]
        for name, ex in EXTRACTS.items():
            for kv in (False, True):
                runs = {
                    "sp": lambda: j_prefill(llama[1], llama[0], jnp.asarray(embeds),
                                            jnp.asarray(mask), max_seq=MAX_SEQ,
                                            extract_layer=ex, kv_quant=kv),
                    "qwen": lambda: j_qwen_prefill(
                        qwen[1], qwen[0], jnp.asarray(e), jnp.asarray(m), jnp.asarray(cos),
                        jnp.asarray(sin), max_seq=MAX_SEQ, extract_layer=ex, kv_quant=kv),
                }
                for family, run in runs.items():
                    logits, cache, rows = run()
                    out[(family, pad, name, kv)] = (
                        np.asarray(logits), [np.asarray(c) for c in cache],
                        None if rows is None else np.asarray(rows))
    return out


def _check_cache(got, want, mask, kv):
    """The cache at valid prompt positions: 1e-5 dense; int8 equal and the
    scales within 1e-6 quantized; the slots past T zero."""
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape
        gv, wv = g[:, :, :T][:, mask], w[:, :, :T][:, mask]
        if kv and i % 2 == 0:
            np.testing.assert_array_equal(gv, wv)
        else:
            np.testing.assert_allclose(gv, wv, atol=1e-6 if kv else 1e-5)
        assert not g[:, :, T:].any()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("family", ["sp", "qwen"], ids=["llama", "qwen"])
@pytest.mark.parametrize("pad", [False, True], ids=["no_pad", "left_pad"])
@pytest.mark.parametrize("extract", list(EXTRACTS))
def test_sp_prefill_matches_dense(ranks, dense, n, family, pad, extract):
    """Every rank's logits, rows and caches (dense and ``kv_quant``) against
    JAX's dense prefill."""
    ex = EXTRACTS[extract]
    mask = _case(pad)[1]
    for kv in (False, True):
        ld, cd, rd = dense[(family, pad, extract, kv)]
        for out in ranks[n]:
            logits, cache, rows, _ = (out[(family, pad, extract, kv)] + (None,))[:4]
            np.testing.assert_allclose(logits, np.asarray(ld), rtol=1e-5, atol=1e-5)
            if ex is None:
                assert rows is None and rd is None
            else:
                np.testing.assert_allclose(rows, np.asarray(rd), rtol=1e-5, atol=1e-5)
            _check_cache(cache, cd, mask, kv)


def test_sp_prefill_matches_jax_sp_prefill(ranks, llama):
    """Against JAX's own ring prefill at n=2 (left padding, extract layer 1;
    each ``shard_map`` call compiles for ~40 s on the CPU, so one case)."""
    cfg, params, _ = llama
    pad = True
    embeds, mask = _case(pad)
    ls, cs, rs = j_sp_prefill(params, cfg, jnp.asarray(embeds), jnp.asarray(mask),
                              Mesh(np.asarray(jax.devices()[:2]), ("sp",)), axis="sp",
                              max_seq=MAX_SEQ, extract_layer=1)
    for out in ranks[2]:
        logits, cache, rows, _ = out[("sp", pad, "one", False)]
        np.testing.assert_allclose(logits, np.asarray(ls), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rows, np.asarray(rs), rtol=1e-5, atol=1e-5)
        _check_cache(cache, cs, mask, False)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "kv8"])
def test_decode_continues_from_sp_cache(ranks, llama, kv_quant):
    """Three greedy decode steps (the port's ``llama_decode_step``; K3's
    plain form on the int8 cache) from the ring's cache: the same tokens as
    from the dense prefill's cache, with and without left padding."""
    _, _, tree = llama
    cfg, params = LlamaConfig(**TEXT), params_from_jax(tree)
    for pad in (False, True):
        embeds, mask = _case(pad)
        m = torch.as_tensor(mask)
        logits, cache, _ = llama_prefill(params, cfg, torch.as_tensor(embeds), m,
                                         max_seq=MAX_SEQ, kv_quant=kv_quant)
        want = jobs._greedy_decode(params, cfg, cache, logits, m, 3).numpy()
        for n in (2, 4):
            for out in ranks[n]:
                np.testing.assert_array_equal(out[("sp", pad, "none", kv_quant)][3], want)


def test_sp_rejects_indivisible_length_and_short_cache(ranks):
    """T not divisible by the axis and ``max_seq`` < T raise ``ValueError``
    with JAX's messages."""
    for n in (2, 4):
        for out in ranks[n]:
            short_t, short_cache = out["errors"]
            assert short_t == f"prompt length {T - 1} not divisible by data={n}"
            assert short_cache == f"max_seq={T - 1} < prompt length T={T}"


def test_sp_ranks_import_no_jax(ranks):
    assert not any(out["jax_imported"] for outs in ranks.values() for out in outs)


def test_qwen_config_copy_is_the_ranks_config():
    """The rank rebuilds Qwen's text config from the JAX config's fields."""
    from attwarp_tpu_torch.models.qwen2vl import Qwen2VLTextConfig

    assert dataclasses.asdict(Qwen2VLTextConfig(**QWEN)) == dataclasses.asdict(JQwenText(**QWEN))
