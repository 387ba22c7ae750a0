"""The ids-level extraction API, ``device_trace`` and the bench/profile tools
of the port (``attwarp_tpu_torch/tools/``) on the CPU.

``extract_from_ids`` of both families against JAX's on the tiny models of
``test_torch_llava.py`` and ``test_torch_qwen2vl.py`` (f32: greedy tokens
equal, maps within 1e-5), at ``max_new_tokens`` 0 and 4, with Qwen2-VL's
shared and per-sample images; ``extract`` goes through it. Each tool's
``run`` at a tiny size returns its figures and the outputs of the library
call it times; each ``main`` has the JAX tool's positional defaults and
refuses to fall back to the CPU. JAX's Pallas kernels run in interpret
mode where a Qwen2-VL generate reaches them.
"""

import ast
import copy
import functools
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as graft
from attwarp_tpu.extract.llava_backend import LlavaBackend as JLlavaBackend
from attwarp_tpu.extract.qwen2vl_backend import Qwen2VLBackend as JQwenBackend
from attwarp_tpu.models import LlavaModel as JLlavaModel
from attwarp_tpu.models import qwen2vl as jq

from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
from attwarp_tpu_torch.extract.resize import clip_pixels
from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.models import qwen2vl as tq
from attwarp_tpu_torch.models.llama import embed, llama_decode_step
from attwarp_tpu_torch.models.llama import llama_prefill
from attwarp_tpu_torch.models.llava import LlavaModel, params_from_jax
from attwarp_tpu_torch.numerics.quant import quantize_decoder_params
from attwarp_tpu_torch.pipeline import AttWarpPipeline
from attwarp_tpu_torch.serving import ChunkedPrefillEngine, ServeEngine
from attwarp_tpu_torch.tools import (
    bench,
    bench_chunked_qwen_serve,
    bench_chunked_serve,
    bench_decode,
    bench_extract,
    bench_pipeline,
    bench_prefill,
    bench_qwen_decode,
    bench_qwen_prefill,
    bench_qwen_serve,
    bench_serve,
    bench_utils,
    profile_decode_terms,
    profile_pipeline,
    profile_warp_terms,
)
from attwarp_tpu_torch.utils.profiling import device_trace
from attwarp_tpu_torch.warp.warp import warp_batch_by_attention

import test_torch_llava as llava_t
import test_torch_qwen2vl as qwen_t

ROOT = Path(__file__).resolve().parent.parent
LAYER = 1


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def llava():
    jcfg, tcfg = llava_t.tiny_configs()
    jp = graft._random_llava_params(jcfg, jax.random.PRNGKey(0))
    return JLlavaModel(jcfg, jp), LlavaModel(tcfg, params_from_jax(jax.device_get(jp)))


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = qwen_t.tiny_configs()
    tree = qwen_t.numpy_params(jcfg)
    return (jq.Qwen2VLModel(jcfg, jax.tree_util.tree_map(jax.numpy.asarray, tree)),
            tq.Qwen2VLModel(tcfg, params_from_jax(tree)))


# ── extract_from_ids against JAX ────────────────────────────────────────

@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "kv8"])
@pytest.mark.parametrize("new", [4, 0])
def test_llava_extract_from_ids_matches_jax(llava, kv_quant, new):
    """Greedy tokens (B, new) equal and maps (B, 4, 4) within 1e-5 of JAX's;
    at ``new=0`` the prefill row's maps; numpy or tensor inputs alike."""
    jm, tm = llava
    ids, mask, pix, _ = llava_t._inputs(seed=1)
    gj, mj = JLlavaBackend(jm, extract_layer=LAYER, kv_quant=kv_quant).extract_from_ids(
        ids, mask, pix, max_new_tokens=new)
    be = LlavaBackend(tm, extract_layer=LAYER, kv_quant=kv_quant)
    gt, mt = be.extract_from_ids(ids, mask, pix, max_new_tokens=new)
    assert tuple(gt.shape) == gj.shape == (2, new) and gt.dtype == torch.int64
    np.testing.assert_array_equal(gt.numpy(), gj)
    assert tuple(mt.shape) == mj.shape == (2, 4, 4)
    np.testing.assert_allclose(mt.numpy(), mj, atol=1e-5)
    g2, m2 = be.extract_from_ids(_t(ids), _t(mask), _t(pix), max_new_tokens=new)
    assert torch.equal(g2, gt) and torch.equal(m2, mt)


QWEN_CASES = [(False, "shared", 4), (True, "shared", 4), (True, "per_sample", 4),
              (False, "per_sample", 0), (True, "shared", 0)]


@pytest.mark.parametrize("kv_quant,image,new", QWEN_CASES,
                         ids=[f"{'kv8' if k else 'dense'}-{i}-{n}" for k, i, n in QWEN_CASES])
def test_qwen_extract_from_ids_matches_jax(qwen, kv_quant, image, new):
    """One (S, S, 3) image shared by the batch or one per sample: tokens
    equal and maps (B, 2, 2) within 1e-5 of JAX's at T = 256."""
    jm, tm = qwen
    rng = np.random.default_rng(5)
    ids, mask = qwen_t._prompt(256, rng)
    imgs = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    img = imgs[0] if image == "shared" else imgs
    jbe = JQwenBackend(jm, extract_layer=LAYER, image_size=56, kv_quant=kv_quant)
    with pltpu.force_tpu_interpret_mode():
        gj, mj = jbe.extract_from_ids(ids, mask, img, max_new_tokens=new)
    be = Qwen2VLBackend(tm, extract_layer=LAYER, image_size=56, kv_quant=kv_quant)
    gt, mt = be.extract_from_ids(ids, mask, img, max_new_tokens=new)
    assert tuple(gt.shape) == gj.shape == (2, new)
    np.testing.assert_array_equal(gt.numpy(), gj)
    assert tuple(mt.shape) == mj.shape == (2, 2, 2)
    np.testing.assert_allclose(mt.numpy(), mj, atol=1e-5)


def test_shared_image_equals_its_copies(qwen):
    """The shared-image form gives the maps and tokens of the same image
    repeated per sample (1e-5: the vision tower runs at another batch)."""
    _, tm = qwen
    rng = np.random.default_rng(6)
    ids, mask = qwen_t._prompt(256, rng)
    img = rng.standard_normal((56, 56, 3)).astype(np.float32)
    be = Qwen2VLBackend(tm, extract_layer=LAYER, image_size=56, kv_quant=True)
    g1, m1 = be.extract_from_ids(ids, mask, img, max_new_tokens=3)
    g2, m2 = be.extract_from_ids(ids, mask, np.stack([img, img]), max_new_tokens=3)
    assert torch.equal(g1, g2)
    np.testing.assert_allclose(m1.numpy(), m2.numpy(), atol=1e-5)


@pytest.mark.parametrize("family", ["llava", "qwen"])
def test_extract_goes_through_extract_from_ids(llava, qwen, family, monkeypatch):
    """``extract`` calls ``extract_from_ids`` once, on its own prompts and
    CLIP-normalized pixels, and returns its maps bit for bit."""
    rng = np.random.default_rng(7)
    images = [(rng.random((60, 80, 3)) * 255).astype(np.uint8) for _ in range(2)]
    questions = ["what is the text?", "read the label"]
    if family == "llava":
        be = LlavaBackend(llava[1], tokenizer=DryRunTokenizer(), extract_layer=LAYER,
                          kv_quant=True)
        ids, mask, _, pixels = be._prepare(images, questions)
    else:
        be = Qwen2VLBackend(qwen[1], tokenizer=DryRunTokenizer(), extract_layer=LAYER,
                            image_size=56, kv_quant=True)
        ids, mask = be._prompt_ids(questions)
        pixels = clip_pixels(images, 56, torch.device("cpu"))
    gen, want = be.extract_from_ids(ids, mask, pixels, max_new_tokens=3)
    calls = []
    inner = be.extract_from_ids
    monkeypatch.setattr(be, "extract_from_ids",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    maps, texts = be.extract(images, questions, max_new_tokens=3)
    assert len(calls) == 1
    assert torch.equal(maps, want)
    assert texts == be._decode(gen)


# ── device_trace ────────────────────────────────────────────────────────

def _trace_names(path):
    return {e.get("name") for e in json.loads(Path(path).read_text())["traceEvents"]}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with device_trace(tmp_path / "ok") as got:
        torch.mm(a, a)
    assert got is None
    assert "aten::mm" in _trace_names(tmp_path / "ok" / "trace.json")
    assert not torch.autograd._profiler_enabled()


def test_device_trace_stops_when_the_body_raises(tmp_path):
    a = torch.randn(8, 8)
    with pytest.raises(ZeroDivisionError):
        with device_trace(tmp_path / "bad"):
            torch.mm(a, a)
            1 / 0
    assert not torch.autograd._profiler_enabled()
    assert "aten::mm" in _trace_names(tmp_path / "bad" / "trace.json")
    with device_trace(tmp_path / "again"):           # a new trace starts
        torch.mm(a, a)
    assert "aten::mm" in _trace_names(tmp_path / "again" / "trace.json")


# ── bench_utils ─────────────────────────────────────────────────────────

def test_parse_mode_copy_matches_jax():
    """The copy equals ``tools/bench_utils.py::parse_mode``, taken from the
    file's source (importing that module turns on JAX's persistent compile
    cache inside the checkout), in text and over a table of specs."""
    src = (ROOT / "tools" / "bench_utils.py").read_text()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "parse_mode")
    ns = {}
    exec(ast.get_source_segment(src, node), ns)
    assert ast.get_source_segment(src, node) == inspect.getsource(bench_utils.parse_mode).strip()
    for spec in ("bf16", "int8", "bf16+kv8", "int8+kv8", "int8+flash", "int8+flash+kv8",
                 "int8+kv8+flash", "bf16+flash", "+kv8", "int8+kv8+kv8", "int8+lm8+kv8"):
        assert bench_utils.parse_mode(spec) == ns["parse_mode"](spec), spec


def test_repeat_reports_every_repeat(capsys):
    timing, out = bench_utils.repeat(lambda x: x + 1, 3, "cpu", inputs=lambda: (41,))
    assert out == 42 and len(timing["seconds"]) == 3
    assert timing["min"] == min(timing["seconds"]) <= timing["median"]
    assert timing["spread"] == pytest.approx(
        (max(timing["seconds"]) - timing["min"]) / timing["median"])
    bench_utils.report("t", timing, "cpu")
    assert capsys.readouterr().out.rstrip().endswith("| cpu")
    with pytest.raises(ValueError, match="mode"):
        bench_utils.make_llava_7b_backend("fp8", device="cpu")


# ── each tool's run at a tiny size ──────────────────────────────────────

@pytest.fixture(scope="module")
def llava_backend(llava):
    return LlavaBackend(llava[1], tokenizer=DryRunTokenizer(), extract_layer=LAYER,
                        kv_quant=True)


def test_bench_extract_returns_extract_from_ids_maps(llava_backend):
    be = llava_backend
    r = bench_extract.run(be, B=2, repeats=2, iters=1, T=64, new=3)
    assert r["samples_per_s"] > 0 and len(r["timing"]["seconds"]) == 2
    assert (r["ids"][:, 32:48] == 120).all() and r["ids"].shape == (2, 64)
    pixels = clip_pixels(list(r["images"]), be.image_size, be.device)
    gen, maps = be.extract_from_ids(r["ids"], r["mask"], pixels, max_new_tokens=3)
    assert torch.equal(r["maps"], maps) and torch.equal(r["tokens"], gen)


def test_bench_pipeline_returns_the_pipelines_outputs(llava_backend):
    r = bench_pipeline.run(llava_backend, B=2, repeats=1, iters=1)
    assert r["samples_per_s"] > 0
    ref = AttWarpPipeline(llava_backend, warp_size=500, max_new_tokens=20).run(
        r["images"], r["questions"])
    got = r["result"]
    assert got.first_answers == ref.first_answers
    assert got.second_answers == ref.second_answers
    np.testing.assert_array_equal(got.attention_maps, ref.attention_maps)
    np.testing.assert_array_equal(got.warped, ref.warped)


def test_profile_pipeline_runs_the_pipelines_work(llava_backend):
    """The tool reads the spans of ``AttWarpPipeline.run`` itself: one
    figure a span name of the pipeline, none above the run's, and the
    maps, warp and second answers of a plain run on the same images."""
    r = profile_pipeline.run(llava_backend, B=2, iters=1)
    assert set(r["seconds"]) == set(profile_pipeline.PHASES)
    assert all(0 < v <= r["total"] for v in r["seconds"].values())
    ref = AttWarpPipeline(llava_backend, warp_size=500, max_new_tokens=20).run(
        r["images"], r["questions"])
    assert r["answers"] == ref.second_answers
    np.testing.assert_array_equal(r["maps"], ref.attention_maps)
    np.testing.assert_array_equal(r["warped"], ref.warped)


@pytest.mark.parametrize("family", ["llava", "qwen"])
def test_bench_prefill_returns_the_prefills_logits(llava, qwen, family):
    if family == "llava":
        m = llava[1]
        text, cfg = m.params["llama"], m.cfg.text
        r = bench_prefill.run(text, cfg, False, B=2, T=32, repeats=1, iters=2, device="cpu",
                              extract_layer=LAYER)
        logits, _, row = llama_prefill(text, cfg, r["embeds"], r["mask"], max_seq=32,
                                       extract_layer=LAYER)
    else:
        m = qwen[1]
        text, cfg = m.params["text"], m.cfg.text
        r = bench_qwen_prefill.run(text, cfg, False, B=2, T=32, repeats=1, iters=2,
                                   device="cpu", extract_layer=LAYER)
        logits, _, row = tq.qwen2vl_prefill(text, cfg, r["embeds"], r["mask"], r["cos"],
                                            r["sin"], max_seq=32, extract_layer=LAYER)
    assert r["samples_per_s"] > 0 and r["tflops"] is None     # no device figure on a CPU
    assert torch.equal(r["logits"], logits) and torch.equal(r["row"], row)
    with pytest.raises(ValueError):
        bench_prefill.check_mode("flash2")


@pytest.mark.parametrize("family,kv8", [("llava", True), ("llava", False), ("qwen", True)])
def test_bench_decode_tokens_are_the_greedy_chain(llava, qwen, family, kv8):
    """The tool's tokens equal a greedy chain written out here on a fresh
    cache: every step at position 640, its argmax embedded as the next
    input."""
    steps, B = 3, 2
    if family == "llava":
        m = llava[1]
        text, cfg = m.params["llama"], m.cfg.text
        r = bench_decode.run(text, cfg, kv8, B=B, steps=steps, repeats=2, device="cpu")
    else:
        m = qwen[1]
        text, cfg = m.params["text"], m.cfg.text
        r = bench_qwen_decode.run(text, cfg, kv8, B=B, steps=steps, repeats=2, device="cpu")
    kv, kv_mask = bench_decode.decode_cache(cfg, B, steps, kv8, torch.float32, "cpu")
    emb, toks = r["emb0"], []
    for _ in range(steps):
        if family == "llava":
            logits = llama_decode_step(text, cfg, emb, kv, 640, torch.full((B,), 640),
                                       kv_mask)[0]
        else:
            cos, sin = tq.mrope_cos_sin(torch.full((3, B, 1), 640), cfg)
            logits = tq.qwen2vl_decode_step(text, cfg, emb, kv, 640, cos, sin, kv_mask)[0]
        toks.append(torch.argmax(logits, dim=-1))
        emb = embed(text, toks[-1])[:, None, :]
    assert torch.equal(r["tokens"], torch.stack(toks, dim=1))
    assert r["tok_s"] > 0 and len(r["timing"]["seconds"]) == 2


SERVE_CASES = ["serve", "qwen_serve", "chunked", "chunked_qwen"]


@pytest.mark.parametrize("tool", SERVE_CASES)
def test_serve_tools_tokens_are_the_engines(llava, qwen, tool):
    """The measured stream's tokens equal the engine's own ``run`` on the
    same requests; the work counted over the warm-up and measured engines."""
    kw = dict(slots=2, n_req=3, max_new=3, tick=2, repeats=1)
    model = qwen[1] if "qwen" in tool else llava[1]
    if tool == "serve":
        r = bench_serve.run(model, admit=2, **kw)
        eng = ServeEngine(model, slots=2, max_seq=bench_serve.max_seq_for(3, 2), kv_quant=True,
                          steps_per_tick=2, admit_batch=2)
    elif tool == "qwen_serve":
        r = bench_qwen_serve.run(model, admit=2, **kw)
        eng = ServeEngine(model, slots=2, max_seq=bench_serve.max_seq_for(3, 2), kv_quant=True,
                          steps_per_tick=2, admit_batch=2)
    else:
        run = bench_chunked_qwen_serve.run if tool == "chunked_qwen" else bench_chunked_serve.run
        r = run(model, P=128, **kw)
        eng = ChunkedPrefillEngine(model, slots=2, prefill_chunk=128,
                                   max_seq=bench_serve.max_seq_for(3, 2), kv_quant=True,
                                   steps_per_tick=2)
    assert len(r["requests"]) == 3 and all(577 <= len(ids) < 640 for ids in r["requests"])
    for ids in r["requests"]:
        eng.submit(ids, None, max_new_tokens=3)
    out = eng.run()
    assert r["tokens"] == [out[k] for k in sorted(out)]
    assert r["work"]["decode_steps"] > eng.decode_steps > 0
    if tool.startswith("chunked"):
        assert r["work"]["prefill_groups"] == 0
    assert r["runs"][0]["tokens"] == 9 and r["tok_s"] > 0
    with pytest.raises(ValueError, match="chunk_impl"):
        bench_serve.run(model, chunk="unrolled", **kw)


def test_warp_tools_run_the_warp():
    """``bench``'s chain is the warp applied ``iters`` times with the
    carried attention; ``profile_warp_terms`` reports its three terms."""
    r = bench.run("cpu", B=2, img=32, att=4, iters=3, repeats=1)
    images, atts = bench.inputs("cpu", 2, 32, 4)
    out = images
    for _ in range(3):
        out = warp_batch_by_attention(out, atts + out[0, 0, 0, 0] * 1e-20, 32, 32)
    assert torch.equal(r["out"], out) and r["warps_per_s"] > 0
    t = profile_warp_terms.run("cpu", B=2, img=32, att=4, iters=2, repeats=1)
    assert all(t[f"{k}_us_per_image"] > 0 for k in ("full", "grid", "resample"))
    assert t["card"] == "cpu"


@pytest.mark.parametrize("family", ["llava", "qwen"])
def test_profile_decode_terms_runs_every_term(llava, qwen, family):
    m = qwen[1] if family == "qwen" else llava[1]
    text = {**m.params["text" if family == "qwen" else "llama"]}
    text["layers"] = [dict(lp) for lp in text["layers"]]
    quantize_decoder_params(text)
    r = profile_decode_terms.run(text, m.cfg.text, family == "qwen", B=2, steps=2, repeats=1,
                                 device="cpu")
    assert set(r["ms_per_step"]) == {"full", "full_lm8", "kernel", "linears_only",
                                     "lm_head_dense", "lm_head_int8"}
    assert all(v > 0 for v in r["ms_per_step"].values()) and r["max_seq"] == 704


# ── the mains: JAX's defaults, no CPU fallback ──────────────────────────

# (tool, argument, the JAX tool's file:line and the literal there)
DEFAULTS = [
    (bench_pipeline, "mode", "bench_pipeline.py", 29, '"int8+flash"'),
    (bench_pipeline, "batch", "bench_pipeline.py", 30, "16"),
    (bench_extract, "mode", "bench_extract.py", 31, '"bf16"'),
    (bench_extract, "batch", "bench_extract.py", 37, "1"),
    (bench_prefill, "mode", "bench_prefill.py", 23, '"dense"'),
    (bench_prefill, "batch", "bench_prefill.py", 24, "8"),
    (bench_prefill, "seqlen", "bench_prefill.py", 25, "640"),
    (bench_decode, "mode", "bench_decode.py", 28, '"bf16"'),
    (bench_decode, "batch", "bench_decode.py", 35, "1"),
    (bench_decode, "steps", "bench_decode.py", 39, "16"),
    (bench_serve, "mode", "bench_serve.py", 27, '"int8+kv8"'),
    (bench_serve, "slots", "bench_serve.py", 33, "8"),
    (bench_serve, "requests", "bench_serve.py", 34, "24"),
    (bench_serve, "max_new", "bench_serve.py", 35, "32"),
    (bench_serve, "chunk_impl", "bench_serve.py", 36, '"auto"'),
    (bench_serve, "tick", "bench_serve.py", 37, "8"),
    (bench_serve, "admit", "bench_serve.py", 38, "4"),
    (bench_serve, "admit_cold", "bench_serve.py", 41, "0"),
    (bench_qwen_prefill, "mode", "bench_qwen_prefill.py", 25, '"dense"'),
    (bench_qwen_prefill, "batch", "bench_qwen_prefill.py", 26, "8"),
    (bench_qwen_prefill, "seqlen", "bench_qwen_prefill.py", 27, "640"),
    (bench_qwen_decode, "mode", "bench_qwen_decode.py", 29, '"int8+kv8"'),
    (bench_qwen_decode, "batch", "bench_qwen_decode.py", 36, "16"),
    (bench_qwen_decode, "steps", "bench_qwen_decode.py", 38, "16"),
    (bench_qwen_serve, "mode", "bench_qwen_serve.py", 26, '"int8+kv8"'),
    (bench_qwen_serve, "slots", "bench_qwen_serve.py", 32, "32"),
    (bench_qwen_serve, "requests", "bench_qwen_serve.py", 33, "3 * SLOTS"),
    (bench_qwen_serve, "max_new", "bench_qwen_serve.py", 34, "128"),
    (bench_qwen_serve, "chunk_impl", "bench_qwen_serve.py", 35, '"auto"'),
    (bench_qwen_serve, "tick", "bench_qwen_serve.py", 36, "16"),
    (bench_qwen_serve, "admit", "bench_qwen_serve.py", 37, "4"),
    (bench_chunked_serve, "mode", "bench_chunked_serve.py", 26, '"int8+kv8"'),
    (bench_chunked_serve, "slots", "bench_chunked_serve.py", 30, "32"),
    (bench_chunked_serve, "requests", "bench_chunked_serve.py", 31, "3 * SLOTS"),
    (bench_chunked_serve, "max_new", "bench_chunked_serve.py", 32, "128"),
    (bench_chunked_serve, "P", "bench_chunked_serve.py", 33, "160"),
    (bench_chunked_serve, "tick", "bench_chunked_serve.py", 34, "16"),
    (bench_chunked_qwen_serve, "mode", "bench_chunked_qwen_serve.py", 24, '"int8+kv8"'),
    (bench_chunked_qwen_serve, "slots", "bench_chunked_qwen_serve.py", 28, "64"),
    (bench_chunked_qwen_serve, "requests", "bench_chunked_qwen_serve.py", 29, "3 * SLOTS"),
    (bench_chunked_qwen_serve, "max_new", "bench_chunked_qwen_serve.py", 30, "128"),
    (bench_chunked_qwen_serve, "P", "bench_chunked_qwen_serve.py", 31, "320"),
    (bench_chunked_qwen_serve, "tick", "bench_chunked_qwen_serve.py", 32, "16"),
    (profile_pipeline, "mode", "profile_pipeline.py", 21, '"int8+flash"'),
    (profile_pipeline, "batch", "profile_pipeline.py", 22, "16"),
    (profile_warp_terms, "img", "profile_warp_terms.py", 32, "336"),
    (profile_warp_terms, "batch", "profile_warp_terms.py", 33, "128"),
    (profile_warp_terms, "att", "profile_warp_terms.py", 34, "24"),
    (profile_warp_terms, "iters", "profile_warp_terms.py", 35, "200"),
    (profile_warp_terms, "out", "profile_warp_terms.py", 36, '""'),
    (profile_decode_terms, "family", "profile_decode_terms.py", 55, '"qwen"'),
    (profile_decode_terms, "batch", "profile_decode_terms.py", 56, "0"),
    (profile_decode_terms, "steps", "profile_decode_terms.py", 57, "16"),
    (profile_decode_terms, "out", "profile_decode_terms.py", 58, '""'),
]


def test_main_defaults_match_the_jax_tools():
    """Each port tool's defaults, in its positional order, equal the JAX
    tool's ``sys.argv`` (or argparse) defaults at the file:line of the
    table, whose lines are read from the JAX tools' sources."""
    order = {}
    for mod, dest, fname, line, literal in DEFAULTS:
        src = (ROOT / "tools" / fname).read_text().splitlines()[line - 1]
        assert f"else {literal}" in src or f"default={literal}" in src, (fname, line, src)
        got = getattr(mod.parser().parse_args([]), dest)
        want = None if literal == "3 * SLOTS" else ast.literal_eval(literal)
        assert got == want, (mod.__name__, dest, got, want)
        order.setdefault(mod, []).append(dest)
    for mod, dests in order.items():
        positional = [a.dest for a in mod.parser()._actions if not a.option_strings]
        if positional:
            assert positional == dests, mod.__name__
    # requests None is 3 x slots, as the JAX tools' default
    assert inspect.signature(bench_qwen_serve.run).parameters["n_req"].default is None
    assert bench.BATCH == 128 and bench.IMG == 336 and bench.ATT == 24 and bench.ITERS == 200


MAINS = [bench_pipeline, bench_extract, bench_prefill, bench_decode, bench_serve,
         bench_qwen_prefill, bench_qwen_decode, bench_qwen_serve, bench_chunked_serve,
         bench_chunked_qwen_serve, profile_pipeline, profile_warp_terms, bench,
         profile_decode_terms]


# (tool, its argv at a tiny size): each main wired to its run, on the CPU,
# with the 7B factory swapped for the tiny models
MAIN_ARGS = [
    (bench_pipeline, ["bf16+kv8", "2", "--trace", "{tmp}"]),
    (bench_extract, ["bf16+kv8+flash", "1"]),
    (bench_prefill, ["flash", "2", "64"]),
    (bench_qwen_prefill, ["dense", "2", "64"]),
    (bench_decode, ["int8+kv8+lm8", "2", "3"]),
    (bench_qwen_decode, ["int8+kv8", "2", "3"]),
    (bench_serve, ["bf16+kv8+flash", "2", "3", "3", "auto", "2", "2", "0"]),
    (bench_qwen_serve, ["int8+kv8", "2", "3", "3", "auto", "2", "2"]),
    (bench_chunked_serve, ["int8+kv8", "2", "3", "3", "128", "2"]),
    (bench_chunked_qwen_serve, ["bf16+kv8", "2", "3", "3", "128", "2"]),
    (profile_pipeline, ["bf16+kv8", "2"]),
    (profile_warp_terms, ["--img", "32", "--batch", "2", "--att", "4", "--iters", "2"]),
    (profile_decode_terms, ["--family", "llava", "--batch", "2", "--steps", "2"]),
]


def _tiny_factory(family, llava, qwen):
    """A stand-in for ``make_*_7b_backend``: a copy of the tiny model,
    flags and int8 weights by the mode spec, as the 7B factories set them."""
    def make(mode_spec="bf16", extract_layer=20, tokenizer=None, seed=0, device="cuda"):
        mode, kv8, flash = bench_utils.parse_mode(mode_spec)
        assert torch.device(device).type == "cpu"
        if family == "llava":
            m = llava[1]
            be = LlavaBackend(LlavaModel(m.cfg, copy.deepcopy(m.params)), tokenizer=tokenizer,
                              extract_layer=LAYER, kv_quant=kv8, use_flash=flash)
        else:
            m = qwen[1]
            be = Qwen2VLBackend(tq.Qwen2VLModel(m.cfg, copy.deepcopy(m.params)),
                                tokenizer=tokenizer, extract_layer=LAYER, image_size=56,
                                kv_quant=kv8, use_flash=flash)
        if mode == "int8":
            be.quantize_int8()
        return be, bench_utils.mode_label(mode, kv8, flash)
    return make


@pytest.mark.parametrize("mod,argv", MAIN_ARGS,
                         ids=[m.__name__.rsplit(".", 1)[1] for m, _ in MAIN_ARGS])
def test_main_runs_its_tool_on_the_asked_device(llava, qwen, mod, argv, monkeypatch,
                                                tmp_path, capsys):
    """``main(argv + ["--device", "cpu"])`` parses the JAX tool's positional
    arguments, builds its weights through the factory and runs; every
    figure line names the device."""
    targets = [bench_chunked_serve] if mod is bench_chunked_qwen_serve else [mod]
    for t in targets:
        for name, fam in (("make_llava_7b_backend", "llava"),
                          ("make_qwen2vl_7b_backend", "qwen")):
            if hasattr(t, name):
                monkeypatch.setattr(t, name, _tiny_factory(fam, llava, qwen))
    if mod in (bench_prefill, bench_qwen_prefill):       # the tiny decoders have 3 layers
        monkeypatch.setattr(mod, "run", functools.partial(mod.run, extract_layer=LAYER))
    out = ["--out", str(tmp_path / "terms.json")] if mod.__name__.endswith("_terms") else []
    argv = [a.format(tmp=tmp_path / "trace") for a in argv]
    assert mod.main(argv + out + ["--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "repeats " in ln or " iter " in ln]
    assert lines and all(ln.endswith("| cpu") for ln in lines)
    if out:
        assert json.loads((tmp_path / "terms.json").read_text())["card"] == "cpu"
    if "--trace" in argv:        # the repeats ran inside device_trace
        assert "aten::mm" in _trace_names(tmp_path / "trace" / "trace.json")
    if mod is bench_chunked_serve:
        with pytest.raises(ValueError, match="flash"):
            mod.main(["bf16+kv8+flash", "--device", "cpu"])


@pytest.mark.parametrize("mod", MAINS, ids=[m.__name__.rsplit(".", 1)[1] for m in MAINS])
def test_main_refuses_to_run_on_the_cpu(mod):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would run the 7B tool")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_new_modules_import_no_jax():
    """The tools, the backends and ``utils/profiling.py`` pull neither
    ``jax`` nor ``attwarp_tpu`` (nor the root ``tools`` package) into
    ``sys.modules``."""
    mods = [m.__name__ for m in MAINS] + [
        "attwarp_tpu_torch.tools.bench_utils", "attwarp_tpu_torch.utils.profiling",
        "attwarp_tpu_torch.extract.llava_backend", "attwarp_tpu_torch.extract.qwen2vl_backend"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'attwarp_tpu', 'tools')"
            " or m.startswith(('jax.', 'attwarp_tpu.', 'tools.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env, timeout=300)
