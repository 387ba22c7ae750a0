"""The port's spans and counters (``utils/profiling.py``) on the CPU, at a
tiny LLaVA and Qwen2-VL: the off path touches nothing, the recorder gives
the span tree of a pipeline run and of the serving engines, and under a
``torch.profiler`` session every span is a ``user_annotation`` on the
clock of the exported spans."""

import json

import numpy as np
import pytest
import torch

from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.kernels import _build
from attwarp_tpu_torch.kernels.warp_resample import k1_plan
from attwarp_tpu_torch.models import llava as tl
from attwarp_tpu_torch.models import qwen2vl as tq
from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig
from attwarp_tpu_torch.models.llama import LlamaConfig
from attwarp_tpu_torch.pipeline import AttWarpPipeline
from attwarp_tpu_torch.serving import ChunkedPrefillEngine, ServeEngine
from attwarp_tpu_torch.utils import profiling

K = 3   # new tokens a pass
QUESTIONS = ["what is the text on the label", "read the code", "what color is it"]


def _images():
    rng = np.random.default_rng(0)
    # two raw shapes: two warp groups
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((60, 80), (60, 80), (72, 64))]


@pytest.fixture(scope="module")
def llava():
    cfg = tl.LlavaConfig(
        vision=ClipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2, image_size=56, patch_size=14),
        text=LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2),
        image_token_index=120)
    params = tl.random_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    return LlavaBackend(tl.LlavaModel(cfg, params), tokenizer=DryRunTokenizer(),
                        extract_layer=1, kv_quant=True)


@pytest.fixture(scope="module")
def qwen():
    cfg = tq.Qwen2VLConfig(
        vision=tq.Qwen2VLVisionConfig(depth=2, embed_dim=32, hidden_size=64, num_heads=2,
                                      mlp_ratio=2),
        text=tq.Qwen2VLTextConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                  num_hidden_layers=3, num_attention_heads=4,
                                  num_key_value_heads=2, mrope_section=(2, 3, 3)),
        image_token_id=97, vision_start_token_id=96, vision_end_token_id=95,
        pad_token_id=1, eos_token_id=2)
    params = tq.random_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    return Qwen2VLBackend(tq.Qwen2VLModel(cfg, params), tokenizer=DryRunTokenizer(),
                          extract_layer=1, image_size=56, kv_quant=True)


def _run(backend):
    return AttWarpPipeline(backend, warp_size=40, max_new_tokens=K).run(_images(), QUESTIONS)


def _same(a, b):
    np.testing.assert_array_equal(a.warped, b.warped)
    np.testing.assert_array_equal(a.attention_maps, b.attention_maps)
    assert all(np.array_equal(x, y) for x, y in zip(a.mota_masks, b.mota_masks))
    assert (a.first_answers, a.second_answers) == (b.first_answers, b.second_answers)


def _raise(*a, **k):
    raise AssertionError("touched while tracing is off")


def _counting(monkeypatch, names=("cpu", "tolist", "item")):
    """Count every device fetch the program makes."""
    seen = {n: 0 for n in names}
    for n in names:
        orig = getattr(torch.Tensor, n)

        def counted(self, *a, _orig=orig, _n=n, **k):
            seen[_n] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, n, counted)
    return seen


@pytest.mark.parametrize("family", ["llava", "qwen"])
def test_off_path_enters_nothing_and_the_outputs_equal_a_traced_run(
        llava, qwen, family, monkeypatch):
    """With neither the recorder nor a profiler on, no span reaches
    ``record_function`` or the clock and nothing is recorded; the spans add
    no device fetch and no synchronisation; the outputs equal a run with
    the recorder on."""
    backend = llava if family == "llava" else qwen
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    with profiling.tracing() as rec:
        on_fetches = _counting(monkeypatch)
        traced = _run(backend)
    monkeypatch.undo()
    assert rec.spans and rec.counters["decode_steps"] == 2 * K
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    monkeypatch.setattr(profiling, "record_function", _raise)
    monkeypatch.setattr(profiling, "clock_ns", _raise)
    off_fetches = _counting(monkeypatch)
    plain = _run(backend)
    assert off_fetches == on_fetches
    _same(plain, traced)
    assert profiling.span("decode_step") is profiling.span("decode_step")
    assert profiling.begin("serve.queued", rid=0) is None
    profiling.count("decode_steps")   # no recorder: dropped


def _tree(rec):
    by_id = {s["id"]: s for s in rec.spans}
    return by_id, {s["id"]: (by_id[s["parent"]]["name"] if s["parent"] else None)
                   for s in rec.spans}


@pytest.mark.parametrize("family", ["llava", "qwen"])
def test_pipeline_run_gives_the_span_tree(llava, qwen, family, tmp_path):
    backend = llava if family == "llava" else qwen
    with profiling.tracing(tmp_path / "spans.jsonl") as rec:
        _run(backend)
    by_id, parent = _tree(rec)
    names = [s["name"] for s in rec.spans]
    root = [s for s in rec.spans if s["parent"] is None]
    assert [s["name"] for s in root] == ["pipeline.run"]
    assert {s["batch"] for s in rec.spans} == {root[0]["batch"]}   # one batch id throughout
    want_parent = {
        "pipeline.resize": {"pipeline.run"}, "pipeline.group": {"pipeline.run"},
        "backend.extract": {"pipeline.run"}, "backend.answer": {"pipeline.run"},
        "pipeline.to_host": {"pipeline.run", "pipeline.group"},
        "pipeline.mask": {"pipeline.group"}, "pipeline.warp": {"pipeline.group"},
        "backend.prepare": {"backend.extract", "backend.answer"},
        "backend.detokenize": {"backend.extract", "backend.answer"},
        "vision": {"backend.extract", "backend.answer"},
        "prefill": {"backend.extract", "backend.answer"},
        "decode_step": {"backend.extract", "backend.answer"},
        "mrope_positions": {"backend.extract", "backend.answer"},
    }
    for s in rec.spans:
        if s["parent"] is not None:
            assert parent[s["id"]] in want_parent[s["name"]], (s["name"], parent[s["id"]])
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    # one decode step per new token per pass
    steps = [parent[s["id"]] for s in rec.spans if s["name"] == "decode_step"]
    assert steps.count("backend.extract") == K and steps.count("backend.answer") == K
    for name in ("backend.extract", "backend.answer", "pipeline.run"):
        assert names.count(name) == 1
    for name in ("vision", "prefill", "backend.prepare", "backend.detokenize",
                 "pipeline.resize"):
        assert names.count(name) == 2, name
    groups = [s for s in rec.spans if s["name"] == "pipeline.group"]
    assert sorted(g["n"] for g in groups) == [1, 2]
    assert names.count("pipeline.mask") == names.count("pipeline.warp") == 2
    assert names.count("mrope_positions") == (2 if family == "qwen" else 0)
    prefills = [s for s in rec.spans if s["name"] == "prefill"]
    assert all(p["B"] == 3 and p["T"] % 64 == 0 for p in prefills)
    c = rec.counters
    assert c["decode_steps"] == 2 * K and c["k1.calls"] == 2
    assert c["prefill_positions"] == sum(p["B"] * p["T"] for p in prefills)
    assert 0 < c["prefill_tokens"] < c["prefill_positions"]
    L = backend.model.cfg.text.num_hidden_layers
    assert c["k3.calls"] == 2 * K * L - K   # every layer but the extract layer in pass 1
    assert c["k1.plan_misses"] == 0        # no K1 plan on the CPU
    lines = [json.loads(x) for x in (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert lines[-1] == {"counters": c}
    assert len(lines) == len(rec.spans) + 1
    starts = [x["start_ns"] for x in lines[:-1]]
    assert starts == sorted(starts)


@pytest.mark.parametrize("engine", ["serve", "chunked"])
def test_engine_spans_and_queue_wait(llava, engine):
    """Each request's ``serve.queued`` span (its rid, from submit to
    admission) and ``request_stats[rid]["admitted"]``; the tick's spans."""
    model = llava.model
    kw = dict(slots=2, max_seq=256, kv_quant=True, steps_per_tick=2)
    eng = (ServeEngine(model, **kw) if engine == "serve"
           else ChunkedPrefillEngine(model, prefill_chunk=32, **kw))
    rng = np.random.default_rng(1)
    pix = rng.standard_normal((56, 56, 3)).astype(np.float32)
    with profiling.tracing() as rec:
        rids = [eng.submit(llava.build_ids(q), pix, max_new_tokens=3) for q in QUESTIONS]
        eng.run()
    queued = {s["rid"]: s for s in rec.spans if s["name"] == "serve.queued"}
    assert sorted(queued) == rids
    for rid in rids:
        st = eng.request_stats[rid]
        assert st["submit"] <= st["admitted"] <= st["first_token"] <= st["done"]
        assert queued[rid]["parent"] is None
    # the third request waits for a free slot
    assert queued[2]["end_ns"] > max(queued[r]["end_ns"] for r in (0, 1))
    by_id, parent = _tree(rec)
    names = [s["name"] for s in rec.spans]
    ticks = names.count("serve.tick")
    assert ticks > 0 and names.count("serve.fetch") == names.count("serve.harvest") == ticks
    for s in rec.spans:
        if s["name"] in ("decode_step", "serve.fetch", "serve.harvest"):
            assert parent[s["id"]] == "serve.tick", s
        if s["name"] == "serve.prefill_group":
            assert parent[s["id"]] == "serve.admit" and s["n"] >= 1 and s["Tb"] % 64 == 0
    assert rec.counters["decode_steps"] == eng.decode_steps
    assert rec.counters["prefill_tokens"] == sum(len(llava.build_ids(q)) for q in QUESTIONS)
    if engine == "serve":
        assert names.count("serve.prefill_group") == eng.prefill_groups
    # no recorder: queue wait is still in request_stats, no span is kept
    eng2 = ServeEngine(model, **kw)
    rid = eng2.submit(llava.build_ids(QUESTIONS[0]), pix, max_new_tokens=2)
    eng2.run()
    assert "admitted" in eng2.request_stats[rid] and not eng2._queued


@pytest.mark.parametrize("family", ["llava", "qwen"])
def test_spans_are_annotations_on_the_trace_clock(llava, qwen, family, tmp_path):
    """Under ``device_trace`` each span is a ``user_annotation`` of its
    name, and each exported span lies within 1 ms of its annotation on the
    trace's clock (``ts * 1000 + baseTimeNanoseconds``)."""
    backend = llava if family == "llava" else qwen
    # the first annotation of a process pays the profiler's lazy set-up
    # (~1 ms) between its stamp and the span's: a first session takes it
    with profiling.device_trace(tmp_path / "first"):
        _run(backend)
    with profiling.tracing() as rec, profiling.device_trace(tmp_path):
        _run(backend)
    data = json.loads((tmp_path / "trace.json").read_text())
    base = data.get("baseTimeNanoseconds", 0)
    ann = {}
    for e in data["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            s = float(e["ts"]) * 1000 + base
            ann.setdefault(e["name"], []).append((s, s + float(e["dur"]) * 1000))
    spans = {}
    for s in rec.spans:
        spans.setdefault(s["name"], []).append((s["start_ns"], s["end_ns"]))
    assert set(spans) == set(ann)
    for name, got in spans.items():
        assert len(ann[name]) == len(got), name
        for (s, e), (a0, a1) in zip(sorted(got), sorted(ann[name])):
            assert abs(s - a0) < 1e6 and abs(e - a1) < 1e6, name


def test_decorator_stage_timer_and_plan_misses(tmp_path):
    @profiling.span("work")
    def work(x):
        return x + 1

    timer = profiling.StageTimer(tmp_path / "stages.jsonl")
    with profiling.tracing() as rec:
        assert work(1) == 2
        with timer.stage("extract"):
            work(2)
        for _ in range(2):   # one new plan, then a hit
            k1_plan(3, 97, 89, 3, 41, 43, 132)
    timer.close()
    assert work(3) == 4   # off again: nothing more recorded
    names = [s["name"] for s in rec.spans]
    assert sorted(names) == ["extract", "work", "work"]
    inner = next(s for s in rec.spans if s["name"] == "work" and s["parent"] is not None)
    assert rec.spans[names.index("extract")]["id"] == inner["parent"]
    assert rec.counters["k1.plan_misses"] == 1
    assert timer.summary()["extract"]["count"] == 1
    assert [json.loads(x)["stage"] for x in open(tmp_path / "stages.jsonl")] == ["extract"]


def test_library_builds_counts_only_a_build_that_ran_nvcc(tmp_path, monkeypatch):
    lib = tmp_path / "libattwarp_kernels_test.so"
    ran = []

    def fake_run(cmds):
        ran.append(cmds)
        for c in cmds:   # the link writes the library
            if "-shared" in c:
                open(c[c.index("-o") + 1], "w").close()
        return ""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run", fake_run)
    with profiling.tracing() as rec:
        assert _build.build() == lib
        assert _build.build() == lib   # built: loaded as it is
    assert len(ran) == 2 and rec.counters["kernels.library_builds"] == 1


def test_serve_cli_writes_spans(llava, tmp_path):
    from attwarp_tpu_torch.cli import serve

    llava.save(tmp_path / "ckpt")
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps({"input_ids": llava.build_ids(q)}) + "\n"
                            for q in QUESTIONS))
    out = tmp_path / "spans.jsonl"
    assert serve.main(["--backend", f"llava-ckpt:{tmp_path / 'ckpt'}+kv8", "--device", "cpu",
                       "--jsonl", str(reqs), "--output", str(tmp_path / "answers.jsonl"),
                       "--slots", "2", "--max-seq", "256", "--max-new-tokens", "3",
                       "--spans", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert sorted(x["rid"] for x in lines if x.get("name") == "serve.queued") == [0, 1, 2]
    assert lines[-1]["counters"]["decode_steps"] > 0
