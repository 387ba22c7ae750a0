"""The port's TextVQA accuracy harness (``eval.harness``, ``cli.evaluate``)
and its copy of the VQA answer scoring against the JAX package.

Both harnesses read the same metadata, written by the port's driver with
the reader proxy on code-tag scenes. Answers, per-sample scores and
accuracies must be equal: the reader and the tiny LLaVA (f32, weights
through ``params_from_jax``) answer identically on both sides. The
engine-backed answering is held to the port's own batched answering, as
the JAX harness's tests hold JAX's.
"""

import glob
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from attwarp_tpu.eval import vqa_text as jvqa
from attwarp_tpu.eval.harness import ExtractionAnswerBackend as JExtraction
from attwarp_tpu.eval.harness import evaluate_textvqa_accuracy as j_evaluate
from attwarp_tpu.extract.llava_backend import LlavaBackend as JLlavaBackend
from attwarp_tpu.testing import reader as jreader
from tools.make_random_7b_ckpt import build_dry_run_tokenizer

from attwarp_tpu_torch.cli import evaluate as ev
from attwarp_tpu_torch.cli import process_dataset as pd
from attwarp_tpu_torch.eval import vqa_text as tvqa
from attwarp_tpu_torch.eval.harness import (
    ANSWER_SUFFIX,
    EngineAnswerBackend,
    ExtractionAnswerBackend,
    evaluate_textvqa_accuracy,
)
from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.serving import ServeEngine
from attwarp_tpu_torch.testing import reader as treader

from test_torch_llava import models  # noqa: F401  (module-scoped fixture)

ANSWERS = [
    "Two", "the cat.", "no. 5", "No 12", "number.3", "number 3", "it's", "dont", "cant",
    "3.5", "1,000", "a b c", "hello!!", "yes?", "(x)", "ten dogs", "an apple", "",
    "x." * 40, "Über-café", "e.g. this; that", "don't / won't", "100%", "1 , 2",
    "what's up?", "  spaced   out  ", "A", "none", "youll", "5f3a9c0d12e4b7a8",
]


def test_vqa_text_copy_matches():
    for a in ANSWERS:
        assert tvqa.process_text(a) == jvqa.process_text(a), a
        assert tvqa.process_punctuation(a) == jvqa.process_punctuation(a), a
        assert tvqa.process_digit_article(a) == jvqa.process_digit_article(a), a
    for i, pred in enumerate(ANSWERS):
        gts = ANSWERS[i:i + 10] + [pred] * (i % 4)
        assert tvqa.get_acc(pred, gts) == jvqa.get_acc(pred, gts)
        for th in (1, 3):
            assert tvqa.calculate_vqa_accuracy(pred, gts, th) == \
                jvqa.calculate_vqa_accuracy(pred, gts, th)


@pytest.fixture(scope="module")
def metadata(tmp_path_factory):
    """Eleven code-tag scenes through the port's driver (the reader, on the
    CPU), plus a metadata file without answers and one whose warped image
    is gone, which both harnesses skip."""
    root = tmp_path_factory.mktemp("eval")
    json_path, image_dir = treader.write_textvqa_dataset(str(root / "data"), n=11, seed=5)
    stats = pd.process_dataset(json_path, image_dir, str(root / "processed"),
                               treader.ReaderBackend(), batch_size=6, device="cpu")
    assert stats == {"processed": 11, "failed": 0}
    meta_dir = root / "processed" / "metadata"
    first = json.load(open(sorted(meta_dir.glob("*.json"))[0]))
    with open(meta_dir / "zz_noanswers_metadata.json", "w") as f:
        json.dump({**first, "sample_id": "noanswers", "answers": []}, f)
    gone = {**first, "sample_id": "gone"}
    gone["saved_paths"] = {**first["saved_paths"],
                           "warped_image_identity": str(root / "missing.png")}
    with open(meta_dir / "zz_gone_metadata.json", "w") as f:
        json.dump(gone, f)
    return str(meta_dir)


def _artifacts(out_dir):
    """File names with the timestamp taken out, and the summary's text."""
    names = sorted(re.sub(r"\d{8}_\d{6}", "TS", n) for n in os.listdir(out_dir))
    summary = open(glob.glob(os.path.join(out_dir, "*_summary.txt"))[0]).read()
    return names, summary


def test_harness_matches_jax_on_the_reader(metadata, tmp_path):
    got = evaluate_textvqa_accuracy(metadata, str(tmp_path / "t"),
                                    ExtractionAnswerBackend(treader.ReaderBackend()),
                                    score_original=True)
    want = j_evaluate(metadata, str(tmp_path / "j"),
                      JExtraction(jreader.ReaderBackend()), score_original=True)
    assert got == want
    assert got["total_samples_evaluated"] == 11
    assert got["overall_warped_accuracy"] > got["overall_original_accuracy"]
    assert _artifacts(tmp_path / "t") == _artifacts(tmp_path / "j")
    names, _ = _artifacts(tmp_path / "t")
    assert "textvqa_moving_accuracy_TS.csv" in names     # written at sample 10


def test_harness_batched_equals_sequential(metadata, tmp_path):
    kw = dict(score_original=True, limit=9)
    seq = evaluate_textvqa_accuracy(metadata, str(tmp_path / "s"),
                                    ExtractionAnswerBackend(treader.ReaderBackend()), **kw)
    bat = evaluate_textvqa_accuracy(metadata, str(tmp_path / "b"),
                                    ExtractionAnswerBackend(treader.ReaderBackend()),
                                    batch_size=4, **kw)
    assert bat == seq and seq["total_samples_evaluated"] == 9


def test_harness_llava_matches_jax(models, metadata, tmp_path):  # noqa: F811
    """A tiny LLaVA (int8 KV cache) answering in batches of 4 on both sides."""
    jm, tm = models
    jbe = JLlavaBackend(jm, tokenizer=build_dry_run_tokenizer(), extract_layer=1,
                        kv_quant=True)
    tbe = LlavaBackend(tm, tokenizer=DryRunTokenizer(), extract_layer=1, kv_quant=True)
    kw = dict(score_original=True, limit=5, batch_size=4, max_new_tokens=3)
    want = j_evaluate(metadata, str(tmp_path / "j"), JExtraction(jbe), **kw)
    jax.effects_barrier()
    got = evaluate_textvqa_accuracy(metadata, str(tmp_path / "t"),
                                    ExtractionAnswerBackend(tbe), **kw)
    assert got == want and got["total_samples_evaluated"] == 5


def _tiny_backend(tm, kv_quant=False):
    return LlavaBackend(tm, tokenizer=DryRunTokenizer(), extract_layer=1, kv_quant=kv_quant)


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((40, 44, 3)).astype(np.float32) for _ in range(n)]


QS = ["what is shown here", "read the label", "what is the code on the tag",
      "what is the text"]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "kv8"])
def test_engine_answer_backend_matches_extraction(models, kv_quant):  # noqa: F811
    """Engine answers equal the batched decode's, an oversized prompt
    included: it leaves the engine and is answered like the rest."""
    be = _tiny_backend(models[1], kv_quant)
    imgs = _images(4)
    L = max(len(be.build_ids(q + ANSWER_SUFFIX)) for q in QS)
    seq = ExtractionAnswerBackend(be, max_new_tokens=4)
    eng = EngineAnswerBackend(be, slots=2, max_seq=-(-L // 64) * 64 + 6, max_new_tokens=4,
                              steps_per_tick=2)
    a = seq.answer_many(imgs, QS, 4)
    assert eng.answer_many(imgs, QS, 4) == a
    assert eng.answer(imgs[0], QS[0], 4) == a[0] == seq.answer(imgs[0], QS[0], 4)
    long_q = "word " * 200 + "what does it say"
    assert len(be.build_ids(long_q + ANSWER_SUFFIX)) > eng.engine.max_seq
    got = eng.answer_many([imgs[0], imgs[1], imgs[2]], [QS[0], long_q, QS[2]], 4)
    assert all(isinstance(x, str) for x in got)
    assert got[0] == a[0] and got[2] == a[2]
    assert got[1] == seq.answer(imgs[1], long_q, 4)


def test_engine_answer_backend_sizing_and_retirement(models, monkeypatch, capsys):  # noqa: F811
    """The engine is built on the first chunk, sized from its prompts; a
    failed engine is retired and answering goes on through the batched
    decode; at 8 slots one failure rebuilds it at 4 for the same chunk."""
    be = _tiny_backend(models[1])
    imgs, qs = _images(3, 1), QS[:3]
    ref = ExtractionAnswerBackend(be, max_new_tokens=4).answer_many(imgs, qs, 4)

    eng = EngineAnswerBackend(be, slots=2, max_new_tokens=4, steps_per_tick=2)
    assert eng.engine is None
    assert eng.answer_many(imgs, qs, 4) == ref
    L = max(len(be.build_ids(q + ANSWER_SUFFIX)) for q in qs)
    assert eng.engine.max_seq == -(-L // 64) * 64 + 4 + 2 and eng.engine.slots == 2

    real = ServeEngine.run

    def boom(self):
        raise RuntimeError("injected engine failure")

    monkeypatch.setattr(ServeEngine, "run", boom)
    assert eng.answer_many(imgs, qs, 4) == ref
    assert eng.engine is None and eng._engine_dead
    assert eng.answer_many(imgs, qs, 4) == ref      # stays on the batched decode
    assert eng.answer(imgs[0], qs[0], 4) == ref[0]

    calls = {"n": 0}

    def boom_once(self):
        if calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected engine failure")
        return real(self)

    monkeypatch.setattr(ServeEngine, "run", boom_once)
    eng2 = EngineAnswerBackend(be, slots=8, max_new_tokens=4, steps_per_tick=2)
    assert eng2.answer_many(imgs, qs, 4) == ref
    assert eng2.engine is not None and not eng2._engine_dead
    assert eng2.engine.slots == 4 and eng2.slots == 4
    assert eng2.answer_many(imgs, qs, 4) == ref     # stays on the engine
    assert "rebuilding at 4 slots (was 8)" in capsys.readouterr().out


def test_evaluate_cli_main(metadata, tmp_path, capsys, models):  # noqa: F811
    out = str(tmp_path / "eval")
    args = ["--metadata-dir", metadata, "--output-dir", out]
    assert ev.main(args + ["--model", "reader", "--device", "cpu", "--score-original",
                           "--batch-size", "4"]) == 0
    printed = capsys.readouterr().out
    res = json.load(open(glob.glob(os.path.join(out, "textvqa_accuracy_*[0-9].json"))[0]))
    assert res["total_samples_evaluated"] == 11 and res["model"] == "reader"
    assert f"Overall Warped Accuracy: {res['overall_warped_accuracy']:.4f} (11 samples)" in printed
    assert f"Gain: {res['accuracy_gain']:+.4f}" in printed
    assert ev.build_parser().parse_args(args + ["--model", "reader"]).device == "cuda"
    with pytest.raises(SystemExit):                     # --model is required
        ev.build_parser().parse_args(args)
    with pytest.raises(SystemExit, match="no serving path"):
        ev.main(args + ["--model", "reader", "--device", "cpu", "--serve-slots", "2"])
    LlavaBackend(models[1]).save(tmp_path / "ckpt")      # a checkpoint has no tokenizer
    with pytest.raises(SystemExit, match="no tokenizer"):
        ev.main(args + ["--model", f"llava-ckpt:{tmp_path / 'ckpt'}", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no tokenizer"):
        pd.main(["--jsonl", str(tmp_path / "none.jsonl"), "--output-dir", str(tmp_path / "o"),
                 "--backend", f"llava-ckpt:{tmp_path / 'ckpt'}", "--device", "cpu"])


def test_chain_needs_no_pillow_opencv_or_jax(tmp_path):
    """Write a code-tag dataset, run both CLIs on it on the CPU, in a process
    where Pillow, OpenCV and JAX cannot be imported."""
    code = f"""
import sys
for name in ("PIL", "cv2", "jax"):
    sys.modules[name] = None
from attwarp_tpu_torch.cli import evaluate, process_dataset
from attwarp_tpu_torch.testing.reader import write_textvqa_dataset
root = {str(tmp_path)!r}
j, d = write_textvqa_dataset(root + "/data", n=2, seed=0)
assert process_dataset.main(["--textvqa-json", j, "--image-dir", d, "--output-dir",
                             root + "/out", "--backend", "reader", "--device", "cpu",
                             "--width", "64", "--height", "64"]) == 0
assert evaluate.main(["--metadata-dir", root + "/out/metadata", "--output-dir",
                      root + "/eval", "--model", "reader", "--device", "cpu",
                      "--score-original"]) == 0
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "(2 samples)" in res.stdout
