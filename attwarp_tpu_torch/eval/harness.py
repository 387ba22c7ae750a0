"""TextVQA accuracy harness over a processed dataset's metadata (counterpart
of ``attwarp_tpu/eval/harness.py``).

Parity with ``evaluate_accuracy.py:275-473``: reads the driver's
``saved_paths`` metadata (``warped_image_identity``), answers on each
warped image with the reference's prompt suffix, scores with the binary
VQA accuracy at threshold 1 and writes the same artifacts: a per-sample
detailed log, a moving-average CSV every 10 samples, an interim JSON every
100, the final JSON and a summary. Images are read with
``data/imageio.py``.

A backend answers ``answer(image_rgb, question, max_new_tokens) -> str``
and, for batches, ``answer_many``: ``ExtractionAnswerBackend`` over an
extraction backend (the answer-only ``answer_batch`` where it has one) or
``EngineAnswerBackend`` over the continuous-batching ``ServeEngine``.
"""

from __future__ import annotations

import gc
import glob
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from attwarp_tpu_torch.data.imageio import read_rgb
from attwarp_tpu_torch.eval.vqa_text import calculate_vqa_accuracy
from attwarp_tpu_torch.extract.resize import resize_for_backend

ANSWER_SUFFIX = "Answer in a single word or key phrase."


class ExtractionAnswerBackend:
    """Adapts an extraction backend (``extract(images, questions)``) to the
    harness's ``answer`` interface. Backends with ``answer_batch`` (LLaVA,
    Qwen2-VL) answer through it: a generate that builds no attention row
    and accumulates nothing."""

    def __init__(self, backend, max_new_tokens: int = 64):
        self.backend = backend
        self.max_new_tokens = max_new_tokens

    def answer(self, image_rgb: np.ndarray, question: str,
               max_new_tokens: Optional[int] = None) -> str:
        img = resize_for_backend(image_rgb, self.backend.image_size)
        mnt = max_new_tokens or self.max_new_tokens
        q = question + ANSWER_SUFFIX
        if hasattr(self.backend, "answer_batch"):
            return self.backend.answer_batch(img[None], [q], max_new_tokens=mnt)[0]
        _maps, texts = self.backend.extract(img[None], [q], max_new_tokens=mnt)
        return texts[0]

    def answer_many(self, images, questions,
                    max_new_tokens: Optional[int] = None) -> List[str]:
        """One batched prefill + decode for the chunk where the inner
        backend has ``answer_batch``; a call per sample otherwise."""
        if not hasattr(self.backend, "answer_batch"):
            return [self.answer(im, q, max_new_tokens)
                    for im, q in zip(images, questions)]
        mnt = max_new_tokens or self.max_new_tokens
        imgs = np.stack([resize_for_backend(im, self.backend.image_size)
                         for im in images])
        return self.backend.answer_batch(imgs, [q + ANSWER_SUFFIX for q in questions],
                                         max_new_tokens=mnt)


class EngineAnswerBackend:
    """Answers through the continuous-batching ``ServeEngine``: every
    buffered sample becomes a request and the slot pool decodes them
    together (the reference answers one sample at a time,
    evaluate_accuracy.py:329-349).

    The engine is built on the first chunk, with ``max_seq`` sized from its
    tokenized prompts (bucket + answer + one tick) unless given; a longer
    prompt later goes through the backend's batched decode. A failed engine
    is rebuilt once at half the slots (when that leaves at least 4), then
    retired for good, the chunk and all later ones going through the
    batched decode."""

    def __init__(self, backend, slots: int = 8, max_seq: Optional[int] = None,
                 max_new_tokens: int = 64, steps_per_tick: int = 8):
        self.backend = backend
        self.max_new_tokens = max_new_tokens
        self.slots = slots
        self.steps_per_tick = steps_per_tick
        self._max_seq_cfg = max_seq
        self.engine = None
        self._engine_dead = False

    def _fit_slots(self, max_seq: int, kv_quant: bool) -> int:
        """The slot count whose cache fits beside what is already on the
        device. Budget: the device's free memory plus what PyTorch's
        allocator holds unused (``torch.cuda.mem_get_info``; the weights are
        already allocated, so they are out of it), less a startup
        admission block of up to 8 slots' rows, 8% for fragmentation and
        1 GiB, as the engine's own cold-admission cap reads it. Element
        sizes are the cache's: int8 K/V plus an f32 scale per token and
        head, or the weights' dtype for a dense cache. The CPU counts as
        unlimited."""
        dev = self.backend.device
        if dev.type != "cuda":
            return self.slots
        model = self.backend.model
        t = model.cfg.text
        if kv_quant:
            max_seq = -(-max_seq // 64) * 64   # the int8 cache's 64-multiple
            per_elem = 1 + 4 / t.head_dim
        else:                                  # the engine's dense cache dtype
            text = model.params["llama"] if "llama" in model.params else model.params["text"]
            per_elem = text["embed_tokens"].element_size()
        per_slot = 2 * t.num_hidden_layers * t.kv_heads * t.head_dim * max_seq * per_elem
        free, _total = torch.cuda.mem_get_info(dev)
        avail = free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        budget = int(avail * 0.92) - (1 << 30) - min(8, self.slots) * per_slot
        fit = max(1, int(budget // per_slot))
        if fit < self.slots:
            print(f"EngineAnswerBackend: reducing slots {self.slots} -> {fit} "
                  f"(per-slot cache {per_slot / 2**20:.0f} MiB at max_seq={max_seq}, "
                  f"{avail / 2**30:.1f} GiB available)")
        return min(self.slots, fit)

    def _ensure_engine(self, prompt_lens: List[int], mnt: int) -> None:
        if self.engine is not None or self._engine_dead or not prompt_lens:
            return
        from attwarp_tpu_torch.serving import ServeEngine

        backend = self.backend
        if self._max_seq_cfg is not None:
            max_seq = self._max_seq_cfg
        else:
            max_bucketed = max(-(-n // 64) * 64 for n in prompt_lens)
            # upper cap: image tokens + 192 of text, the answer, one tick, slack
            n_img = int(backend.num_patches_side) ** 2
            cap = (-(-(n_img + 192) // 64) * 64
                   + self.max_new_tokens + self.steps_per_tick + 64)
            max_seq = min(max_bucketed + mnt + self.steps_per_tick, cap)
        kv_quant = bool(getattr(backend, "kv_quant", False))
        self.engine = ServeEngine(
            backend.model, slots=self._fit_slots(max_seq, kv_quant),
            max_seq=max_seq, kv_quant=kv_quant,
            steps_per_tick=self.steps_per_tick,
            use_flash=bool(getattr(backend, "use_flash", False)),
        )

    def _retire_engine(self, dead: bool = True) -> None:
        """Drop the engine and its KV cache, and give the memory back to the
        device, so the fallback's allocations fit. Call it OUTSIDE the
        ``except`` block of the engine's failure: the live traceback holds
        ``engine.run``'s frames, and with them the cache. ``dead=False``
        keeps the engine path open for a rebuild at fewer slots."""
        self._engine_dead = dead
        self.engine = None
        gc.collect()
        if self.backend.device.type == "cuda":
            torch.cuda.empty_cache()

    def _decode(self, toks) -> str:
        if toks and toks[-1] == self.backend.model.cfg.eos_token_id:
            toks = toks[:-1]
        return self.backend.tokenizer.decode(toks, skip_special_tokens=True).strip()

    def answer(self, image_rgb, question, max_new_tokens=None) -> str:
        return self.answer_many([image_rgb], [question], max_new_tokens)[0]

    def _fits(self, ids, mnt: int) -> bool:
        eng = self.engine
        bucketed = -(-len(ids) // eng.bucket) * eng.bucket
        return bucketed + mnt + eng.steps_per_tick <= eng.max_seq

    def answer_many(self, images, questions, max_new_tokens=None) -> List[str]:
        mnt = max_new_tokens or self.max_new_tokens
        size = self.backend.image_size
        ids_all = [np.asarray(self.backend.build_ids(q + ANSWER_SUFFIX), np.int64)
                   for q in questions]
        self._ensure_engine([len(x) for x in ids_all], mnt)
        # a prompt longer than the engine's max_seq neither fails the chunk
        # nor leaves the eval's denominator: it goes through the backend's
        # batched decode, which buckets by its own length
        answers: List[Optional[str]] = [None] * len(images)
        rids, engine_idx, overflow_idx = [], [], []
        if self.engine is None:       # retired (or nothing to size from)
            overflow_idx = list(range(len(images)))
        else:
            for attempt in range(2):
                failed = None
                try:
                    rids, engine_idx, overflow_idx = [], [], []
                    for i, (im, ids) in enumerate(zip(images, ids_all)):
                        if not self._fits(ids, mnt):
                            overflow_idx.append(i)
                            continue
                        px = self.backend._preprocess(resize_for_backend(im, size))
                        rids.append(self.engine.submit(ids, px, max_new_tokens=mnt))
                        engine_idx.append(i)
                    results = self.engine.run()
                    break
                except Exception as e:
                    failed = str(e)   # the message only: the exception's
                    #                   traceback would keep the engine alive
                half = max(1, self.engine.slots // 2)
                rids, engine_idx = [], []
                results = {}
                if attempt == 0 and half >= 4:
                    print(f"ServeEngine failed ({failed}); rebuilding at "
                          f"{half} slots (was {self.engine.slots}).")
                    self._retire_engine(dead=False)
                    self.slots = half
                    self._ensure_engine([len(x) for x in ids_all], mnt)
                    if self.engine is not None:
                        continue
                    overflow_idx = list(range(len(images)))
                    break
                print(f"ServeEngine failed ({failed}); retiring the engine "
                      "and answering via the batched decode path.")
                self._retire_engine()
                overflow_idx = list(range(len(images)))
                break
        for i, r in zip(engine_idx, rids):
            answers[i] = self._decode(results[r])
        if overflow_idx:
            imgs = np.stack([resize_for_backend(images[i], size) for i in overflow_idx])
            outs = self.backend.answer_batch(
                imgs, [questions[i] + ANSWER_SUFFIX for i in overflow_idx],
                max_new_tokens=mnt)
            for i, o in zip(overflow_idx, outs):
                answers[i] = o
        return answers


def evaluate_textvqa_accuracy(
    metadata_dir: str,
    output_dir: str,
    backend,
    model_name: str = "attwarp-tpu-mllm",
    max_new_tokens: int = 64,
    limit: Optional[int] = None,
    score_original: bool = False,
    batch_size: int = 1,
) -> Dict:
    """Score the warped images of ``metadata_dir`` (and with
    ``score_original`` the originals, for the warped-vs-original gain).
    ``batch_size > 1`` buffers samples and answers each chunk through
    ``backend.answer_many``; scores and artifacts are those of the
    sequential run, in the same order."""
    os.makedirs(output_dir, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    moving_avg_log = os.path.join(output_dir, f"textvqa_moving_accuracy_{ts}.csv")
    detailed_log = os.path.join(output_dir, f"textvqa_detailed_log_{ts}.txt")

    with open(detailed_log, "w", encoding="utf-8") as f:
        f.write("TEXTVQA FULL EVALUATION - DETAILED LOG\n")
        f.write(f"Model: {model_name}\n")
        f.write(f"Timestamp: {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
        f.write("Evaluation Metric: Standard VQA accuracy with text preprocessing "
                "(min(0.3*n, 1), n=matching answers)\n")
        f.write("=" * 80 + "\n\n")

    files = sorted(glob.glob(os.path.join(metadata_dir, "*.json")))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"No metadata JSON files found in {metadata_dir}")

    overall = {"warped": {"correct": 0, "total": 0},
               "original": {"correct": 0, "total": 0}}
    detailed: List[Dict] = []
    counter = 0

    batch_n = batch_size if (batch_size > 1 and hasattr(backend, "answer_many")) else 1
    pending: List[Dict] = []

    def score_one(p, raw, oraw):
        nonlocal counter
        if raw is None:
            return
        sample_id, question, gts = p["sample_id"], p["question"], p["gts"]
        correct = calculate_vqa_accuracy(raw.strip(), gts, threshold=1)
        record = {
            "sample_id": sample_id,
            "question": question,
            "ground_truth_answers": gts,
            "warped_answer": raw,
            "warped_correct": bool(correct),
        }
        # the paper's claim is the warped-vs-original difference; the
        # reference harness scored only warped images
        if oraw is not None:
            ocorrect = calculate_vqa_accuracy(oraw.strip(), gts, threshold=1)
            overall["original"]["total"] += 1
            overall["original"]["correct"] += int(ocorrect)
            record["original_answer"] = oraw
            record["original_correct"] = bool(ocorrect)

        overall["warped"]["total"] += 1
        overall["warped"]["correct"] += int(correct)
        counter += 1
        detailed.append(record)

        tot = overall["warped"]["total"]
        cor = overall["warped"]["correct"]
        with open(detailed_log, "a", encoding="utf-8") as f:
            f.write("\n" + "=" * 80 + "\n")
            f.write(f"SAMPLE: {sample_id} - {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
            f.write("-" * 80 + "\n")
            f.write(f"QUESTION: {question}\n\n")
            f.write(f"GROUND TRUTH ANSWERS: {gts}\n\n")
            f.write(f"WARPED IMAGE ANSWER:   {raw} (Correct: {correct})\n\n")
            f.write("CURRENT OVERALL STATS:\n")
            f.write(f"  Warped accuracy:   {cor / max(1, tot):.4f} ({cor}/{tot})\n")

        if counter % 10 == 0:
            exists = os.path.exists(moving_avg_log)
            with open(moving_avg_log, "a") as f:
                if not exists:
                    f.write("Timestamp,Iteration,Total_Samples,Warped_Accuracy\n")
                f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')},{counter},{tot},"
                        f"{cor / max(1, tot):.4f}\n")
        if counter % 100 == 0:
            interim = {
                "model": model_name,
                "overall_warped_accuracy": cor / max(1, tot),
                "total_samples_processed": tot,
                "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
            }
            with open(os.path.join(output_dir,
                                   f"textvqa_interim_results_{ts}_{counter}.json"), "w") as f:
                json.dump(interim, f, indent=2)

    def answer_all(images, questions):
        """Batched answering with a per-sample fallback: one bad sample (or
        an oversized prompt) must not discard the rest of the chunk."""
        if batch_n > 1:
            try:
                return backend.answer_many(images, questions, max_new_tokens)
            except Exception as e:
                print(f"Batched answering failed ({e}); per-sample fallback.")
        out = []
        for im, q in zip(images, questions):
            try:
                out.append(backend.answer(im, q, max_new_tokens))
            except Exception as e:
                print(f"Error answering sample: {e}. Skipping.")
                out.append(None)
        return out

    def flush():
        if not pending:
            return
        answers = answer_all([p["img"] for p in pending], [p["question"] for p in pending])
        oanswers = [None] * len(pending)
        if score_original:
            have = [i for i, p in enumerate(pending) if p["oimg"] is not None]
            if have:
                outs = answer_all([pending[i]["oimg"] for i in have],
                                  [pending[i]["question"] for i in have])
                for i, o in zip(have, outs):
                    oanswers[i] = o
        for p, raw, oraw in zip(pending, answers, oanswers):
            try:
                score_one(p, raw, oraw)
            except Exception as e:
                print(f"Error scoring {p['sample_id']}: {e}. Skipping.")
        pending.clear()

    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as f:
                meta = json.load(f)
            sample_id = meta.get("sample_id")
            question = meta.get("question")
            gts = meta.get("answers")
            saved = meta.get("saved_paths", {})
            warped_path = saved.get("warped_image_identity")
            if not sample_id or not question or not isinstance(gts, list) or not gts:
                continue
            if not warped_path or not os.path.exists(warped_path):
                continue
            img = read_rgb(warped_path)
            oimg = None
            if score_original:
                orig_path = saved.get("original_image")
                if orig_path and os.path.exists(orig_path):
                    oimg = read_rgb(orig_path)
            pending.append({
                "sample_id": sample_id,
                "question": question,
                "gts": [str(g).strip() for g in gts],
                "img": img,
                "oimg": oimg,
            })
            if len(pending) >= batch_n:
                flush()
        except Exception as e:
            print(f"Error processing {path}: {e}. Skipping.")
            continue
    flush()

    tot = overall["warped"]["total"]
    cor = overall["warped"]["correct"]
    acc = cor / tot if tot else 0.0
    final = {
        "model": model_name,
        "dataset": "TextVQA",
        "evaluation_metric": ("Standard VQA accuracy with text preprocessing "
                              "(min(0.3*n, 1), n=matching answers)"),
        "overall_warped_accuracy": acc,
        "total_samples_evaluated": tot,
        "detailed_results": detailed,
    }
    if score_original and overall["original"]["total"]:
        oacc = overall["original"]["correct"] / overall["original"]["total"]
        final["overall_original_accuracy"] = oacc
        final["accuracy_gain"] = acc - oacc
    with open(os.path.join(output_dir, f"textvqa_accuracy_{ts}.json"), "w",
              encoding="utf-8") as f:
        json.dump(final, f, indent=2, ensure_ascii=False)
    with open(os.path.join(output_dir, f"textvqa_accuracy_{ts}_summary.txt"), "w",
              encoding="utf-8") as f:
        f.write("TextVQA Accuracy Evaluation\n")
        f.write(f"Model: {model_name}\n")
        f.write(f"Total samples evaluated: {tot}\n")
        f.write(f"Evaluation Metric: {final['evaluation_metric']}\n\n")
        f.write(f"Overall accuracy on warped images: {acc:.4f} ({cor}/{tot})\n")
    return final
