"""Batch-serving CLI (counterpart of ``attwarp_tpu/cli/serve.py``): answer a
stream of (image, question) requests through the continuous-batching engine.

Loads a backend spec (``cli/process_dataset.py::make_backend``, e.g.
``llava-ckpt:<dir>+int8+kv8+flash``) onto ``--device``, reads a JSONL of
``{"image_path"?, "question"}`` or ``{"image_path"?, "input_ids": [...]}``
requests, serves them through ``ServeEngine`` (``ChunkedPrefillEngine``
with ``--chunked-prefill P``) and writes one ``{"question", "answer",
"tokens"}`` line per request. ``--spans PATH`` records the run's spans and
counters (``utils/profiling.py``) and writes them to PATH as JSONL.

    python -m attwarp_tpu_torch.cli.serve \\
        --backend llava-ckpt:/ckpt+kv8+flash \\
        --jsonl requests.jsonl --output answers.jsonl \\
        --slots 16 --max-seq 768 --max-new-tokens 64

The device is never chosen for the caller: ``--device`` defaults to
``cuda`` and a machine without one fails. ``serve`` is the part after the
files: it builds the engine for a loaded backend and serves in-memory
requests.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Continuous-batching MLLM serving (PyTorch)")
    p.add_argument("--backend", required=True,
                   help="'llava:<hf-dir>', 'llava-ckpt:<dir>', 'qwen2vl:<hf-dir>' "
                        "or 'qwen2vl-ckpt:<dir>'; the suffixes '+int8', '+lm8', "
                        "'+kv8' and '+flash' compose in any order")
    p.add_argument("--jsonl", required=True,
                   help="requests: one {image_path?, question} per line; "
                        "ids-level clients may pass {input_ids: [...]} "
                        "instead of question (no tokenizer needed)")
    p.add_argument("--output", required=True, help="answers JSONL")
    p.add_argument("--device", default="cuda",
                   help="torch device of the weights and the engine")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-seq", type=int, default=768)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--steps-per-tick", type=int, default=8)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 samples (per-request 'temperature' "
                        "fields in the JSONL override)")
    p.add_argument("--top-k", type=int, default=0,
                   help="truncate sampling to the k most likely tokens")
    p.add_argument("--seed", type=int, default=0,
                   help="sampling seed (per-request generators derive from it)")
    p.add_argument("--chunked-prefill", type=int, default=0, metavar="P",
                   help="admit prompts in P-token chunks riding the decode "
                        "ticks (ChunkedPrefillEngine) instead of dedicated "
                        "prefills; 0 = monolithic admission")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--spans", default=None, metavar="PATH",
                   help="write the run's spans and counters here as JSONL "
                        "(utils/profiling.py::tracing)")
    return p


def serve(backend, requests: List[Dict], *, slots: int = 8, max_seq: int = 768,
          steps_per_tick: int = 8, top_k: int = 0, seed: int = 0,
          chunked_prefill: int = 0):
    """Build the engine for ``backend`` (its ``kv_quant`` and ``use_flash``)
    and serve ``requests``: dicts with ``input_ids``, ``pixel_values``
    (normalized (S, S, 3) or None), ``max_new_tokens`` and ``temperature``.
    Returns (the engine, for its ``request_stats`` and counts; the generated
    tokens of each request, in order)."""
    from attwarp_tpu_torch.serving import ChunkedPrefillEngine, ServeEngine

    kw = dict(slots=slots, max_seq=max_seq, kv_quant=bool(backend.kv_quant),
              steps_per_tick=steps_per_tick, top_k=top_k, seed=seed)
    if chunked_prefill:
        engine = ChunkedPrefillEngine(backend.model, prefill_chunk=chunked_prefill, **kw)
    else:
        engine = ServeEngine(backend.model, use_flash=bool(backend.use_flash), **kw)
    rids = [engine.submit(r["input_ids"], r.get("pixel_values"),
                          max_new_tokens=r["max_new_tokens"],
                          temperature=r.get("temperature", 0.0))
            for r in requests]
    results = engine.run()
    return engine, [results[rid] for rid in rids]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from attwarp_tpu_torch.cli.process_dataset import make_backend
    from attwarp_tpu_torch.data.imageio import read_rgb
    from attwarp_tpu_torch.utils import profiling

    backend = make_backend(args.backend, layer_index=0, device=args.device)
    with open(args.jsonl) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    if args.limit:
        lines = lines[: args.limit]
    requests = []
    for line in lines:
        ids = (line["input_ids"] if "input_ids" in line
               else backend.build_ids(line["question"]))
        pixels = (backend._preprocess(read_rgb(line["image_path"]))
                  if line.get("image_path") else None)
        requests.append({
            "input_ids": np.asarray(ids, np.int64), "pixel_values": pixels,
            "max_new_tokens": args.max_new_tokens,
            "temperature": float(line.get("temperature", args.temperature))})

    t0 = time.perf_counter()
    with (profiling.tracing(args.spans) if args.spans else contextlib.nullcontext()):
        _, outputs = serve(backend, requests, slots=args.slots, max_seq=args.max_seq,
                           steps_per_tick=args.steps_per_tick, top_k=args.top_k,
                           seed=args.seed, chunked_prefill=args.chunked_prefill)
    dt = time.perf_counter() - t0

    eos = backend.model.cfg.eos_token_id
    n_tok = 0
    with open(args.output, "w") as f:
        for line, toks in zip(lines, outputs):
            n_tok += len(toks)
            if toks and toks[-1] == eos:
                toks = toks[:-1]
            answer = (None if backend.tokenizer is None   # ids-only checkpoint
                      else backend.tokenizer.decode(toks, skip_special_tokens=True).strip())
            f.write(json.dumps({"question": line.get("question"), "answer": answer,
                                "tokens": toks}) + "\n")
    print(f"served {len(requests)} requests / {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s) -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
