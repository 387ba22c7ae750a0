"""TextVQA accuracy evaluation CLI (counterpart of
``attwarp_tpu/cli/evaluate.py``): scores the warped images of a processed
dataset's ``metadata/`` directory, and with ``--score-original`` the
originals too.

    python -m attwarp_tpu_torch.cli.evaluate --model reader \\
        --metadata-dir processed/metadata --output-dir eval \\
        --score-original --batch-size 8

``--model`` takes the backend specs of ``cli/process_dataset.py`` (JAX's
default ``mini`` is not ported, so it is required); ``--device`` defaults
to ``cuda``; ``--serve-slots N`` answers through the continuous-batching
``ServeEngine`` (backends with a tokenizer).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Evaluate MLLM accuracy on TextVQA (warped images, PyTorch)")
    p.add_argument("--metadata-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--model", type=str, required=True,
                   help="backend spec: 'reader', 'llava-ckpt:<dir>' or "
                        "'qwen2vl-ckpt:<dir>' ('+kv8' and '+flash' suffixes compose)")
    p.add_argument("--layer-index", type=str, default="20",
                   help="extraction layer for the answering backend")
    p.add_argument("--device", default="cuda", help="torch device of the weights")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--score-original", action="store_true",
                   help="also score the unwarped images and report the "
                        "warped-vs-original accuracy delta")
    p.add_argument("--batch-size", type=int, default=1,
                   help=">1 answers samples in batched prefill+decode calls "
                        "(real backends): same scores, higher throughput")
    p.add_argument("--serve-slots", type=int, default=0,
                   help=">0 answers through the continuous-batching "
                        "ServeEngine with this many slots (real backends "
                        "with a tokenizer; implies batching)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from attwarp_tpu_torch.cli.process_dataset import make_backend
    from attwarp_tpu_torch.eval.harness import (
        EngineAnswerBackend,
        ExtractionAnswerBackend,
        evaluate_textvqa_accuracy,
    )

    inner = make_backend(args.model, args.layer_index, args.device)
    if hasattr(inner, "build_ids") and inner.tokenizer is None:
        # without one every answer fails and the sample leaves the count
        raise SystemExit(f"{args.model!r} has no tokenizer; answering needs one")
    batch = args.batch_size
    if args.serve_slots > 0:
        if not hasattr(inner, "build_ids"):
            raise SystemExit(f"--serve-slots needs a real backend with a tokenizer; "
                             f"{args.model!r} has no serving path")
        backend = EngineAnswerBackend(inner, slots=args.serve_slots,
                                      max_new_tokens=args.max_new_tokens)
        batch = max(batch, 4 * args.serve_slots)  # keep the slot pool fed
    else:
        backend = ExtractionAnswerBackend(inner, max_new_tokens=args.max_new_tokens)
    res = evaluate_textvqa_accuracy(
        args.metadata_dir,
        args.output_dir,
        backend,
        model_name=args.model,
        max_new_tokens=args.max_new_tokens,
        limit=args.limit,
        score_original=args.score_original,
        batch_size=batch,
    )
    print(f"Overall Warped Accuracy: {res['overall_warped_accuracy']:.4f} "
          f"({res['total_samples_evaluated']} samples)")
    if "accuracy_gain" in res:
        print(f"Original Accuracy: {res['overall_original_accuracy']:.4f} | "
              f"Warped-vs-Original Gain: {res['accuracy_gain']:+.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
