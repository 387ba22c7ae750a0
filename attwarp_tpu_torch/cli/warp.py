"""Single-image attention-guided warp CLI (C3; counterpart of
``attwarp_tpu/cli/warp.py``).

Parity with the ``new_method.py`` CLI (new_method.py:508-581): same flags,
same ``run_N`` output-directory convention, same artifact set (original,
masked overlay, warped, optional 3-panel visualization strip), through
``warp/io.py::save_warped_image``; plus ``--device`` (default ``cuda``,
where the warp is kernel K1). ``--second-pass`` answers the question on the
warped image with a backend spec of ``cli/process_dataset.py`` (``mini`` by
default, as in JAX), loaded before the warp so that a spec that fails to
load fails before anything is written.

    python -m attwarp_tpu_torch.cli.warp --image photo.jpg \\
        --attention-map att.npy --transform sqrt --output-dir runs
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from attwarp_tpu_torch.warp.io import next_run_dir, save_warped_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Attention-Based Non-Uniform Image Warping (PyTorch)"
    )
    p.add_argument("--image", required=True, help="Path to input image file")
    p.add_argument(
        "--attention-map", required=True, help="Path to attention map .npy file"
    )
    p.add_argument(
        "--output", default="warped.png", help="Base filename for warped output image"
    )
    p.add_argument(
        "--output-dir", default="output_runs", help="Base directory for run_N outputs"
    )
    p.add_argument(
        "--visualization", default=None,
        help="Base filename for visualization with input, attention map, and output",
    )
    p.add_argument("--width", type=int, default=500, help="Target width")
    p.add_argument("--height", type=int, default=500, help="Target height")
    p.add_argument(
        "--transform",
        choices=["identity", "square", "sqrt", "exp", "log"],
        default="identity",
        help="Attention transformation function",
    )
    p.add_argument("--exp-scale", type=float, default=1.0)
    p.add_argument("--exp-divisor", type=float, default=1.0)
    p.add_argument(
        "--apply-inverse", action="store_true",
        help="Apply inverse transform to marginal profiles",
    )
    p.add_argument("--attention-alpha", type=float, default=0.4)
    # second pass: re-run the MLLM on the warped image
    # (new_method.py:583-615)
    p.add_argument("--second-pass", action="store_true",
                   help="run the MLLM on the warped image and print its answer")
    p.add_argument("--question", type=str, default=None,
                   help="question for the second pass")
    p.add_argument("--backend", type=str, default="mini",
                   help="MLLM backend spec for the second pass: 'mini' (the "
                        "test MLLM), 'reader', 'llava-ckpt:<dir>' or "
                        "'qwen2vl-ckpt:<dir>' (+kv8, +flash)")
    p.add_argument("--layer-index", type=str, default="20",
                   help="extraction layer for the second-pass backend")
    p.add_argument("--max-new-tokens", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device of the warp and the second pass (default cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.second_pass and not args.question:
        print("--second-pass needs --question")
        return 1
    backend = None
    if args.second_pass:
        from attwarp_tpu_torch.cli.process_dataset import make_backend
        from attwarp_tpu_torch.eval.harness import ExtractionAnswerBackend

        backend = ExtractionAnswerBackend(
            make_backend(args.backend, args.layer_index, args.device),
            max_new_tokens=args.max_new_tokens,
        )
    run_dir = next_run_dir(args.output_dir)
    print(f"Saving outputs to: {run_dir}")

    att = np.load(args.attention_map)
    vis_path = (
        os.path.join(run_dir, os.path.basename(args.visualization))
        if args.visualization
        else None
    )
    ok = save_warped_image(
        image_path=args.image,
        att_map=att,
        original_image_save_path=os.path.join(run_dir, "original_image.png"),
        masked_overlay_save_path=os.path.join(run_dir, "masked_overlay_image.png"),
        output_path=os.path.join(run_dir, os.path.basename(args.output)),
        vis_path=vis_path,
        width=args.width,
        height=args.height,
        transform=args.transform,
        exp_scale=args.exp_scale,
        exp_divisor=args.exp_divisor,
        apply_inverse=args.apply_inverse,
        attention_alpha=args.attention_alpha,
        device=args.device,
    )

    if ok and backend is not None:
        from attwarp_tpu_torch.data.imageio import read_rgb

        img = read_rgb(os.path.join(run_dir, os.path.basename(args.output)))
        answer = backend.answer(img, args.question, args.max_new_tokens)
        print(f"Warped image output: {answer}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
