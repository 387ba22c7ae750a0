"""MarginalNet training CLI (counterpart of ``attwarp_tpu/cli/train.py``).

Flag parity with ``cli.py:10-58`` and the JAX CLI, plus ``--device``
(default ``cuda``; ``--cpu`` is its alias for ``--device cpu``). Launched
by ``torchrun`` (``WORLD_SIZE`` > 1), each process joins the process group
(NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU) and ``--mesh-data``/
``--mesh-model`` lay the ranks out (``train/trainer.py``'s multi-device
branch):

    torchrun --nproc-per-node 4 -m attwarp_tpu_torch.cli.train \
        --mesh-data 2 --mesh-model 2 ...

``--mllm-backend`` defaults to ``mini`` (``TrainConfig().mllm_backend``, the
test MLLM's features), as in JAX; ``llava``/``qwen2vl`` read
``--mllm-model`` as a port checkpoint directory (the backends' ``save``) or
an HF checkpoint.

    python -m attwarp_tpu_torch.cli.train --mllm-backend llava \\
        --mllm-model ckpt/llava --textvqa-root-dir data/textvqa_multilayer ...
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from attwarp_tpu_torch.train.config import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    d = TrainConfig()
    p = argparse.ArgumentParser("MarginalNet training (FullDataset, PyTorch)")
    p.add_argument("--gqa-root-dir", type=str, default=d.gqa_root_dir)
    p.add_argument("--textvqa-root-dir", type=str, default=d.textvqa_root_dir)
    p.add_argument("--docvqa-root-dir", type=str, default=d.docvqa_root_dir)
    p.add_argument("--num-per-ds", type=int, default=d.num_per_ds)
    p.add_argument("--image-size", type=int, default=d.image_size)

    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--wd", type=float, default=d.wd)
    p.add_argument("--workers", type=int, default=d.workers)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; never falls back)")
    p.add_argument("--cpu", action="store_true", help="alias for --device cpu")

    p.add_argument("--hidden", type=int, default=d.hidden)
    p.add_argument("--mllm-backend", type=str, default=d.mllm_backend)
    p.add_argument("--mllm-model", type=str, default=d.mllm_model)

    p.add_argument("--experiments-root", type=str, default=d.experiments_root)
    p.add_argument("--vis-every", type=int, default=d.vis_every)
    p.add_argument("--log-every", type=int, default=d.log_every)
    p.add_argument("--seed", type=int, default=d.seed)

    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel axis size (default: world size / --mesh-model)")
    p.add_argument("--mesh-model", type=int, default=d.mesh_model,
                   help="tensor-parallel axis size over the torchrun ranks")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoints/ dir of a previous run to resume from")
    p.add_argument("--data-pipeline", type=str, default=d.data_pipeline,
                   choices=("auto", "grain", "thread"),
                   help="input pipeline: grain (a torch DataLoader), thread "
                        "(in-process prefetch), or auto (the DataLoader)")
    p.add_argument("--watch-gradients", action="store_true",
                   help="log per-module gradient norms (wandb.watch equivalent)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else args.device
    cfg = TrainConfig(
        gqa_root_dir=args.gqa_root_dir,
        textvqa_root_dir=args.textvqa_root_dir,
        docvqa_root_dir=args.docvqa_root_dir,
        num_per_ds=args.num_per_ds,
        image_size=args.image_size,
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        wd=args.wd,
        workers=args.workers,
        cpu=device == "cpu",
        hidden=args.hidden,
        mllm_backend=args.mllm_backend,
        mllm_model=args.mllm_model,
        experiments_root=args.experiments_root,
        vis_every=args.vis_every,
        log_every=args.log_every,
        seed=args.seed,
        mesh_data=args.mesh_data,
        mesh_model=args.mesh_model,
        data_pipeline=args.data_pipeline,
        watch_gradients=bool(args.watch_gradients),
    )
    from attwarp_tpu_torch.train.trainer import train_loop

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        import torch
        import torch.distributed as dist

        from attwarp_tpu_torch.parallel.mesh import init_ranks

        if torch.device(device).type == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
            torch.cuda.set_device(device)
        init_ranks("nccl" if torch.device(device).type == "cuda" else "gloo")
        try:
            train_loop(cfg, resume_from=args.resume, device=device)
        finally:
            dist.destroy_process_group()
        return 0
    train_loop(cfg, resume_from=args.resume, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
