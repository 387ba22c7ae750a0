"""Training configuration: a copy of ``attwarp_tpu/train/config.py``, pinned
equal to it by the tests.

Field-for-field parity with the reference frozen dataclass
(``model/marginalnet_full_dataset/config.py:7-53``) plus the JAX package's
mesh fields, which lay out the ranks of a multi-process run
(``train/trainer.py``). Environment overrides for WANDB_* / LOG_EVERY are
honored the same way.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TrainConfig:
    # ---- metrics sink (W&B-compatible; falls back to local JSONL) ----
    wandb_project: str = os.getenv("WANDB_PROJECT", "attwarp-marginalnet")
    wandb_entity: Optional[str] = os.getenv("WANDB_ENTITY")
    log_every: int = int(os.getenv("LOG_EVERY", "20"))

    # ---- data ----
    gqa_root_dir: str = "data/gqa_multilayer"
    textvqa_root_dir: str = "data/textvqa_multilayer"
    docvqa_root_dir: str = "data/docvqa_multilayer"
    num_per_ds: int = 12000
    image_size: int = 512

    # ---- reproducibility ----
    seed: int = 13
    eps: float = 1e-6

    # ---- model ----
    hidden: int = 256

    # ---- training ----
    epochs: int = 50
    batch_size: int = 128
    lr: float = 3e-4
    wd: float = 1e-4
    grad_clip: float = 1.0
    workers: int = 4
    cpu: bool = False

    # ---- losses ----
    w_cdf: float = 10.0
    axis_len: int = 256

    # ---- warmup / stabilizers ----
    warmup_steps: int = 1000
    alpha0: float = 0.0
    alpha_decay_steps: int = 2000
    ent_weight: float = 1e-3

    # ---- artifact selection ----
    artifact_type: str = "relative"
    artifact_layer: int = 16

    # ---- MLLM feature extractor ----
    mllm_backend: str = "mini"  # "mini" (test backend) | "llava-flax"
    mllm_model: str = "llava-v1.5-7b"

    # ---- experiments ----
    experiments_root: str = "experiments"
    vis_every: int = 200

    # ---- TPU mesh ----
    mesh_data: Optional[int] = None   # None -> all devices on the data axis
    mesh_model: int = 1
    checkpoint_every_epochs: int = 1

    # ---- input pipeline ----
    # "auto" / "grain" -> the torch DataLoader; "thread" -> the prefetcher
    # (data/loader.py::make_batch_iterator)
    data_pipeline: str = "auto"

    # ---- observability ----
    # per-module gradient norms in the step metrics (wandb.watch equivalent)
    watch_gradients: bool = False
