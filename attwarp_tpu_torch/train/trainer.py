"""MarginalNet training loop (counterpart of ``attwarp_tpu/train/trainer.py``).

Structure parity with ``trainer.py:45-701``: seeded 90/10 split, frozen-MLLM
feature extraction outside the optimized step, per-epoch validation with a
once-per-epoch debug round, per-``vis_every`` debug grids + PDF/CDF plots,
per-``log_every`` scalar metrics, per-epoch checkpoints, loss curves.

One device: the step runs the model in bf16 under autocast with f32
parameters (``marginalnet/model.py``). A debug round's warps run kernel
K1 on a CUDA device, under ``torch.no_grad()``; only the plotting is kept
from ending the run (``train/viz.py`` never raises), so a failing kernel
does end it. JAX's multi-device branch waits for the parallel layer
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from attwarp_tpu_torch.data.loader import batch_iterator, make_batch_iterator, split_indices
from attwarp_tpu_torch.data.manifests import FullDataset
from attwarp_tpu_torch.marginalnet.model import ATTENTION_GRID
from attwarp_tpu_torch.numerics.cdf import cdf_from_density, gt_marginals
from attwarp_tpu_torch.numerics.pooling import upsample_pdf_right_inverse
from attwarp_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from attwarp_tpu_torch.train.config import TrainConfig
from attwarp_tpu_torch.train.experiment import create_experiment_run_dir
from attwarp_tpu_torch.train.metrics import init_metrics
from attwarp_tpu_torch.train.train_step import (
    TrainState,
    _prepare_attention,
    create_train_state,
    eval_step,
    train_step,
)
from attwarp_tpu_torch.train.viz import (
    plot_axis_cdf_overlay,
    plot_axis_pdf_overlay,
    plot_train_val_curves,
    save_debug_grid,
)
from attwarp_tpu_torch.utils.device import require_device
from attwarp_tpu_torch.utils.profiling import StageTimer
from attwarp_tpu_torch.warp.warp import warp_from_cdf


def _seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def prepare_batch(batch: Dict, feats, device) -> Dict[str, torch.Tensor]:
    """A collated host batch -> the step's tensors on ``device``, with the
    frozen MLLM features attached (the extractors take the host images)."""
    def dev(x):
        return torch.as_tensor(x, device=device)

    ttok, tmask = feats.text_tokens(batch["q_str"])
    return {
        "image": dev(np.asarray(batch["image"], np.float32)),
        "attention_map": dev(np.asarray(batch["attention_map"], np.float32)),
        "sqrt_mask": dev(np.asarray(batch["sqrt_mask"], np.float32)),
        "none_mask": dev(np.asarray(batch["none_mask"], np.float32)),
        "fmap_v": dev(feats.visual_tokens(batch["image"])),
        "ttok": dev(ttok),
        "tmask": dev(tmask),
    }


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


@torch.no_grad()
def _debug_round(state: TrainState, jbatch: Dict, raw_batch: Dict, out_dir: Path,
                 tag: str, step: int, cfg: TrainConfig) -> None:
    """Debug grids + PDF/CDF overlays (trainer.py:283-399, 454-631): the
    whole batch warped from the predicted and from the target CDFs (and,
    for validation, from the raw full-resolution attention), at the
    batch's size. The warps are K1 on a CUDA device."""
    img = jbatch["image"]
    W_img, H_img = img.shape[2], img.shape[1]
    # same per-sample sqrt transform + pool as the training loss, so the
    # plotted GT matches the actual optimization target
    A = _prepare_attention(jbatch)
    px_pred, py_pred = state.model(jbatch["fmap_v"], ATTENTION_GRID, jbatch["ttok"],
                                   jbatch["tmask"])
    Fx = cdf_from_density(torch.clamp(upsample_pdf_right_inverse(px_pred, W_img), min=0.0))
    Fy = cdf_from_density(torch.clamp(upsample_pdf_right_inverse(py_pred, H_img), min=0.0))
    Wpred = torch.clamp(warp_from_cdf(img, Fx, Fy), 0.0, 1.0)

    px_gt, py_gt = gt_marginals(A)
    Fx_gt = cdf_from_density(torch.clamp(upsample_pdf_right_inverse(px_gt, W_img), min=0.0))
    Fy_gt = cdf_from_density(torch.clamp(upsample_pdf_right_inverse(py_gt, H_img), min=0.0))
    Wgt = torch.clamp(warp_from_cdf(img, Fx_gt, Fy_gt), 0.0, 1.0)

    # validation grids get the reference's 5th row: the GT warp from the
    # RAW full-resolution attention map (trainer.py:499-517)
    Wgt_orig = None
    if tag.startswith("val"):
        pxo, pyo = gt_marginals(jbatch["attention_map"])
        Wgt_orig = _host(torch.clamp(
            warp_from_cdf(img, cdf_from_density(pxo), cdf_from_density(pyo)), 0.0, 1.0))

    num_vis = min(4, img.shape[0])
    save_debug_grid(
        _host(img[:num_vis]), _host(A[:num_vis]), _host(Wpred[:num_vis]),
        _host(Wgt[:num_vis]), out_dir / f"{tag}_{step:06d}.png",
        questions=raw_batch.get("q_str"), num_vis=num_vis,
        warped_gt_orig=None if Wgt_orig is None else Wgt_orig[:num_vis],
    )
    for i in range(num_vis):
        plot_axis_pdf_overlay(
            _host(px_pred[i]), _host(py_pred[i]), _host(px_gt[i]), _host(py_gt[i]),
            out_dir / "pdfs" / f"{tag}_{step:06d}_sample{i}.png",
            title_prefix=tag, sample_idx=i,
        )
        plot_axis_cdf_overlay(
            _host(Fx[i]), _host(Fy[i]), _host(Fx_gt[i]), _host(Fy_gt[i]),
            out_dir / "cdfs" / f"{tag}_{step:06d}_sample{i}.png",
            title_prefix=f"{tag} (image-res CDF)", sample_idx=i,
        )


def train_loop(
    cfg: Optional[TrainConfig] = None,
    dataset=None,
    feature_extractor=None,
    resume_from: Optional[str] = None,
    device="cuda",
) -> Path:
    """Train MarginalNet on ``device`` (the card unless the caller asks for
    the CPU); returns the experiment run directory.

    ``resume_from``: a previous run's ``checkpoints/`` directory; its
    latest checkpoint (step, model, optimizer) is restored and training
    continues from the following epoch, exactly as an unbroken run would."""
    device = require_device(device, "train_loop")
    cfg = cfg or TrainConfig()
    _seed_everything(cfg.seed)

    run_dir = create_experiment_run_dir(cfg.experiments_root, cfg)
    save_dir = run_dir / "checkpoints"

    if dataset is None:
        dataset = FullDataset(
            gqa_root_dir=cfg.gqa_root_dir,
            textvqa_root_dir=cfg.textvqa_root_dir,
            docvqa_root_dir=cfg.docvqa_root_dir,
            num_samples_per_dataset=cfg.num_per_ds,
            artifact_type=cfg.artifact_type,
            artifact_layer=cfg.artifact_layer,
            random_seed=cfg.seed,
            image_size=cfg.image_size,
        )
    train_idx, val_idx = split_indices(len(dataset), 0.1, cfg.seed)

    if feature_extractor is None:
        from attwarp_tpu_torch.extract.features import make_feature_extractor

        feature_extractor = make_feature_extractor(cfg, device)
    feats = feature_extractor

    # probe batch -> init
    probe = next(batch_iterator(dataset, train_idx[: cfg.batch_size], cfg.batch_size,
                                drop_last=False))
    _, state = create_train_state(cfg, cfg.seed, prepare_batch(probe, feats, device))

    start_epoch = 0
    if resume_from:
        found = latest_checkpoint(resume_from)
        if found is None:
            raise FileNotFoundError(f"No checkpoints under {resume_from}")
        start_epoch, ckpt_path = found
        state = restore_checkpoint(ckpt_path, state)
        print(f"[trainer] resumed from {ckpt_path} (epoch {start_epoch}, "
              f"step {state.step})")

    run = init_metrics(
        run_dir=run_dir,
        project=cfg.wandb_project,
        entity=cfg.wandb_entity,
        cfg={"seed": cfg.seed, "epochs": cfg.epochs, "batch_size": cfg.batch_size,
             "lr": cfg.lr, "wd": cfg.wd, "hidden": cfg.hidden,
             "image_size": cfg.image_size, "w_cdf": cfg.w_cdf},
    )

    global_step = state.step if resume_from else 0
    train_curve: List[float] = []
    val_curve: List[float] = []
    timer = StageTimer(run_dir / "stages.jsonl")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    for epoch in range(start_epoch, cfg.epochs):
        loss_sum, nb = 0.0, 0
        for raw in make_batch_iterator(
            dataset, train_idx, cfg.batch_size, shuffle=True,
            seed=cfg.seed + epoch, drop_last=True,
            pipeline=cfg.data_pipeline,
        ):
            with timer.stage("features"):
                jbatch = prepare_batch(raw, feats, device)
                sync()
            with timer.stage("train_step"):
                state, metrics = train_step(state, jbatch, cfg)
                # the host waits for the step, so the stage records its
                # device time and not its launch
                loss = float(metrics["loss/total"])
            global_step += 1
            loss_sum += loss
            nb += 1
            if global_step % cfg.log_every == 0:
                payload = {
                    "global_step": global_step,
                    "loss/train_total": loss,
                    "loss/train_pdf": float(metrics["loss/pdf"]),
                    "loss/train_recon_l1": float(metrics["loss/recon_l1"]),
                    "lr": cfg.lr,
                    "grad_norm": float(metrics["grad_norm"]),
                }
                # per-module norms when --watch-gradients (wandb.watch parity)
                payload.update({
                    k: float(v) for k, v in metrics.items()
                    if k.startswith("grad_norm/")
                })
                run.log(payload)
            if global_step % cfg.vis_every == 0:
                _debug_round(state, jbatch, raw, run_dir / "debug", "train",
                             global_step, cfg)

        # validation
        val_sum, vb = 0.0, 0
        did_debug = False
        for raw in make_batch_iterator(
            dataset, val_idx, cfg.batch_size, shuffle=False, drop_last=False,
            pipeline=cfg.data_pipeline,
        ):
            jbatch = prepare_batch(raw, feats, device)
            m = eval_step(state, jbatch, cfg)
            val_sum += float(m["loss/total"])
            vb += 1
            if not did_debug:
                _debug_round(state, jbatch, raw, run_dir / "debug_validation",
                             f"val_{epoch + 1:03d}", global_step, cfg)
                did_debug = True

        train_loss = loss_sum / max(nb, 1)
        val_loss = val_sum / max(vb, 1)
        print(f"Epoch {epoch + 1}: train_loss={train_loss:.4f} | val_loss={val_loss:.4f}")
        train_curve.append(train_loss)
        val_curve.append(val_loss)
        run.log(
            {"epoch": epoch + 1, "loss/train_epoch": train_loss,
             "loss/val_epoch": val_loss},
            step=global_step,
        )
        plot_train_val_curves(train_curve, val_curve, run_dir / "curves" / "loss.png",
                              title="Image-res PDF L1 Loss")
        if (epoch + 1) % cfg.checkpoint_every_epochs == 0:
            save_checkpoint(save_dir, epoch + 1, state, cfg)

    print("Training complete. Saved to:", str(run_dir))
    for name, agg in timer.summary().items():
        run.log({f"stage/{name}_mean_s": agg["mean"],
                 f"stage/{name}_total_s": agg["total"]})
    timer.close()
    run.finish()
    return run_dir
