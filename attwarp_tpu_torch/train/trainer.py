"""MarginalNet training loop (counterpart of ``attwarp_tpu/train/trainer.py``).

Structure parity with ``trainer.py:45-701``: seeded 90/10 split, frozen-MLLM
feature extraction outside the optimized step, per-epoch validation with a
once-per-epoch debug round, per-``vis_every`` debug grids + PDF/CDF plots,
per-``log_every`` scalar metrics, per-epoch checkpoints, loss curves.

The step runs the model in bf16 under autocast with f32 parameters
(``marginalnet/model.py``). A debug round's warps run kernel K1 on a CUDA
device, under ``torch.no_grad()``; only the plotting is kept from ending
the run (``train/viz.py`` never raises), so a failing kernel does end it.

Several ranks (``torch.distributed`` initialized, e.g. under ``torchrun``;
``cli/train.py``) take JAX's multi-device branch: a ``(mesh_data,
mesh_model)`` mesh and ``make_sharded_train_step`` when the batch divides
by the data axis, else every rank trains alone on the whole batch, as JAX
then runs on one device. Each rank featurizes and steps on its own rows of
every batch (its slice of the data axis), so the frozen MLLM's features,
most of a batch's time, are split over the data axis; the batches of a
debug round and a last validation batch that does not divide are
featurized and evaluated whole on every rank. Rank 0 alone writes: the run directory, metrics, debug grids, plots
and checkpoints (their weights and moments gathered whole); the other
ranks return None.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from attwarp_tpu_torch.data.loader import batch_iterator, make_batch_iterator, split_indices
from attwarp_tpu_torch.data.manifests import FullDataset
from attwarp_tpu_torch.marginalnet.model import ATTENTION_GRID
from attwarp_tpu_torch.numerics.cdf import cdf_from_density, gt_marginals
from attwarp_tpu_torch.numerics.pooling import upsample_pdf_right_inverse
from attwarp_tpu_torch.parallel.comm import all_gather
from attwarp_tpu_torch.parallel.mesh import Mesh, gather_state_dict, make_mesh, shard_batch
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
    make_sharded_train_step,
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


def _data_rows(raw: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of a host batch on the ``data`` axis: the slice
    ``shard_batch`` takes of the batch's tensors."""
    n = len(raw["q_str"]) // mesh.data.size
    lo = mesh.data.rank * n
    return {k: v[lo:lo + n] for k, v in raw.items()}


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


@torch.no_grad()
def _debug_round(state: TrainState, jbatch: Dict, raw_batch: Dict, out_dir: Optional[Path],
                 tag: str, step: int, cfg: TrainConfig) -> None:
    """Debug grids + PDF/CDF overlays (trainer.py:283-399, 454-631): the
    whole batch warped from the predicted and from the target CDFs (and,
    for validation, from the raw full-resolution attention), at the
    batch's size. The warps are K1 on a CUDA device. With no ``out_dir``
    (a rank that does not write) it computes and writes nothing."""
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

    if out_dir is None:
        return
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


class _Silent:
    """The metric sink of a rank that does not write."""

    def log(self, *_, **__) -> None:
        pass

    def finish(self) -> None:
        pass


class _Snapshot:
    """A state dict standing in for a module or an optimizer."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


def _whole_state(state: TrainState, mesh: Optional[Mesh]) -> TrainState:
    """``state`` with every sharded parameter and its AdamW moments gathered
    whole over ``model`` (a collective: every rank calls it)."""
    if mesh is None or mesh.model.size == 1:
        return state
    sharded = state.model.sharded_names
    names = [n for n, _ in state.model.named_parameters()]
    opt = state.optimizer.state_dict()
    moments = {}
    for i, st in opt["state"].items():
        if names[i] in sharded:
            st = {k: (all_gather(v, mesh.model, 0) if k.startswith("exp_avg") else v)
                  for k, v in st.items()}
        moments[i] = st
    return TrainState(state.step, _Snapshot(gather_state_dict(state.model, mesh)),
                      _Snapshot({"state": moments, "param_groups": opt["param_groups"]}))


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
    continues from the following epoch, exactly as an unbroken run would.
    Under ``torch.distributed`` every rank calls it (module docstring)."""
    device = require_device(device, "train_loop")
    cfg = cfg or TrainConfig()
    _seed_everything(cfg.seed)
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    writer = not dist.is_initialized() or dist.get_rank() == 0

    run_dir = create_experiment_run_dir(cfg.experiments_root, cfg) if writer else None

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
    jprobe = prepare_batch(probe, feats, device)
    _, state = create_train_state(cfg, cfg.seed, jprobe)

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
    ) if writer else _Silent()

    # optional multi-device sharding
    mesh = None
    step_fn = lambda s, b: train_step(s, b, cfg)          # noqa: E731
    eval_fn = lambda s, b: eval_step(s, b, cfg)           # noqa: E731
    n_data = cfg.mesh_data or (n_dev // cfg.mesh_model)
    if n_dev > 1 and cfg.batch_size % max(n_data, 1) == 0:
        mesh = make_mesh(n_data=n_data, n_model=cfg.mesh_model)
        step_fn, eval_fn, state, _ = make_sharded_train_step(
            state.model, cfg, mesh, state, jprobe, with_eval=True)
    elif n_dev > 1:
        print(
            f"[trainer] batch_size={cfg.batch_size} not divisible by "
            f"data-axis size {n_data}; running single-device."
        )

    def features(raw, whole: bool):
        """(the whole batch's tensors or None, this rank's rows): only this
        rank's rows are featurized unless ``whole`` (a debug round, an
        indivisible batch) or the data axis is one rank."""
        if mesh is None:
            jb = prepare_batch(raw, feats, device)
            return jb, jb
        if whole or mesh.data.size == 1:
            jb = prepare_batch(raw, feats, device)
            return jb, shard_batch(jb, mesh)
        return None, prepare_batch(_data_rows(raw, mesh), feats, device)

    global_step = state.step if resume_from else 0
    train_curve: List[float] = []
    val_curve: List[float] = []
    timer = StageTimer(run_dir / "stages.jsonl" if writer else None)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    for epoch in range(start_epoch, cfg.epochs):
        loss_sum, nb = 0.0, 0
        for raw in make_batch_iterator(
            dataset, train_idx, cfg.batch_size, shuffle=True,
            seed=cfg.seed + epoch, drop_last=True,
            pipeline=cfg.data_pipeline,
        ):
            debug = (global_step + 1) % cfg.vis_every == 0
            with timer.stage("features"):
                jbatch, local = features(raw, debug)
                sync()
            with timer.stage("train_step"):
                state, metrics = step_fn(state, local)
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
            if debug:
                _debug_round(state, jbatch, raw, run_dir / "debug" if writer else None, "train",
                             global_step, cfg)

        # validation
        val_sum, vb = 0.0, 0
        did_debug = False
        for raw in make_batch_iterator(
            dataset, val_idx, cfg.batch_size, shuffle=False, drop_last=False,
            pipeline=cfg.data_pipeline,
        ):
            partial = mesh is not None and len(raw["q_str"]) % n_data != 0
            jbatch, local = features(raw, partial or not did_debug)
            if partial:
                # last partial val batch: every rank evaluates it whole
                m = eval_step(state, jbatch, cfg)
            else:
                m = eval_fn(state, local)
            val_sum += float(m["loss/total"])
            vb += 1
            if not did_debug:
                _debug_round(state, jbatch, raw, run_dir / "debug_validation" if writer else None,
                             f"val_{epoch + 1:03d}", global_step, cfg)
                did_debug = True

        train_loss = loss_sum / max(nb, 1)
        val_loss = val_sum / max(vb, 1)
        if writer:
            print(f"Epoch {epoch + 1}: train_loss={train_loss:.4f} | val_loss={val_loss:.4f}")
        train_curve.append(train_loss)
        val_curve.append(val_loss)
        run.log(
            {"epoch": epoch + 1, "loss/train_epoch": train_loss,
             "loss/val_epoch": val_loss},
            step=global_step,
        )
        if writer:
            plot_train_val_curves(train_curve, val_curve, run_dir / "curves" / "loss.png",
                                  title="Image-res PDF L1 Loss")
        if (epoch + 1) % cfg.checkpoint_every_epochs == 0:
            whole = _whole_state(state, mesh)
            if writer:
                save_checkpoint(run_dir / "checkpoints", epoch + 1, whole, cfg)

    if writer:
        print("Training complete. Saved to:", str(run_dir))
    for name, agg in timer.summary().items():
        run.log({f"stage/{name}_mean_s": agg["mean"],
                 f"stage/{name}_total_s": agg["total"]})
    timer.close()
    run.finish()
    return run_dir
