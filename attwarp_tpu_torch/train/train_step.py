"""MarginalNet training step (counterpart of
``attwarp_tpu/train/train_step.py``).

Loss semantics match the reference hot loop (trainer.py:162-264) and JAX's
``loss_fn``:
1. per-sample GQA-bucket transform on the full-res attention (sqrt mask),
2. adaptive-avg-pool to 24x24, sanitize,
3. MarginalNet forward -> (px, py),
4. alpha-uniform mix with linear decay (trainer.py:212-214),
5. right-inverse upsample of predicted and GT marginals to image resolution,
6. uniform-GT override for 'none'-transform samples (trainer.py:231-238),
7. normalize, loss = w_cdf * (L1(px) + L1(py)); recon_l1 logged.

The optimizer is optax's ``chain(clip_by_global_norm, adamw)``: the
gradients are clipped as optax clips them (``(g / norm) * clip`` where the
global norm reaches ``clip``, on the device with no host sync), then
``torch.optim.AdamW`` with optax's defaults updates every parameter, biases
included. JAX's ``make_sharded_train_step`` waits for the parallel layer
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from attwarp_tpu_torch.marginalnet.model import ATTENTION_GRID, MarginalNet
from attwarp_tpu_torch.numerics.cdf import gt_marginals
from attwarp_tpu_torch.numerics.losses import recon_l1
from attwarp_tpu_torch.numerics.pooling import adaptive_avg_pool2d, upsample_pdf_right_inverse
from attwarp_tpu_torch.numerics.safe import entropy, mix_with_uniform, normalize_pdf
from attwarp_tpu_torch.train.config import TrainConfig


@dataclass
class TrainState:
    """The step count, the model and its optimizer; ``train_step`` updates
    all three in place."""
    step: int
    model: MarginalNet
    optimizer: torch.optim.Optimizer


def make_optimizer(cfg: TrainConfig, model: MarginalNet) -> torch.optim.AdamW:
    """optax.adamw's defaults (betas 0.9/0.999, eps 1e-8, decay on every
    parameter)."""
    return torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.wd)


def create_train_state(cfg: TrainConfig, seed: int,
                       sample_batch: Dict[str, torch.Tensor]) -> Tuple[MarginalNet, TrainState]:
    """A seeded MarginalNet sized from a probe batch's feature widths, on
    the batch's device, and its optimizer."""
    fmap = sample_batch["fmap_v"]
    model = MarginalNet(fmap.shape[-1], sample_batch["ttok"].shape[-1], hidden=cfg.hidden,
                        eps=cfg.eps, generator=torch.Generator().manual_seed(seed))
    model = model.to(fmap.device)
    return model, TrainState(0, model, make_optimizer(cfg, model))


def _prepare_attention(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Apply the per-sample sqrt transform mask to the full-res attention
    and pool to 24x24 (trainer.py:177-202)."""
    A_full = batch["attention_map"]                        # (B, H, W)
    sqrt_mask = batch["sqrt_mask"].reshape(-1, 1, 1)       # (B, 1, 1) in {0, 1}
    A_pos = torch.clamp(A_full, min=0.0)
    A_full = torch.sqrt(A_pos) * sqrt_mask + A_pos * (1.0 - sqrt_mask)
    A = adaptive_avg_pool2d(A_full, ATTENTION_GRID)
    return torch.clamp(torch.nan_to_num(A, nan=0.0, posinf=0.0, neginf=0.0), min=0.0)


def loss_fn(model: MarginalNet, batch: Dict[str, torch.Tensor], step: int,
            cfg: TrainConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    img = torch.clamp(torch.nan_to_num(batch["image"], nan=0.0, posinf=1.0, neginf=0.0),
                      0.0, 1.0)                            # (B, H, W, 3)
    A = _prepare_attention(batch)                          # (B, 24, 24)
    W_img, H_img = img.shape[2], img.shape[1]

    px_pred, py_pred = model(batch["fmap_v"], ATTENTION_GRID, batch["ttok"], batch["tmask"])

    # alpha-uniform mix with linear decay, in f32 as JAX computes it
    s = torch.tensor(float(step), dtype=torch.float32, device=img.device)
    alpha = torch.clamp(cfg.alpha0 * (1.0 - s / cfg.alpha_decay_steps), min=0.0)
    px_s = mix_with_uniform(px_pred, alpha)
    py_s = mix_with_uniform(py_pred, alpha)

    px_img = torch.clamp(upsample_pdf_right_inverse(px_s, W_img), min=0.0)
    py_img = torch.clamp(upsample_pdf_right_inverse(py_s, H_img), min=0.0)

    px_gt, py_gt = gt_marginals(A)
    # uniform-GT override for 'none'-transform samples
    none = batch["none_mask"].reshape(-1, 1) > 0           # (B, 1)
    px_gt = torch.where(none, torch.full_like(px_gt, 1.0 / px_gt.shape[-1]), px_gt)
    py_gt = torch.where(none, torch.full_like(py_gt, 1.0 / py_gt.shape[-1]), py_gt)

    px_gt_img = torch.clamp(upsample_pdf_right_inverse(px_gt, W_img), min=0.0)
    py_gt_img = torch.clamp(upsample_pdf_right_inverse(py_gt, H_img), min=0.0)

    px_img, py_img = normalize_pdf(px_img), normalize_pdf(py_img)
    px_gt_img, py_gt_img = normalize_pdf(px_gt_img), normalize_pdf(py_gt_img)

    L_pdf = (torch.mean(torch.abs(px_img - px_gt_img))
             + torch.mean(torch.abs(py_img - py_gt_img)))
    L_ent = cfg.ent_weight * (entropy(px_s) + entropy(py_s))
    loss = cfg.w_cdf * L_pdf  # entropy term disabled, as in trainer.py:256

    metrics = {
        "loss/total": loss,
        "loss/pdf": L_pdf,
        "loss/recon_l1": recon_l1(px_s, py_s, A),
        "loss/entropy": L_ent,
        "alpha": alpha,
    }
    return loss, {k: v.detach() for k, v in metrics.items()}


def _global_norm(grads) -> torch.Tensor:
    """optax.global_norm: the square root of the sum of squares."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: TrainConfig) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One forward, backward, clip and AdamW update; ``metrics`` has the
    loss terms and ``grad_norm``, the global norm before the clip (and with
    ``cfg.watch_gradients`` each module's, under ``grad_norm/<module>``)."""
    model, opt = state.model, state.optimizer
    opt.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, batch, state.step, cfg)
    loss.backward()
    named = [(n, p.grad) for n, p in model.named_parameters()]
    norm = _global_norm([g for _, g in named])
    metrics["grad_norm"] = norm.detach()
    if cfg.watch_gradients:
        # per-module gradient norms, the counterpart of the reference's
        # best-effort wandb.watch(net, log="gradients") (trainer.py:146-153)
        groups: Dict[str, list] = {}
        for n, g in named:
            groups.setdefault(n.split(".")[0], []).append(g)
        for name, gs in groups.items():
            metrics[f"grad_norm/{name}"] = _global_norm(gs).detach()
    clip = torch.tensor(cfg.grad_clip, dtype=norm.dtype, device=norm.device)
    for _, g in named:
        g.copy_(torch.where(norm < clip, g, (g / norm) * clip))
    opt.step()
    state.step += 1
    return state, metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              cfg: TrainConfig) -> Dict[str, torch.Tensor]:
    _, metrics = loss_fn(state.model, batch, state.step, cfg)
    return metrics
