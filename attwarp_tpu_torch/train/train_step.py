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
included.

``make_sharded_train_step`` is the same step over a ``(data, model)`` mesh
of ranks (``parallel/mesh.py``): each rank takes its slice of the batch,
MarginalNet's large kernels are column-parallel over ``model``
(``parallel/mesh.py::shard_params``, the activations gathered where the
next layer needs full channels), the gradients are averaged over ``data``,
the AdamW moments are the rank's slices of its parameters', and the global
norm sums the squares of the sharded gradients over ``model`` once and
adds the replicated ones once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from attwarp_tpu_torch.marginalnet.model import ATTENTION_GRID, MarginalNet
from attwarp_tpu_torch.numerics.cdf import gt_marginals
from attwarp_tpu_torch.numerics.losses import recon_l1
from attwarp_tpu_torch.numerics.pooling import adaptive_avg_pool2d, upsample_pdf_right_inverse
from attwarp_tpu_torch.numerics.safe import entropy, mix_with_uniform, normalize_pdf
from attwarp_tpu_torch.parallel.comm import all_reduce
from attwarp_tpu_torch.parallel.mesh import Mesh, shard_batch, shard_params
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


def _sharded_norm(named, sharded, mesh: Mesh) -> torch.Tensor:
    """The global norm of gradients of which those named in ``sharded`` are
    this rank's slices over ``model``: their squares summed over the group
    once, the replicated ones' added once."""
    part = [torch.sum(g * g) for n, g in named if n in sharded]
    whole = [torch.sum(g * g) for n, g in named if n not in sharded]
    sq = all_reduce(torch.stack(part).sum(), mesh.model) if part else 0.0
    return torch.sqrt(sq + (torch.stack(whole).sum() if whole else 0.0))


def _clip_and_update(state: TrainState, named, metrics, cfg: TrainConfig, norm_of):
    """``grad_norm`` (and with ``cfg.watch_gradients`` each module's, under
    ``grad_norm/<module>``) by ``norm_of``, then optax's clip and the AdamW
    update."""
    norm = norm_of(named)
    metrics["grad_norm"] = norm.detach()
    if cfg.watch_gradients:
        # per-module gradient norms, the counterpart of the reference's
        # best-effort wandb.watch(net, log="gradients") (trainer.py:146-153)
        groups: Dict[str, list] = {}
        for n, g in named:
            groups.setdefault(n.split(".")[0], []).append((n, g))
        for name, pairs in groups.items():
            metrics[f"grad_norm/{name}"] = norm_of(pairs).detach()
    clip = torch.tensor(cfg.grad_clip, dtype=norm.dtype, device=norm.device)
    for _, g in named:
        g.copy_(torch.where(norm < clip, g, (g / norm) * clip))
    state.optimizer.step()
    state.step += 1
    return state, metrics


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: TrainConfig) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One forward, backward, clip and AdamW update; ``metrics`` has the
    loss terms and ``grad_norm``, the global norm before the clip (and with
    ``cfg.watch_gradients`` each module's, under ``grad_norm/<module>``)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state.model, batch, state.step, cfg)
    loss.backward()
    named = [(n, p.grad) for n, p in state.model.named_parameters()]
    return _clip_and_update(state, named, metrics, cfg,
                            lambda pairs: _global_norm([g for _, g in pairs]))


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              cfg: TrainConfig) -> Dict[str, torch.Tensor]:
    _, metrics = loss_fn(state.model, batch, state.step, cfg)
    return metrics


def _data_mean(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor replaced in place by its mean over the ``data`` axis (one
    all-reduce for all of them)."""
    if mesh.data.size == 1:
        return
    flat = all_reduce(torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]),
                      mesh.data) / mesh.data.size
    for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(part.reshape(t.shape))


def _mean_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Metrics of the rank's slice -> the global batch's (every metric is a
    mean over the batch, and the slices are equal)."""
    vals = [v.reshape(1).clone() for v in metrics.values()]
    _data_mean(vals, mesh)
    return {k: v[0] for k, v in zip(metrics, vals)}


def _reshard_optimizer(old: torch.optim.Optimizer, names: List[str], model: MarginalNet,
                       cfg: TrainConfig, mesh: Mesh) -> torch.optim.Optimizer:
    """A new AdamW over the sharded model carrying ``old``'s moments, each
    sharded parameter's sliced as the parameter was."""
    saved = old.state_dict()
    opt = make_optimizer(cfg, model)
    state = {}
    for i, name in enumerate(names):
        st = saved["state"].get(i)
        if st is None:
            continue
        if name in model.sharded_names:
            g = mesh.model
            st = {k: (v.chunk(g.size)[g.rank].clone() if k.startswith("exp_avg") else v)
                  for k, v in st.items()}
        state[i] = st
    opt.load_state_dict({"state": state, "param_groups": saved["param_groups"]})
    return opt


def make_sharded_train_step(model: MarginalNet, cfg: TrainConfig, mesh: Mesh,
                            state: TrainState, batch: Dict[str, torch.Tensor],
                            with_eval: bool = False):
    """The train step over ``mesh``'s ranks; returns (fn, sharded_state,
    sharded_batch), or (fn, eval_fn, sharded_state, sharded_batch) with
    ``with_eval``. ``model`` (``state.model``) is sharded in place
    (``parallel/mesh.py::shard_params``) and ``state``'s optimizer moments
    with it. ``fn(state, b)`` and ``eval_fn(state, b)`` take the rank's
    slice of a batch (``shard_batch``) and return the global batch's
    metrics, on every rank."""
    names = [n for n, _ in model.named_parameters()]
    shard_params(model, mesh)
    sharded_state = TrainState(state.step, model,
                               _reshard_optimizer(state.optimizer, names, model, cfg, mesh))

    def norm_of(pairs):
        return _sharded_norm(pairs, model.sharded_names, mesh)

    def fn(s: TrainState, b: Dict[str, torch.Tensor]):
        s.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(s.model, b, s.step, cfg)
        loss.backward()
        named = [(n, p.grad) for n, p in s.model.named_parameters()]
        # each rank's loss is its slice's mean: the global gradient is the mean
        _data_mean([g for _, g in named], mesh)
        return _clip_and_update(s, named, _mean_metrics(metrics, mesh), cfg, norm_of)

    @torch.no_grad()
    def eval_fn(s: TrainState, b: Dict[str, torch.Tensor]):
        return _mean_metrics(loss_fn(s.model, b, s.step, cfg)[1], mesh)

    sharded_batch = shard_batch(batch, mesh)
    if with_eval:
        return fn, eval_fn, sharded_state, sharded_batch
    return fn, sharded_state, sharded_batch
