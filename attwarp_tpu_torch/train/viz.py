"""Host-side training visualizations, which never raise (counterpart of
``attwarp_tpu/train/viz.py``; numpy, Pillow and matplotlib, with the debug
grid's heat map resized like ``jax.image.resize`` "linear" on the CPU).

Parity with the reference's debug artifacts:
- train/val loss curves               (plots.py:7-35)
- PDF overlay figures                 (checkpoint_utils.py:334-386)
- CDF overlay with KS / mean|Δ| / RMSE + residual panels
                                      (checkpoint_utils.py:206-330)
- 4-row debug grids [orig | attention heat | pred warp | GT warp]
                                      (trainer.py:283-337)
All wrapped in try/except so plotting can never take down a training run.
Without matplotlib the plots are skipped, with one printed line.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


@functools.lru_cache(maxsize=1)
def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None (said once) where
    matplotlib does not import."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:  # plotting must never take down a training run
        print(f"[viz] matplotlib does not import ({e}); training plots are skipped")
        return None
    return plt


def plot_train_val_curves(
    train_values: Sequence[float],
    val_values: Sequence[float],
    out_path: Path,
    title: str = "Training/Validation Curves",
    ylabel: str = "Loss",
) -> None:
    plt = _pyplot()
    if plt is None:
        return
    try:

        epochs = list(range(1, len(train_values) + 1))
        plt.figure(figsize=(7, 4))
        plt.plot(epochs, train_values, label="Train", marker="o")
        plt.plot(epochs, val_values, label="Val", marker="s")
        plt.xlabel("Epoch")
        plt.ylabel(ylabel)
        plt.title(title)
        plt.grid(True, alpha=0.3)
        plt.legend()
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        plt.tight_layout()
        plt.savefig(str(out_path))
        plt.close()
    except Exception:
        pass


def _norm_pdf(p: np.ndarray) -> np.ndarray:
    p = np.nan_to_num(np.clip(np.asarray(p, np.float64).ravel(), 0, None))
    return p / max(p.sum(), 1e-6)


def plot_axis_pdf_overlay(
    px_pred, py_pred, px_gt, py_gt, out_path: Path, title_prefix: str, sample_idx: int,
    px_gt_full=None, py_gt_full=None,
) -> None:
    plt = _pyplot()
    if plt is None:
        return
    try:

        fig = plt.figure(figsize=(8, 5.5))
        for row, (gt, pred, full, name) in enumerate(
            [
                (px_gt, px_pred, px_gt_full, "X"),
                (py_gt, py_pred, py_gt_full, "Y"),
            ]
        ):
            ax = fig.add_subplot(2, 1, row + 1)
            ax.plot(_norm_pdf(gt), label=f"GT {name.lower()}-pdf (downsampled)", linewidth=2)
            ax.plot(_norm_pdf(pred), label=f"Pred {name.lower()}-pdf", linestyle="--")
            if full is not None:
                ax.plot(_norm_pdf(full), label=f"GT {name.lower()}-pdf (full)", linestyle=":")
            ax.set_ylabel("density")
            ax.set_title(f"{title_prefix} • sample {sample_idx} • {name}-axis")
            ax.grid(True, alpha=0.3)
            ax.legend()
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        fig.tight_layout()
        fig.savefig(str(out_path))
        plt.close(fig)
    except Exception:
        pass


def _safe_cdf(F: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if F is None:
        return None
    arr = np.nan_to_num(np.asarray(F, np.float32).ravel(), nan=0.0, posinf=1.0, neginf=0.0)
    if arr.size == 0:
        return arr
    arr = np.maximum.accumulate(arr)
    last = float(arr[-1])
    if last <= 1e-12:
        arr = np.linspace(0.0, 1.0, len(arr), dtype=np.float32)
    else:
        arr = arr / last
    arr[-1] = 1.0
    return arr


def plot_axis_cdf_overlay(
    Fx_pred, Fy_pred, Fx_gt, Fy_gt, out_path: Path, title_prefix: str, sample_idx: int,
    Fx_gt_full=None, Fy_gt_full=None,
) -> None:
    plt = _pyplot()
    if plt is None:
        return
    try:

        fig, axes = plt.subplots(2, 2, figsize=(12, 7), constrained_layout=True)
        fig.suptitle(f"{title_prefix} • sample {sample_idx}", fontsize=13)
        for col, (gt, pred, full, name) in enumerate(
            [
                (_safe_cdf(Fx_gt), _safe_cdf(Fx_pred), _safe_cdf(Fx_gt_full), "X"),
                (_safe_cdf(Fy_gt), _safe_cdf(Fy_pred), _safe_cdf(Fy_gt_full), "Y"),
            ]
        ):
            ax, rx = axes[0, col], axes[1, col]
            idx = np.arange(len(gt))
            diff = pred - gt
            adiff = np.abs(diff)
            ks = float(adiff.max()) if adiff.size else 0.0
            ks_i = int(adiff.argmax()) if adiff.size else 0
            mean_abs = float(adiff.mean()) if adiff.size else 0.0
            rmse = float(np.sqrt(np.mean(diff**2))) if adiff.size else 0.0
            ax.step(idx, gt, where="mid", linewidth=2, label=f"GT {name}-cdf")
            ax.step(idx, pred, where="mid", linestyle="--", label=f"Pred {name}-cdf")
            if full is not None and len(full) > 0:
                ax.step(np.arange(len(full)), full, where="mid", linestyle=":", label=f"GT {name}-cdf (full)")
            ax.fill_between(idx, gt, pred, step="mid", alpha=0.25, label="|Δ|")
            ax.set_ylim(0, 1)
            ax.set_ylabel("CDF")
            ax.set_title(f"{name}-axis • KS={ks:.4f}  mean|Δ|={mean_abs:.4f}  RMSE={rmse:.4f}")
            ax.grid(True, alpha=0.3)
            ax.legend(loc="best", fontsize=9)
            if len(idx):
                ax.axvline(ks_i, linestyle=":", linewidth=1)
            # auto-zoom inset around the largest discrepancy window
            # (checkpoint_utils.py:256-303)
            try:
                from mpl_toolkits.axes_grid1.inset_locator import (
                    inset_axes,
                    mark_inset,
                )

                n_pts = len(adiff)
                if n_pts:
                    w_win = max(6, int(0.2 * n_pts))
                    conv = np.convolve(adiff, np.ones(w_win), mode="valid")
                    i0 = int(np.argmax(conv))
                    i1 = min(i0 + w_win, n_pts - 1)
                    if i1 > i0:
                        axins = inset_axes(ax, width="40%", height="45%",
                                           loc="lower right", borderpad=1.0)
                        axins.step(idx, gt, where="mid")
                        axins.step(idx, pred, where="mid", linestyle="--")
                        axins.fill_between(idx, gt, pred, step="mid", alpha=0.25)
                        axins.set_xlim(i0, i1)
                        local = np.r_[gt[i0:i1 + 1], pred[i0:i1 + 1]]
                        lo, hi = local.min(), local.max()
                        pad = 0.05 * max(hi - lo, 1e-12)
                        axins.set_ylim(max(0, lo - pad), min(1, hi + pad))
                        mark_inset(ax, axins, loc1=2, loc2=4, fc="none", ec="0.5")
            except Exception:
                pass
            rx.axhline(0.0, color="k", linewidth=1)
            rx.step(idx, diff, where="mid")
            rx.fill_between(idx, 0.0, diff, step="mid", alpha=0.2)
            rx.axhline(ks, linestyle=":", linewidth=1)
            rx.axhline(-ks, linestyle=":", linewidth=1)
            lim = max(float(np.nanpercentile(adiff, 99.0)) if adiff.size else 0.01, 1e-3)
            rx.set_ylim(-1.15 * lim, 1.15 * lim)
            rx.set_xlabel("bin")
            rx.set_ylabel("ΔCDF")
            rx.grid(True, alpha=0.3)
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(str(out_path), dpi=150)
        plt.close(fig)
    except Exception:
        pass


def save_debug_grid(
    images: np.ndarray,        # (B, H, W, 3) in [0, 1]
    attention: np.ndarray,     # (B, h, w)
    warped_pred: np.ndarray,   # (B, H, W, 3) in [0, 1]
    warped_gt: np.ndarray,     # (B, H, W, 3) in [0, 1]
    out_path: Path,
    questions: Optional[List[str]] = None,
    num_vis: int = 4,
    warped_gt_orig: Optional[np.ndarray] = None,
) -> None:
    """Grid [orig | heat | pred warp | ds-GT warp (| original-GT warp)] with
    an optional question side panel (trainer.py:301-311, 506-556; the 5th
    row is the reference's validation-only raw-attention GT warp)."""
    try:
        import torch
        from PIL import Image, ImageDraw

        from attwarp_tpu_torch.extract.resize import resize_linear

        n = min(num_vis, images.shape[0])
        H, W = images.shape[1], images.shape[2]
        heat = attention / (attention.max(axis=(1, 2), keepdims=True) + 1e-6)
        heat_img = resize_linear(
            torch.as_tensor(heat, dtype=torch.float32)[..., None], (H, W)
        ).numpy().repeat(3, axis=-1)
        rows = [images[:n], heat_img[:n], warped_pred[:n], warped_gt[:n]]
        if warped_gt_orig is not None:
            rows.append(warped_gt_orig[:n])
        grid = np.concatenate(
            [np.concatenate(list(r), axis=1) for r in rows], axis=0
        )
        grid8 = np.clip(grid * 255, 0, 255).astype(np.uint8)
        img = Image.fromarray(grid8)
        if questions:
            panel_w = 300
            panel = Image.new("RGB", (panel_w, img.height), (0, 0, 0))
            draw = ImageDraw.Draw(panel)
            y = 10
            for i, q in enumerate(questions[:n]):
                draw.text((10, y), f"{i}: {str(q)[:60]}", fill=(220, 220, 220))
                y += 24
            combined = Image.new("RGB", (img.width + panel_w, img.height), (0, 0, 0))
            combined.paste(img, (0, 0))
            combined.paste(panel, (img.width, 0))
            img = combined
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        img.save(out_path)
    except Exception:
        pass
