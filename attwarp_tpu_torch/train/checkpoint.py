"""Model checkpoints (counterpart of ``attwarp_tpu/train/checkpoint.py``).

``torch.save`` of the whole training state (step, model, optimizer) at
``marginal_net_epoch_{N}.pt``, with JAX's JSON sidecar carrying the
config, restorable for an exact resume, which the reference lacks (SURVEY
§5: "There is NO mid-epoch training resume").
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

from attwarp_tpu_torch.train.train_step import TrainState

_PREFIX = "marginal_net_epoch_"


def save_checkpoint(save_dir: str | Path, epoch: int, state: TrainState,
                    cfg: Any = None) -> Path:
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    path = (save_dir / f"{_PREFIX}{epoch}.pt").absolute()
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, path)
    if cfg is not None:
        meta = {
            "epoch": epoch,
            "cfg": dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else cfg,
        }
        with open(save_dir / f"{_PREFIX}{epoch}.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)
    return path


def latest_checkpoint(save_dir: str | Path) -> Optional[Tuple[int, Path]]:
    """The highest epoch's checkpoint under ``save_dir`` as ``(epoch,
    path)``, or None."""
    save_dir = Path(save_dir)
    if not save_dir.exists():
        return None
    best = None
    for p in save_dir.glob(f"{_PREFIX}*.pt"):
        try:
            ep = int(p.stem[len(_PREFIX):])
        except ValueError:
            continue
        if best is None or ep > best[0]:
            best = (ep, p)
    return best


def restore_checkpoint(path: str | Path, template: TrainState) -> TrainState:
    """Load a checkpoint into ``template``'s model and optimizer (on the
    model's device) and set its step; returns ``template``."""
    device = next(template.model.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    template.model.load_state_dict(saved["model"])
    template.optimizer.load_state_dict(saved["optimizer"])
    template.step = int(saved["step"])
    return template
