"""The port's checkpoint directory: ``params.pt`` (``torch.save`` of the
parameter tree) and ``config.json`` (``dataclasses.asdict`` of the config),
read and written by both backends' ``save``/``load``. (JAX's orbax
checkpoints cannot be read without JAX; a JAX parameter tree comes across
through ``models/llava.py::params_from_jax``.)"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch


def save_checkpoint(path, params, cfg) -> None:
    """``params.pt`` (the parameter tree) and ``config.json`` into ``path``."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    torch.save(params, p / "params.pt")
    with open(p / "config.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_checkpoint(path, device, config_from_dict):
    """(config, parameter tree on ``device``) from a ``save_checkpoint``
    directory; ``config_from_dict`` rebuilds the family's config."""
    p = Path(path)
    with open(p / "config.json") as f:
        cfg = config_from_dict(json.load(f))
    params = torch.load(p / "params.pt", map_location=device, weights_only=True)
    return cfg, params
