"""The port's checkpoint directory: ``params.pt`` (``torch.save`` of the
parameter tree), ``config.json`` (``dataclasses.asdict`` of the config) and
the tokenizer's own files, read and written by both backends'
``save``/``load``. (JAX's orbax checkpoints cannot be read without JAX; a
JAX parameter tree comes across through ``models/llava.py::params_from_jax``.)

The tokenizer is written by its ``save_pretrained``, as JAX's ``save``
writes it: the port's ``DryRunTokenizer`` writes HF's ``tokenizer.json``
format itself, a ``transformers`` tokenizer its usual files. ``load``
restores it without ``transformers`` where ``tokenizer.json`` is a
word-level tokenizer (``DryRunTokenizer.from_pretrained``), else through
``transformers.AutoTokenizer`` where that imports, else gives None.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer

# files that mark a directory as holding a tokenizer for AutoTokenizer
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model",
                    "vocab.json")


def save_checkpoint(path, params, cfg, tokenizer=None) -> None:
    """``params.pt`` (the parameter tree), ``config.json`` and, where given,
    the tokenizer's files into ``path``."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    torch.save(params, p / "params.pt")
    with open(p / "config.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    if tokenizer is not None:
        tokenizer.save_pretrained(str(p))


def load_tokenizer(path):
    """The tokenizer saved in directory ``path``, or None where it holds
    none that the port can read (see the module docstring)."""
    p = Path(path)
    tok = DryRunTokenizer.from_pretrained(p)
    if tok is not None or not any((p / f).is_file() for f in _TOKENIZER_FILES):
        return tok
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None
    return AutoTokenizer.from_pretrained(str(p))


def load_checkpoint(path, device, config_from_dict):
    """(config, parameter tree on ``device``, tokenizer or None) from a
    ``save_checkpoint`` directory; ``config_from_dict`` rebuilds the
    family's config."""
    p = Path(path)
    with open(p / "config.json") as f:
        cfg = config_from_dict(json.load(f))
    params = torch.load(p / "params.pt", map_location=device, weights_only=True)
    return cfg, params, load_tokenizer(p)
