"""Experiment bookkeeping: a copy of ``attwarp_tpu/train/experiment.py``,
pinned equal to it by the tests.

Parity with ``model/marginalnet_full_dataset/experiment.py:8-37``:
auto-incrementing ``Experiment_N`` directories with ``debug/``,
``checkpoints/`` subdirs and a timestamp ``comments.txt``. Instead of copying
``*.py`` sources into ``code_snapshot/`` we record the resolved config and
the git SHA — reproducibility without file duplication.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from pathlib import Path
from typing import Any, Optional


def _next_experiment_dir_name(root: Path) -> str:
    max_idx = 0
    if root.exists():
        for d in root.iterdir():
            if d.is_dir() and d.name.startswith("Experiment_"):
                try:
                    idx = int(d.name.split("_")[-1])
                except Exception:
                    continue
                max_idx = max(max_idx, idx)
    return f"Experiment_{max_idx + 1}"


def _git_sha() -> Optional[str]:
    try:
        return (
            subprocess.check_output(
                ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL
            )
            .decode()
            .strip()
        )
    except Exception:
        return None


def create_experiment_run_dir(experiments_root: str, config: Any = None) -> Path:
    root = Path(experiments_root)
    exp_dir = root / _next_experiment_dir_name(root)
    exp_dir.mkdir(parents=True, exist_ok=True)
    (exp_dir / "debug").mkdir(parents=True, exist_ok=True)
    (exp_dir / "checkpoints").mkdir(parents=True, exist_ok=True)

    with open(exp_dir / "comments.txt", "w") as f:
        f.write(time.strftime("%Y-%m-%d %H:%M:%S") + "\n")

    snapshot = {"git_sha": _git_sha()}
    if config is not None:
        try:
            snapshot["config"] = (
                dataclasses.asdict(config)
                if dataclasses.is_dataclass(config)
                else dict(config)
            )
        except Exception:
            snapshot["config"] = repr(config)
    with open(exp_dir / "run_snapshot.json", "w") as f:
        json.dump(snapshot, f, indent=2, default=str)
    return exp_dir
