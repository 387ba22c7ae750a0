"""Metric sink: W&B-compatible interface with a local JSONL fallback. A copy
of ``attwarp_tpu/train/metrics.py``, pinned equal to it by the tests.

Parity with ``wandb_utils.py:9-90``: tries wandb online, falls back to
offline on permission errors, and finally to a no-op-like local sink — here
the "no-op" still records everything to ``metrics.jsonl`` so headless
runs keep full telemetry.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional


class JsonlRun:
    """wandb.Run-compatible sink writing JSON lines locally."""

    def __init__(self, run_dir: Path, cfg: Optional[Dict[str, Any]] = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.run_dir / "metrics.jsonl"
        self._f = open(self.path, "a", buffering=1)
        self._summary: Dict[str, Any] = {}
        if cfg:
            self._write({"_type": "config", "config": cfg})

    def _write(self, obj: Dict[str, Any]) -> None:
        obj = dict(obj)
        obj.setdefault("_time", time.time())
        try:
            self._f.write(json.dumps(obj, default=float) + "\n")
        except Exception:
            pass

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {k: v for k, v in metrics.items() if _is_scalar(v)}
        if step is not None:
            rec["_step"] = step
        self._write(rec)
        self._summary.update(rec)

    def define_metric(self, *a, **k) -> None:
        pass

    def watch(self, *a, **k) -> None:
        pass

    def log_artifact(self, *a, **k) -> None:
        pass

    def finish(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass

    @property
    def summary(self) -> Dict[str, Any]:
        return self._summary


def _is_scalar(v: Any) -> bool:
    try:
        float(v)
        return True
    except Exception:
        return isinstance(v, (str, bool))


def init_metrics(
    *,
    run_dir: Path,
    project: str,
    entity: Optional[str],
    cfg: Dict[str, Any],
):
    """wandb online -> offline-on-403 -> local JSONL (wandb_utils.py:30-90)."""
    os.environ.setdefault("WANDB_SILENT", "true")
    try:
        import wandb  # noqa: F401

        try:
            run = wandb.init(
                project=project,
                entity=entity or None,
                name=Path(run_dir).name,
                dir=str(run_dir),
                config=cfg,
            )
        except Exception as e1:
            msg = str(e1)
            if "PERMISSION_ERROR" in msg or "403" in msg or "permission denied" in msg.lower():
                os.environ["WANDB_MODE"] = "offline"
                run = wandb.init(
                    project=project,
                    name=Path(run_dir).name,
                    dir=str(run_dir),
                    config=cfg,
                    settings=wandb.Settings(mode="offline"),
                )
            else:
                raise
        run.define_metric("global_step")
        run.define_metric("epoch")
        run.define_metric("loss/*", step_metric="global_step")
        run.define_metric("grad_norm", step_metric="global_step")
        return run
    except Exception:
        return JsonlRun(Path(run_dir), cfg)
