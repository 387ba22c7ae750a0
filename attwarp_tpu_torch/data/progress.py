"""Resumable pipeline progress (a copy of ``attwarp_tpu/data/progress.py``,
which the port may not import; ``tests/test_torch_dataset.py`` pins the two
to the same manifest).

Replaces the reference's pickle checkpoint (``main.py:185-200,272-291``;
``main_batched.py:105-119,147-179``) with a JSON manifest written by atomic
rename, keeping the exact resume semantics: the processed-index set is
persisted after every item/batch, SIGINT/SIGTERM and interpreter exit flush
it, and on startup processed indices are filtered out.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import tempfile
import threading
from typing import Iterable, List, Set


class ProgressManifest:
    def __init__(self, path: str):
        self.path = path
        self.last_processed_internal_idx: int = -1
        self.processed_internal_indices: Set[int] = set()
        self.processed_count: int = 0
        self.failed_count: int = 0
        self._handlers_installed = False
        # mark()/save() are called from both the driver's producer loop and
        # its writer thread (cli/process_dataset.py); serialize them so the
        # counters don't race and a concurrent save can't persist a manifest
        # missing an in-flight index (re-processing it on resume).
        self._lock = threading.RLock()
        self.load()

    # ── persistence ────────────────────────────────────────────────────
    def load(self) -> bool:
        if not os.path.exists(self.path):
            return False
        try:
            with open(self.path, "r") as f:
                d = json.load(f)
            self.last_processed_internal_idx = int(d.get("last_processed_internal_idx", -1))
            self.processed_internal_indices = set(
                int(i) for i in d.get("processed_internal_indices", [])
            )
            self.processed_count = int(d.get("processed_count", 0))
            self.failed_count = int(d.get("failed_count", 0))
            return True
        except Exception as e:
            print(f"Error loading progress manifest {self.path}: {e}. Starting fresh.")
            return False

    def save(self) -> None:
        with self._lock:
            d = {
                "last_processed_internal_idx": self.last_processed_internal_idx,
                "processed_internal_indices": sorted(self.processed_internal_indices),
                "processed_count": self.processed_count,
                "failed_count": self.failed_count,
            }
            dirname = os.path.dirname(self.path) or "."
            os.makedirs(dirname, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(d, f)
                os.replace(tmp, self.path)  # atomic
            except Exception:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    # ── bookkeeping ────────────────────────────────────────────────────
    def mark(self, idx: int, failed: bool = False, save: bool = True) -> None:
        with self._lock:
            if failed:
                self.failed_count += 1
            else:
                self.processed_count += 1
            self.processed_internal_indices.add(idx)
            self.last_processed_internal_idx = max(
                self.last_processed_internal_idx, idx
            )
            if save:
                self.save()

    def mark_many(self, idxs: Iterable[int], failed: bool = False) -> None:
        with self._lock:
            for i in idxs:
                self.mark(i, failed=failed, save=False)
            self.save()

    def remaining(self, total: int) -> List[int]:
        return [i for i in range(total) if i not in self.processed_internal_indices]

    # ── signal / exit hooks ────────────────────────────────────────────
    def install_handlers(self) -> None:
        """atexit + SIGINT/SIGTERM flush (main.py:283-290)."""
        if self._handlers_installed:
            return
        atexit.register(self._flush_quiet)

        def handler(sig, frame):
            print("\nInterruption detected. Saving progress before exiting...")
            self._flush_quiet()
            sys.exit(0)

        for s in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(s, handler)
            except ValueError:
                pass  # non-main thread
        self._handlers_installed = True

    def _flush_quiet(self) -> None:
        try:
            self.save()
        except Exception as e:
            print(f"Error saving progress manifest: {e}")
