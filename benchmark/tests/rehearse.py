"""CPU rehearsal of the benchmark's runs: every traffic mix end to end
through the tiny configuration ``configs/mini-llava.json`` (no cell of
``BENCHMARK.json``), the program's kernels in their plain CPU forms."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Any, Dict

import torch

from benchmark.harness import BENCH_DIR, ROOT, load_json, run_cell

# a rehearsal cell -> (configuration, mix, the cell whose limits it is held to)
MINI_CELLS = {"mini.twopass": ("mini-llava", "twopass_b8", "llava15-7b.twopass-b8"),
              "miniq.twopass": ("mini-qwen2vl", "twopass_b8", "qwen2vl-7b.twopass-b8-672px"),
              "mini.serve": ("mini-llava", "serve_vqa", "llava15-7b.serve-vqa")}
RATE = {"twopass_b8": "samples_per_s", "serve_vqa": "served_tok_per_s"}

# smaller batches, so that a CPU run takes seconds
MINI_MIX = {"twopass_b8": {"batch": 4, "pool_batches": 2},
            "serve_vqa": {"requests": 6, "slots": 4, "pool_batches": 2, "check_requests": 4,
                          "question_words": [2, 6], "max_new_tokens": [2, 12]}}


def mini_bench() -> Dict[str, Any]:
    """BENCHMARK.json with the rehearsal cells in place of its own."""
    bench = copy.deepcopy(load_json(ROOT / "BENCHMARK.json"))
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "CPU rehearsal"} for n, (c, t, _) in MINI_CELLS.items()]
    for m in bench["end_to_end"]:
        if m["name"] != "setup_s":
            m["workloads"] = [n for n, (_, t, _) in MINI_CELLS.items() if RATE[t] == m["name"]]
    for m in bench["per_layer"]:
        suffix = m["name"].rsplit(".", 1)[1]
        m["workloads"] = [n for n in MINI_CELLS if n.endswith(suffix)]
    return bench


def mini_dir(tmp: Path) -> Path:
    """A copy of ``benchmark/`` whose mixes are cut to CPU size."""
    import shutil

    d = tmp / "benchmark"
    shutil.copytree(BENCH_DIR, d, dirs_exist_ok=True, ignore=shutil.ignore_patterns("traces", ".cache",
                                                                "__pycache__"))
    for mix, over in MINI_MIX.items():
        p = d / "traffic" / f"{mix}.json"
        m = load_json(p)
        m.update(over)
        p.write_text(json.dumps(m))
    for name, (_, _, cell) in MINI_CELLS.items():
        shutil.copy(d / "limits" / f"{cell}.json", d / "limits" / f"{name}.json")
    return d


def rehearse(name: str, tmp: Path, seconds: float = 1.0, trace: bool = False,
             seed: int = 2**31 + 7) -> Dict[str, Any]:
    torch.manual_seed(0)
    return run_cell(mini_bench(), name, seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), bench_dir=mini_dir(tmp))
