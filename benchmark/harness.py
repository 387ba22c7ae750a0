"""The benchmark's run of one cell, driven by data.

Everything a cell is made of is found by name, as a file of its own: the
cell in ``BENCHMARK.json``'s ``workloads``; its configuration in
``benchmark/configs/<config>.json``, whose ``family`` names
``benchmark/families/<family>.py``; its traffic mix in
``benchmark/traffic/<traffic>.json``, whose ``kind`` names
``benchmark/kinds/<kind>.py``; its limits in ``benchmark/limits/<cell>.json``;
each per-layer metric's reader in ``benchmark/metrics/<metric>.py``; and each
hand-written kernel in ``benchmark/kernels/<kernel>.py``. Python files are
loaded by path from the benchmark's directory, so a new cell, configuration,
family, mix, kind, metric or kernel is a new file, and no file already there
changes. What each must export:

- a family: ``make_params(c, seed, device)``, ``make_backend(c, params)``,
  ``image_size(c)``, ``map_side(c)``, ``eos_token(c)``, ``image_token(c)``,
  ``reference(c, params, precision)``, and the model FLOPs it needs,
  ``image_flops(c)`` (one image through the vision tower and projector) and
  ``request_flops(c, n_prompt, n_fed, n_head, n_partial=0,
  partial_layers=0)`` (one sequence through the decoder; see
  ``counts/model_flops.py::decoder_flops``);
- a kind: ``DRIVER``, a class built as ``DRIVER(family, c, mix, seed,
  device)`` with ``batch_units``, ``records``, ``warm_up()``, ``step(i)``
  (units done), ``spans()``, ``trace_unit(i, start, stop)``,
  ``counters(records)`` and ``check(n_window, rng, precision, control)``,
  and if it needs them ``close_window()`` and ``check_info``;
- a metric: ``LAYER``, ``MOVES`` and ``read(reading)``, which returns None
  where it finds nothing to read;
- a kernel: ``ENTRIES``, ``TRACE_NAMES``, ``record`` and ``work``
  (``kernel_table``).

A run: set-up (import, the kernel library, weights made on the card, the
cell's own shapes warmed up), then batches back to back until ``seconds``
have passed; the window closes at the end of the batch that crosses it, and
a rate is all the work of the window over all its time. With ``trace`` the
same window runs with spans on and gives the per-layer metrics, and a slice
after it is traced on the device with no spans. Then the peak memory is
read, the program's state freed, and what the window produced is compared
with the plain reference (``correct``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
import traceback
from contextlib import ExitStack
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "benchmark"


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_parts(bench: Dict[str, Any], name: str, bench_dir: Path = BENCH_DIR):
    cell = find_cell(bench, name)
    return (cell, load_json(bench_dir / "configs" / f"{cell['config']}.json"),
            load_json(bench_dir / "traffic" / f"{cell['traffic']}.json"))


def load_file(path: Path) -> ModuleType:
    """The Python file at ``path``, loaded by path as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_driver(config: Dict[str, Any], mix: Dict[str, Any], seed: int, device,
                bench_dir: Path = BENCH_DIR):
    family = load_file(bench_dir / "families" / f"{config['family']}.py")
    kind = load_file(bench_dir / "kinds" / f"{mix['kind']}.py")
    return kind.DRIVER(family, config, mix, seed, device)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_file(bench_dir / "metrics" / f"{name}.py")


def kernel_table(kernels_dir: Path) -> Dict[str, ModuleType]:
    """Each hand-written kernel's file under ``kernels_dir``, by its name
    (``benchmark/kernels/<kernel>.py``). A kernel file exports ``ENTRIES``,
    the (module, attribute) of each place the program looks the kernel up;
    ``TRACE_NAMES``, substrings of its device kernels' names in the trace;
    ``record(args, kwargs, count)``, a call's record from its arguments
    (``count(mask, dim=None)`` is a device reduction, read after the
    slice); and ``work(record)``, the call's (bytes, flops) at the bf16
    peak (``counts/roofline.py``)."""
    return {p.stem: load_file(p) for p in sorted(kernels_dir.glob("*.py"))}


# JAX, and the JAX package the port was made from: no run may load them
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "attwarp_tpu")


def forbidden_modules() -> List[str]:
    """The modules of ``FORBIDDEN_MODULES`` in ``sys.modules``, compared by
    whole top-level name (``attwarp_tpu_torch`` is not ``attwarp_tpu``)."""
    return sorted(n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN_MODULES)


class Reading:
    """What the per-layer readers read: spans (seconds by name), the
    window's batch walls, the kind's counters, the trace's summary and the
    hand-written kernels' summed least time in the traced slice."""

    def __init__(self, spans, batch_walls, window_s, counters, trace=None,
                 kernel_least_s=None):
        self.spans: Dict[str, List[float]] = spans
        self.batch_walls: List[float] = batch_walls
        self.window_s: float = window_s
        self.counters: Dict[str, float] = counters
        self.trace: Optional[Dict[str, Any]] = trace
        self.kernel_least_s: Dict[str, float] = kernel_least_s or {}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(driver, seconds: float, device, start_index: int = 0):
    """Batches back to back until ``seconds`` have passed. Returns
    (completed units, failed units, batch walls, window seconds, batches)."""
    done = failed = 0
    walls: List[float] = []
    t0 = time.perf_counter()
    i = start_index
    while True:
        tb = time.perf_counter()
        try:
            done += driver.step(i)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            failed += driver.batch_units
        _sync(device)
        t1 = time.perf_counter()
        walls.append(t1 - tb)
        i += 1
        if t1 - t0 >= seconds:
            return done, failed, walls, t1 - t0, i - start_index


def limits_for(cell_name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, float]:
    path = bench_dir / "limits" / f"{cell_name}.json"
    return load_json(path)["limits"] if path.exists() else {}


def run_cell(bench: Dict[str, Any], name: str, seed: int, seconds: float, trace: bool,
             device, t_process: float, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    import torch

    cell, config, mix = cell_parts(bench, name, bench_dir)
    parts: Dict[str, float] = {}
    import attwarp_tpu_torch  # noqa: F401  the program
    if device.type == "cuda":
        from attwarp_tpu_torch.kernels._build import library

        library()
        torch.cuda.synchronize(device)
    parts["import_and_library_s"] = time.perf_counter() - t_process
    t = time.perf_counter()
    driver = make_driver(config, mix, seed, device, bench_dir)
    _sync(device)
    parts["weights_and_inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    driver.warm_up()
    _sync(device)
    parts["warm_up_s"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # what set-up made stays alive to the end: the collector need not trace it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process

    from benchmark.instrument import KernelCalls, Spans, patched

    spans = Spans()
    with ExitStack() as stack:
        if trace:
            for target, attr, span in driver.spans():
                stack.enter_context(patched(target, attr, lambda f, s=span: spans.wrap(s, f)))
            entry = config.get("vision_entry")
            if entry:
                stack.enter_context(patched(importlib.import_module(entry["module"]),
                                            entry["function"],
                                            lambda f: spans.wrap("vision", f)))
        done, failed, walls, window_s, n_batches = window(driver, seconds, device)
    if hasattr(driver, "close_window"):
        driver.close_window()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    out: Dict[str, Any] = {}
    e2e = {m["name"]: m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    if not trace:
        rate_name = next(n for n in e2e if n != "setup_s")
        out["metrics"] = {rate_name: {"value": done / window_s, "unit": e2e[rate_name]["unit"]},
                          "setup_s": {"value": setup_s, "unit": "s"}}
    else:
        counters = driver.counters(driver.records[:n_batches])
        summary, least = None, {}
        if device.type == "cuda":
            from benchmark import trace as tr

            calls = KernelCalls(kernel_table(bench_dir / "kernels"))
            with calls.installed():
                summary = tr.trace_and_reduce(
                    lambda start, stop: driver.trace_unit(n_batches, start, stop),
                    bench_dir / "traces" / name, calls.trace_names(),
                    on_start=calls.start, on_stop=calls.stop)
            least = calls.least_seconds()
            with open(bench_dir / "traces" / name / "kernel_least_s.json", "w") as f:
                json.dump(least, f)
        reading = Reading(spans.times, walls, window_s, counters, summary, least)
        metrics = {}
        for m in bench["per_layer"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            v = metric_reader(m["name"], bench_dir).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["metrics"] = metrics
        if summary is not None:
            out["breakdown"] = {"device_ops": summary["device_ops"],
                                "idle_gaps": summary["idle_gaps"]}
            out["trace"] = {k: summary[k] for k in ("busy_s", "window_s", "trace_bytes",
                                                    "n_device_ops", "trace_wall_s",
                                                    "reduce_wall_s")}

    # the check, after the window, with the program's transient state freed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rng = np.random.default_rng([seed % 2**63, 9])
    compared = driver.check(n_batches, rng) if done else {}
    check_s = time.perf_counter() - t
    limits = limits_for(name, bench_dir)
    loaded = forbidden_modules()
    correct = (failed == 0 and done > 0 and bool(limits) and not loaded
               and all(k in compared and compared[k] <= lim for k, lim in limits.items()))
    out.update({"correct": correct, "attempted": done + failed, "failed": failed})
    out["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                     "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                              else "cpu"),
                     "count": 1, "memory_peak_bytes": int(peak)}
    if trace and out.get("trace"):
        out["device"]["busy_s"] = out["trace"]["busy_s"]
        out["device"]["window_s"] = out["trace"]["window_s"]
    tenth = max(1, len(walls) // 10)
    out["info"] = {"window_s": window_s, "batches": n_batches, "setup_parts": parts,
                   "batch_wall_tenths_s": [sum(walls[j:j + tenth]) / len(walls[j:j + tenth])
                                           for j in range(0, len(walls), tenth)],
                   "check_s": check_s, **getattr(driver, "check_info", {})}
    out["compared"] = {k: {"value": v, "limit": limits.get(k)} for k, v in compared.items()}
    out["forbidden_modules"] = loaded
    return out


RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "compared")


def result_line(out: Dict[str, Any]) -> str:
    """The run's last line of standard output: one JSON object, ``compared``
    (each number the check compared, with its limit) last."""
    return json.dumps({k: out[k] for k in RESULT_KEYS if k in out})


def finish(out: Dict[str, Any]) -> int:
    """The end of a run: the compared numbers on standard error, then the
    result line on standard output, and 0. Where JAX or the JAX package is
    loaded once the window has closed, the modules are named on standard
    error, no result is printed, and the run exits with 4."""
    print(json.dumps({k: out[k] for k in ("info", "trace") if k in out}), file=sys.stderr)
    for line in compared_lines(out):
        print(line, file=sys.stderr)
    loaded = sorted(set(out.get("forbidden_modules", [])) | set(forbidden_modules()))
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 4
    print(result_line(out))
    return 0


def compared_lines(out: Dict[str, Any]) -> List[str]:
    """The compared numbers beside their limits, for the end of standard
    error."""
    return [f"compared {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in out["compared"].items()]
