"""Each traffic mix rehearsed end to end on the CPU through the tiny
configurations (``tests/rehearse.py``), held to the limits of the cell it
stands for: a sound run comes out correct and prints its result line;
the control (the reference in the precision below the configuration's, in
the program's place) and each fault a cell can have, planted under the
timed path, come out not correct; without a card the benchmark prints no
result and exits non-zero, as does a run that has loaded JAX or the JAX
package."""

import contextlib
import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark.harness import (ROOT, cell_parts, compared_lines, finish, forbidden_modules,
                               limits_for, make_driver, result_line, window)
from benchmark.tests.rehearse import MINI_CELLS, mini_bench, mini_dir, rehearse


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("bench")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(MINI_CELLS))
def test_each_mix_runs_end_to_end_and_comes_out_correct(cell, trace, tmp):
    out = rehearse(cell, tmp, trace=trace)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    line = json.loads(result_line(out))
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    bench = mini_bench()
    want = {m["name"] for m in (bench["per_layer"] if trace else bench["end_to_end"])
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for name, v in line["compared"].items():
        assert v["limit"] is not None and v["value"] <= v["limit"], name
    assert len(compared_lines(out)) == len(line["compared"])


def _alter_answer(gen):
    gen = gen.clone()
    gen[0] = (gen[0] + 1) % 100
    return gen


@contextlib.contextmanager
def planted(target: str, attr: str, make):
    """``attr`` of ``target`` (a module, or ``module:Class``) replaced by
    ``make(original)`` for the body."""
    import importlib

    mod, _, cls = target.partition(":")
    obj = importlib.import_module(mod)
    obj = getattr(obj, cls) if cls else obj
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def answer_altered(orig):
    """One sample's answer altered where the model produces it."""
    def gen(self, *a, **k):
        out, maps = orig(self, *a, **k)
        return _alter_answer(out), maps
    return gen


def half_left_out(orig):
    """The second half of a batch's warped images never written."""
    def resample(images, map_x, map_y):
        out = orig(images, map_x, map_y)
        out[out.shape[0] // 2:] = 0
        return out
    return resample


def state_unchanged(orig):
    """A decode step that leaves the cache as it found it."""
    return lambda *a, **k: None


def tokens_altered(orig):
    def sample(*a, **k):
        return (orig(*a, **k) + 1) % 100
    return sample


def answers_dropped(orig):
    """Half of a batch's requests served no answer."""
    def serve(*a, **k):
        engine, outs = orig(*a, **k)
        return engine, [o if i % 2 else [] for i, o in enumerate(outs)]
    return serve


FAULTS = {
    "mini.twopass": [("attwarp_tpu_torch.models.llava:LlavaModel", "generate_with_attention",
                      answer_altered),
                     ("attwarp_tpu_torch.warp.warp", "warp_resample", half_left_out),
                     ("attwarp_tpu_torch.models.llama", "append_token", state_unchanged)],
    "miniq.twopass": [("attwarp_tpu_torch.models.qwen2vl:Qwen2VLModel",
                       "generate_with_attention", answer_altered),
                      ("attwarp_tpu_torch.warp.warp", "warp_resample", half_left_out),
                      ("attwarp_tpu_torch.models.llama", "append_token", state_unchanged)],
    "mini.serve": [("attwarp_tpu_torch.serving.engine", "sample_tokens", tokens_altered),
                   ("attwarp_tpu_torch.cli.serve", "serve", answers_dropped),
                   ("attwarp_tpu_torch.models.llama", "append_token", state_unchanged)],
}


@pytest.mark.parametrize("cell,fault", [(c, i) for c, fs in FAULTS.items()
                                        for i in range(len(fs))])
def test_a_fault_planted_under_the_timed_path_comes_out_not_correct(cell, fault, tmp):
    target, attr, make = FAULTS[cell][fault]
    with planted(target, attr, make):
        out = rehearse(cell, tmp)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("cell", sorted(MINI_CELLS))
def test_the_control_comes_out_not_correct(cell, tmp):
    """The control in the program's place at the rehearsal's size. The
    program passes every limit of the cell it stands for; the control reads
    at least three times the program on one of the cell's numbers (at the
    cell's own size, on the card, its readings lie above the limits: the
    readings in ``limits/<cell>.json``, which ``control.py`` takes)."""
    config, mix, _ = MINI_CELLS[cell]
    d = mini_dir(tmp)
    bench = mini_bench()
    _cell, c, m = cell_parts(bench, cell, d)
    dev = torch.device("cpu")
    driver = make_driver(c, m, 2**31 + 11, dev)
    done, failed, _w, _s, n = window(driver, 0.5, dev)
    if hasattr(driver, "close_window"):
        driver.close_window()
    limits = limits_for(cell, d)
    prog = driver.check(n, np.random.default_rng(1))
    ctl = driver.check(n, np.random.default_rng(1), precision="fp8", control=True)
    assert all(prog[k] <= lim for k, lim in limits.items()), prog
    assert any(ctl[k] > max(3 * prog[k], 1e-6) for k in limits), (prog, ctl)


def test_without_a_card_the_benchmark_prints_nothing_and_fails():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "llava15-7b.twopass-b8", "--seed", str(2**31 + 5), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_a_sound_run_prints_its_result_line_and_exits_0(tmp, capsys):
    out = rehearse("mini.twopass", tmp)
    assert out["correct"] and out["forbidden_modules"] == []
    assert "attwarp_tpu_torch" in sys.modules and forbidden_modules() == []
    assert finish(out) == 0
    cap = capsys.readouterr()
    assert cap.out.splitlines()[-1] == result_line(out)
    assert cap.err.splitlines()[-len(out["compared"]):] == compared_lines(out)


@pytest.mark.parametrize("module", ["jax", "attwarp_tpu.warp"])
def test_a_run_that_loads_jax_or_the_jax_package_prints_no_result(module, tmp, monkeypatch,
                                                                  capsys):
    """A module of JAX or of the JAX package in ``sys.modules`` once the
    window has closed: the run is not correct, names it on standard error,
    prints nothing on standard output and exits non-zero."""
    monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
    out = rehearse("mini.twopass", tmp)
    assert out["correct"] is False and out["forbidden_modules"] == [module]
    assert finish(out) != 0
    cap = capsys.readouterr()
    assert cap.out == "" and module in cap.err.splitlines()[-1]
