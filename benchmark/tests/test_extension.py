"""A model family, a traffic kind and a hand-written kernel join the
benchmark as new files only. A copy of ``benchmark/`` gets a toy family
(LLaVA-1.5's builders with FLOP counts of its own), a toy kind (the two-pass
driver, subclassed), a toy kernel, a configuration and a mix that name them,
and nothing else: the harness runs a cell of them on the CPU, untraced and
traced, and ``KernelCalls`` records the toy kernel and gives its least time,
with no file of the harness edited."""

import json
import time

import pytest
import torch

from benchmark.counts import roofline
from benchmark.counts.model_flops import BF16_PEAK_FLOPS
from benchmark.harness import BENCH_DIR, kernel_table, load_json, run_cell
from benchmark.instrument import KernelCalls
from benchmark.tests.rehearse import mini_bench, mini_dir

IMAGE_FLOPS = 3 * 10**9
REQUEST_FLOPS = 5 * 10**9
CELL = "toy.twopass"

FAMILY = f'''"""A toy family: LLaVA-1.5's builders with counts of its own."""

from benchmark.families.llava import (eos_token, image_size, image_token,  # noqa: F401
                                      make_backend, make_params, map_side, reference)


def image_flops(c):
    return {IMAGE_FLOPS}


def request_flops(c, n_prompt, n_fed, n_head, n_partial=0, partial_layers=0):
    return {REQUEST_FLOPS}
'''

KIND = '''"""A toy kind: the two-pass driver, marking its check."""

from benchmark.kinds.twopass import TwoPass


class ToyTwoPass(TwoPass):
    def check(self, *args, **kwargs):
        self.check_info = {"toy_kind": 1}
        return super().check(*args, **kwargs)


DRIVER = ToyTwoPass
'''

KERNEL = '''"""A toy kernel at K1's entry: its record is the batch and the image's
positive values, counted on the device."""

ENTRIES = [("attwarp_tpu_torch.warp.warp", "warp_resample")]
TRACE_NAMES = ("toy_kernel",)


def record(args, kwargs, count):
    return (args[0].shape[0], count(args[0] > 0))


def work(rec):
    B, n = rec
    return 1000 * B, 2 * int(n)
'''


def _snapshot(d):
    return {p: (p.stat().st_size, p.stat().st_mtime_ns) for p in d.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    d = mini_dir(tmp_path_factory.mktemp("extension"))
    cfg = load_json(d / "configs" / "mini-llava.json")
    cfg.update(name="toy", family="toy")
    mix = load_json(d / "traffic" / "twopass_b8.json")
    mix["kind"] = "toy_twopass"
    new = {d / "families" / "toy.py": FAMILY, d / "kinds" / "toy_twopass.py": KIND,
           d / "kernels" / "toy.py": KERNEL, d / "configs" / "toy.json": json.dumps(cfg),
           d / "traffic" / "toy_mix.json": json.dumps(mix),
           d / "limits" / f"{CELL}.json":
               (d / "limits" / "llava15-7b.twopass-b8.json").read_text()}
    for path, text in new.items():
        assert not path.exists(), path
        path.write_text(text)
    bench = mini_bench()
    bench["workloads"].append({"name": CELL, "config": "toy", "traffic": "toy_mix", "chips": 1,
                               "why": "CPU rehearsal of a family, a kind and a kernel as files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "samples_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append(CELL)
    return d, bench, mix


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_of_a_new_family_and_kind_runs_from_new_files(toy, trace):
    d, bench, mix = toy
    before = _snapshot(BENCH_DIR)
    torch.manual_seed(0)
    out = run_cell(bench, CELL, 2**31 + 13, 1.0, trace, torch.device("cpu"),
                   time.perf_counter(), bench_dir=d)
    assert _snapshot(BENCH_DIR) == before     # nothing written outside the copy
    assert out["correct"], out["compared"]
    assert out["info"]["toy_kind"] == 1
    if not trace:
        assert set(out["metrics"]) == {"samples_per_s", "setup_s"}
        return
    # each sample: two passes, each one image and one request
    flops = out["info"]["batches"] * mix["batch"] * 2 * (IMAGE_FLOPS + REQUEST_FLOPS)
    assert out["metrics"]["mfu.twopass"]["value"] == pytest.approx(
        100.0 * flops / out["info"]["window_s"] / BF16_PEAK_FLOPS, rel=1e-12)


def test_a_new_kernel_file_is_recorded_and_gives_its_least_time(toy):
    from attwarp_tpu_torch.warp import warp as warp_mod

    d, _bench, _mix = toy
    table = kernel_table(d / "kernels")
    assert set(table) == {"k1", "k2", "k3", "toy"}
    calls = KernelCalls(table)
    images = torch.randn(2, 8, 8, 3)
    map_x = torch.linspace(0, 7, 6).repeat(2, 1)
    map_y = torch.linspace(0, 7, 5).repeat(2, 1)
    with calls.installed():
        calls.start()
        warp_mod.warp_resample(images, map_x, map_y)
        calls.stop()
        warp_mod.warp_resample(images, map_x, map_y)   # outside the slice
    assert warp_mod.warp_resample.__name__ == "warp_resample"   # removed again
    n = int((images > 0).sum())
    least = calls.least_seconds()
    assert set(least) == {"k1", "toy"}
    assert least["toy"] == roofline.bound(2000, 2 * n)["bound_ms"] / 1e3
    assert least["k1"] == roofline.bound(*roofline.k1_work(2, 8, 8, 3, 5, 6))["bound_ms"] / 1e3
    assert calls.trace_names()["toy"] == ("toy_kernel",)
