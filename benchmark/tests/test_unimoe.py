"""The ``unimoe`` family and the ``twopass_routed`` kind rehearsed on the
CPU through ``harness.run_cell``, on the tiny ``configs/mini-unimoe.json``
(no cell of ``BENCHMARK.json``) and held to the limits of
``unimoe2-omni.twopass-b8-384px``: a sound run comes out correct with its
metrics, the control and a routing fault planted under the timed path come
out not correct, and the family's FLOP count and the routed pairs' FLOPs
are pinned on fixed records."""

import copy
import json
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark.harness import BENCH_DIR, ROOT, cell_parts, limits_for, load_json, make_driver
from benchmark.harness import run_cell, window
from benchmark.tests.test_runs import planted

CELL = "unimoe2-omni.twopass-b8-384px"
MINI = "miniu.twopass"
SEED = 2**31 + 7


def mini_bench():
    """BENCHMARK.json with the rehearsal cell in place of its own, on every
    list that names the cell."""
    bench = copy.deepcopy(load_json(ROOT / "BENCHMARK.json"))
    bench["workloads"] = [{"name": MINI, "config": "mini-unimoe", "traffic": "twopass_b8_routed",
                           "chips": 1, "why": "CPU rehearsal"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [MINI] if CELL in m["workloads"] else []
    return bench


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """A copy of ``benchmark/`` whose routed mix is cut to CPU size."""
    d = tmp_path_factory.mktemp("unimoe") / "benchmark"
    shutil.copytree(BENCH_DIR, d, ignore=shutil.ignore_patterns("traces", ".cache",
                                                                "__pycache__"))
    p = d / "traffic" / "twopass_b8_routed.json"
    mix = load_json(p)
    mix.update({"batch": 4, "pool_batches": 2})
    p.write_text(json.dumps(mix))
    shutil.copy(d / "limits" / f"{CELL}.json", d / "limits" / f"{MINI}.json")
    return d


def rehearse(d, trace=False):
    torch.manual_seed(0)
    return run_cell(mini_bench(), MINI, SEED, 1.0, trace, torch.device("cpu"),
                    time.perf_counter(), bench_dir=d)


@pytest.mark.parametrize("trace", [False, True])
def test_the_routed_mix_runs_end_to_end_and_comes_out_correct(trace, mini):
    out = rehearse(mini, trace)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    got = set(out["metrics"])
    if trace:   # on the CPU: the wrappers' and the counters' metrics, no device trace
        assert got == {"pass1_ms.twopass", "pass2_ms.twopass", "between_passes_ms.twopass",
                       "vision_ms.twopass", "mfu.twopass"}
    else:
        assert got == {"samples_per_s", "setup_s"}


def _routing_dropped(orig):
    """Every token routed to no expert."""
    def route(*a, **k):
        chosen, w, null = orig(*a, **k)
        return chosen & False, w * 0, null
    return route


@pytest.mark.parametrize("mode", ["control", "routing-dropped"])
def test_the_control_and_a_routing_fault_come_out_not_correct(mode, mini):
    """The reference in the precision below the configuration's in the
    program's place reads at least three times the program on one number;
    a program that routes no token to an expert fails the cell's limits."""
    _cell, c, m = cell_parts(mini_bench(), MINI, mini)
    dev = torch.device("cpu")
    if mode == "routing-dropped":
        with planted("attwarp_tpu_torch.models.moe", "route", _routing_dropped):
            out = rehearse(mini)
        assert out["correct"] is False, out["compared"]
        return
    driver = make_driver(c, m, SEED + 4, dev, mini)
    _done, _failed, _w, _s, n = window(driver, 0.5, dev)
    limits = limits_for(MINI, mini)
    prog = driver.check(n, np.random.default_rng(1))
    ctl = driver.check(n, np.random.default_rng(1), precision="fp8", control=True)
    assert all(prog[k] <= lim for k, lim in limits.items()), prog
    assert any(ctl[k] > max(3 * prog[k], 1e-6) for k in limits), (prog, ctl)


def test_family_flops_and_routed_pair_flops_on_fixed_records(mini):
    """``request_flops`` of the mini by hand (attention, the two shared
    experts as one 256-wide SwiGLU, the 5-way router, the LM head), and
    the kind's counters on fixed records: the routed pairs of the tally's
    differences at 2 x 3 x 256 x 512 FLOPs each, beside the family's
    count."""
    _cell, c, m = cell_parts(mini_bench(), MINI, mini)
    driver = make_driver(c, m, SEED, torch.device("cpu"), mini)
    fam = driver.family
    # 5 tokens and 2 fed back through 3 layers of width 256, 2 heads of 128
    # over 1 kv head: q 256x256, k and v 256x128 each, o 256x256, the
    # shared SwiGLU 3 x 256x256
    per_token = 2 * (65536 + 2 * 32768 + 65536 + 3 * 65536)
    pairs = 28 * 4 * 128 * 2   # causal pairs of 7 tokens, 4 x head_dim x heads a pair
    want = 3 * (7 * per_token + pairs) + 3 * 2 * 256 * 160 + 2 * 256 * 5 * 3 * 7
    assert fam.request_flops(c, 5, 2, 3) == want == 16900608
    assert fam.routed_pair_flops(c) == 2 * 3 * 256 * 512 == 786432
    # one batch: two prompts a pass, and a tally that gained 40 pairs
    tally = torch.zeros((3, 6), dtype=torch.int64)
    gained = tally.clone()
    gained[:, :4] = torch.tensor([[3, 4, 1, 2], [5, 0, 5, 5], [4, 4, 4, 3]])
    gained[:, 5] = 30
    rec = {"mask1": torch.tensor([[False, True, True], [True, True, True]]),
           "mask2": torch.tensor([[True, True, True], [True, True, True]]),
           "tally": (tally, gained)}
    K, part = m["max_new_tokens"], c["extract_layer"] + 1
    dense = sum(fam.request_flops(c, n, K - 1, K, n_partial=p, partial_layers=part)
                + fam.image_flops(c)
                for mask, p in ((rec["mask1"], 1), (rec["mask2"], 0))
                for n in mask.sum(dim=1).tolist())
    got = driver.counters([rec])
    assert got["routed_pairs"] == 40.0 and got["routed_rows"] == 90.0
    assert got["model_flops"] == dense + 40 * 786432 == 256043520.0
