"""The metric arithmetic: the trace's idle share and each kernel's time
(the union of its intervals), the engine's slot occupancy and admission
share, rates over the whole window with a batch that straddles its end, and
each per-layer reader against the BENCHMARK.json entry that names it."""

import json

import pytest
import torch

from benchmark.harness import BENCH_DIR, ROOT, Reading, load_file, metric_reader, window
from benchmark.kinds.serve_batch import ServeBatch
from benchmark.trace import SLICE, merge, reduce_trace


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def synthetic_trace():
    """A 100 us slice: kernels at [10, 30), [20, 40) (overlapping) and
    [60, 70), a copy at [90, 95); the host in aten::mm over [40, 60) and
    nowhere over [70, 90)."""
    return [
        _ev(SLICE, "user_annotation", 0, 100),
        _ev("flash_prefill_kernel", "kernel", 10, 20),
        _ev("nvjet_gemm", "kernel", 20, 20),
        _ev("decode_attn_mha(args)", "kernel", 60, 10),
        _ev("Memcpy DtoH", "gpu_memcpy", 90, 5),
        _ev("aten::mm", "cpu_op", 38, 25),
        _ev("aten::linear", "cpu_op", 35, 40),
        _ev("aten::item", "cpu_op", 0, 9),
    ]


def test_union_counts_overlapping_kernels_once():
    assert merge([(10, 30), (20, 40), (60, 70), (65, 66)]) == [(10, 40), (60, 70)]


def test_reduce_trace_idle_share_kernel_sums_and_gaps():
    s = reduce_trace(synthetic_trace(), {"k2": ("flash_prefill_kernel",),
                                         "k3": ("decode_attn_mha", "decode_merge_kernel"),
                                         "k1": ("warp_resample_kernel",)})
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)          # 30 + 10 + 5, overlap once
    assert s["kernel_s"] == pytest.approx({"k2": 20e-6, "k3": 10e-6})
    assert "k1" not in s["kernel_s"]
    gaps = [(n, round(t * 1e6)) for n, t in s["idle_gaps"]]
    # longest first: [40, 60) under aten::mm (the innermost op, not
    # aten::linear), [70, 90) under no op; then [0, 10) and [95, 100)
    assert sorted(gaps[:2]) == [("aten::mm", 20), ("host: between operations", 20)]
    assert ("aten::item", 10) in gaps and len(gaps) == 4
    idle = metric_reader("device_idle_pct.twopass").read(
        Reading({}, [], 1.0, {}, trace=s))
    assert idle == pytest.approx(55.0)


def test_kernel_time_is_the_union_of_its_intervals_inside_the_slice():
    """A split kernel and the merge kernel it launches as a programmatic
    dependent overlap: their union counts, not the sum of their durations.
    Serial calls of one kernel read their sum; a call that runs past the
    slice counts only inside it."""
    ev = split_merge_trace()
    s = reduce_trace(ev, {"k1": ("warp_resample_kernel",), "k2": ("flash_prefill_kernel",),
                          "k3": ("decode_attn_gqa", "decode_merge_kernel")})
    assert s["kernel_s"] == pytest.approx({"k3": (12 + 9) * 1e-6, "k2": (50 + 20) * 1e-6})
    # the sum of K3's durations would read 35 us; of K2's inside, as before
    assert s["busy_s"] == pytest.approx((12 + 9 + 50 + 20) * 1e-6)
    r = Reading({}, [], 1.0, {}, trace=s, kernel_least_s={"k3": 10.5e-6, "k2": 35e-6})
    assert metric_reader("k3_roofline.twopass").read(r) == pytest.approx(50.0)
    assert metric_reader("k2_roofline.serve").read(r) == pytest.approx(50.0)


def split_merge_trace():
    """A 1000 us slice from 100 us with K3's split and merge kernels
    overlapping twice, K2 called twice, and K1 only before the slice."""
    return [_ev(SLICE, "user_annotation", 100, 1000),
            # K3: split [100, 110), merge starts inside it and ends at 112
            _ev("decode_attn_gqa<128>", "kernel", 100, 10),
            _ev("decode_merge_kernel", "kernel", 101, 11),
            # and again at [200, 208) with its merge at [203, 209)
            _ev("decode_attn_gqa<128>", "kernel", 200, 8),
            _ev("decode_merge_kernel", "kernel", 203, 6),
            # K2: two serial calls, the second running 20 us past the slice
            _ev("flash_prefill_kernel", "kernel", 300, 50),
            _ev("flash_prefill_kernel", "kernel", 1080, 40),
            # K1 before the slice only
            _ev("warp_resample_kernel", "kernel", 10, 30)]


def test_the_offline_reducer_reads_each_kernel_by_sum_and_by_union(tmp_path, capsys):
    """``kernel_times.py`` on a saved trace: K3's split and merge by the sum
    of their durations (35 us) and by their union (21 us); K2's sum keeps
    the 20 us past the slice, its union does not; with the run's least
    times, the roofline share both ways."""
    from benchmark import kernel_times

    ev = split_merge_trace()
    names = {"k1": ("warp_resample_kernel",), "k2": ("flash_prefill_kernel",),
             "k3": ("decode_attn_gqa", "decode_merge_kernel")}
    t = kernel_times.kernel_times(ev, names)
    assert t["k3"] == pytest.approx((35e-6, 21e-6))
    assert t["k2"] == pytest.approx((90e-6, 70e-6))
    assert t["k1"] == pytest.approx((30e-6, 0.0))
    assert t["k3"][1] == pytest.approx(reduce_trace(ev, names)["kernel_s"]["k3"])
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": ev}))
    (tmp_path / "kernel_least_s.json").write_text(json.dumps({"k3": 10.5e-6}))
    assert kernel_times.main([str(tmp_path)]) == 0
    k3 = next(line for line in capsys.readouterr().out.splitlines() if line.startswith("k3:"))
    share = [float(x) for x in k3.split("roofline % sum ")[1].split(" union ")]
    assert share == pytest.approx([30.0, 50.0])


def test_kernel_roofline_reader_is_least_over_device_time_and_silent_without_kernel():
    s = reduce_trace(synthetic_trace(), {"k2": ("flash_prefill_kernel",)})
    r = Reading({}, [], 1.0, {}, trace=s, kernel_least_s={"k2": 10e-6})
    assert metric_reader("k2_roofline.twopass").read(r) == pytest.approx(50.0)
    assert metric_reader("k1_roofline.twopass").read(r) is None
    assert metric_reader("k3_roofline.serve").read(r) is None


class _Log:
    """What ``ServeBatch.counters`` reads of one engine batch."""

    def __init__(self):
        self.pool = [([{"input_ids": [1] * 10}, {"input_ids": [1] * 12}], 64)]
        self.c = {"family": "llava", "vision_config": {"hidden_size": 8, "intermediate_size": 16,
                                                       "num_hidden_layers": 1, "image_size": 28,
                                                       "patch_size": 14},
                  "vision_feature_layer": -1,
                  "text_config": {"hidden_size": 8, "num_attention_heads": 2,
                                  "num_key_value_heads": 1, "intermediate_size": 16,
                                  "vocab_size": 10, "num_hidden_layers": 2}}


def test_slot_occupancy_and_admission_share_from_hand_made_logs():
    d = ServeBatch.__new__(ServeBatch)
    log = _Log()
    d.pool, d.c = log.pool, log.c
    d.family = load_file(BENCH_DIR / "families" / "llava.py")
    # 2 slots, 3 ticks of 4 steps = 12 decode steps x 2 slots = 24 slot-steps;
    # 4 + 4, 4 + 2, 3 tokens kept = 17; admissions of 0.5 s and 0.25 s
    rec = {"pool": 0, "outs": [[5] * 9, [6] * 10], "decode_steps": 12, "slots": 2,
           "tick_log": [(1.0, {0: 4, 1: 4}), (2.0, {0: 4, 1: 2}), (3.0, {0: 3})],
           "admit_log": [(0.0, 0.5, 2), (1.5, 1.75, 1)]}
    c = d.counters([rec])
    assert c["tokens_kept"] == 17 and c["slot_steps"] == 24
    r = Reading({}, [4.0], 4.0, c)
    assert metric_reader("slot_occupancy.serve").read(r) == pytest.approx(100 * 17 / 24)
    assert metric_reader("admission_pct.serve").read(r) == pytest.approx(100 * 0.75 / 4.0)
    assert metric_reader("mfu.serve").read(r) > 0


class _Clocked:
    """A driver whose batches take fixed host times."""

    batch_units = 8

    def __init__(self, secs, clock):
        self.secs, self.clock = secs, clock

    def step(self, i):
        self.clock["t"] += self.secs[i]
        return 8


def test_rate_counts_all_work_over_the_whole_window_with_the_straddling_batch(monkeypatch):
    clock = {"t": 100.0}
    monkeypatch.setattr("benchmark.harness.time.perf_counter", lambda: clock["t"])
    d = _Clocked([1.0, 1.5, 2.0, 9.0], clock)
    done, failed, walls, window_s, n = window(d, 3.0, torch.device("cpu"))
    # batches end at 1.0, 2.5, 4.5: the third crosses 3 s and closes the window
    assert (done, failed, n) == (24, 0, 3)
    assert walls == [1.0, 1.5, 2.0]
    assert window_s == pytest.approx(4.5)
    assert done / window_s == pytest.approx(24 / 4.5)


def test_failed_batch_counts_its_units_and_the_window_goes_on(monkeypatch):
    clock = {"t": 0.0}
    monkeypatch.setattr("benchmark.harness.time.perf_counter", lambda: clock["t"])

    class Failing(_Clocked):
        def step(self, i):
            self.clock["t"] += 1.0
            if i == 1:
                raise RuntimeError("planted")
            return 8

    done, failed, _w, window_s, n = window(Failing([], clock), 2.5, torch.device("cpu"))
    assert (done, failed, n, window_s) == (16, 8, 3, 3.0)


def test_every_per_layer_metric_has_a_reader_that_names_its_layer_and_metric():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        mod = metric_reader(m["name"])
        assert mod.LAYER == m["layer"], m["name"]
        assert mod.MOVES == m["moves"] and m["moves"] in e2e, m["name"]
        assert callable(mod.read)
    assert (BENCH_DIR / "metrics").is_dir()
