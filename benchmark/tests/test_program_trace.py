"""``program_trace.py`` and the readers of the program's spans on a small
synthetic Chrome trace with known answers, and on traces without spans."""

import json

import pytest

from benchmark import program_trace
from benchmark.harness import Reading, metric_reader
from benchmark.trace import SLICE

READERS = ("decode_step_ms.twopass", "decode_step_ms.serve", "decode_idle_pct.twopass",
           "decode_idle_pct.serve", "prefill_ms.twopass")


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic(spans=True):
    """A 1000 us slice. Host: pipeline.run [10, 900] holding prefill
    [20, 100] and two decode steps [100, 200] and [200, 300]. Device:
    the prefill's kernels [30, 80] and [85, 120]; the first step's kernel
    [130, 150] and copy [170, 180]; the second step's kernel [220, 250];
    the run's own kernel [860, 870]; a kernel launched outside any span
    [960, 990]."""
    launches = [(25, 1, "kernel", 30, 50), (90, 2, "kernel", 85, 35),
                (110, 3, "kernel", 130, 20), (150, 4, "gpu_memcpy", 170, 10),
                (210, 5, "kernel", 220, 30), (850, 6, "kernel", 860, 10),
                (950, 7, "kernel", 960, 30)]
    ev = [_ev(SLICE, "user_annotation", 0, 1000)]
    if spans:
        ev += [_ev("pipeline.run", "user_annotation", 10, 890),
               _ev("prefill", "user_annotation", 20, 80),
               _ev("decode_step", "user_annotation", 100, 100),
               _ev("decode_step", "user_annotation", 200, 100)]
    for ts, c, cat, start, dur in launches:
        ev.append(_ev("cudaLaunchKernel", "cuda_runtime", ts, 2, corr=c))
        ev.append(_ev(f"op{c}", cat, start, dur, tid=7, corr=c))
    ev.append(_ev("aten::mm", "cpu_op", 24, 3))
    return ev


@pytest.fixture
def traces(tmp_path, monkeypatch):
    monkeypatch.setattr(program_trace, "TRACES", tmp_path)

    def write(cell, events):
        d = tmp_path / cell
        d.mkdir()
        path = d / "trace.json"
        path.write_text(json.dumps({"traceEvents": events}))
        return Reading({}, [], 1.0, {}, trace={"trace_bytes": path.stat().st_size,
                                               "busy_s": 0.0, "window_s": 1e-3})
    return write


def test_spans_nest_and_take_the_device_operations_launched_inside_them():
    t = program_trace.ProgramTrace(synthetic())
    names = [s.name for s in t.spans]
    run = t.spans[names.index("pipeline.run")]
    assert run.parent is None
    assert all(t.spans[s.parent].name == "pipeline.run" for s in t.spans if s is not run)
    assert t.extents("prefill") == [(30, 120)]
    assert sorted(t.extents("decode_step")) == [(130, 180), (220, 250)]
    assert t.extents("pipeline.run") == [(30, 870)]   # its children's operations too
    assert t.median_ms("decode_step") == pytest.approx(0.040)
    assert t.mean_ms("prefill") == pytest.approx(0.090)
    # union 80 us, of it busy 20 + 10 + 30
    assert t.idle_pct("decode_step") == pytest.approx(25.0)
    assert t.median_ms("vision") is None and t.idle_pct("vision") is None


def test_idle_by_innermost_span_and_self_share():
    t = program_trace.ProgramTrace(synthetic())
    idle = {k: round(v * 1e6, 6) for k, v in t.idle_by_span().items()}
    assert idle == {program_trace.NO_SPAN: 80, "pipeline.run": 600, "prefill": 15,
                    "decode_step": 120}
    rows = {r["name"]: r for r in t.table()}
    assert rows["decode_step"]["count"] == 2
    assert rows["pipeline.run"]["self_pct"] == pytest.approx(100 * 610 / 890)
    assert rows["prefill"]["self_pct"] == pytest.approx(100.0)


def test_readers_read_the_runs_trace_by_its_size(traces):
    other = traces("other", synthetic(spans=False) + [_ev("x", "cpu_op", 0, 1)])
    r = traces("cell", synthetic())
    assert other.trace["trace_bytes"] != r.trace["trace_bytes"]
    got = {n: metric_reader(n).read(r) for n in READERS}
    assert got["decode_step_ms.twopass"] == got["decode_step_ms.serve"] == pytest.approx(0.040)
    assert got["decode_idle_pct.twopass"] == got["decode_idle_pct.serve"] == pytest.approx(25.0)
    assert got["prefill_ms.twopass"] == pytest.approx(0.090)


def test_readers_read_nothing_without_spans_or_trace(traces):
    r = traces("cell", synthetic(spans=False))
    assert all(metric_reader(n).read(r) is None for n in READERS)
    for trace in (None, {"trace_bytes": 12345, "busy_s": 0.0, "window_s": 1.0}):
        assert all(metric_reader(n).read(Reading({}, [], 1.0, {}, trace=trace)) is None
                   for n in READERS)


def test_cli_prints_the_breakdown(traces, capsys):
    traces("cell", synthetic())
    assert program_trace.main(["cell"]) == 0
    out = capsys.readouterr().out
    assert "decode_step" in out and "(no span)" in out
