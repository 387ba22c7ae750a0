"""BENCHMARK.json against the rules of its format, and the benchmark's
independence: every cell's parts found by name as files, every kernel file
exporting what the harness reads, no table of families, kinds or kernels
in the harness's code, and no file under ``benchmark/`` importing JAX or
the JAX package."""

import ast
import json
import re

from benchmark.harness import BENCH_DIR, ROOT, kernel_table, limits_for

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_units_and_bounds():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    assert 1 <= b["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in b[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for x in b["configs"] + b["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def test_every_cell_finds_its_parts_and_reports_setup_a_rate_and_a_layer():
    b = bench()
    for w in b["workloads"]:
        assert w["chips"] == 1
        cfg = json.loads((BENCH_DIR / "configs" / f"{w['config']}.json").read_text())
        mix = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        assert cfg["name"] == w["config"]
        assert (BENCH_DIR / "kinds" / f"{mix['kind']}.py").is_file()
        assert (BENCH_DIR / "families" / f"{cfg['family']}.py").is_file()
        assert limits_for(w["name"]), w["name"]
        e2e = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2 and "setup_s" in [m["name"] for m in e2e]
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"])
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("benchmark/")


def test_every_kernel_file_exports_entries_trace_names_record_and_work():
    table = kernel_table(BENCH_DIR / "kernels")
    assert {"k1", "k2", "k3"} <= set(table)
    for name, mod in table.items():
        assert mod.ENTRIES and all(len(e) == 2 for e in mod.ENTRIES), name
        assert mod.TRACE_NAMES and all(isinstance(n, str) for n in mod.TRACE_NAMES), name
        assert callable(mod.record) and callable(mod.work), name


def test_no_table_of_families_kinds_or_kernels_in_the_harness_code():
    """A family, kind or kernel joins as a file: no code outside the tests
    branches on one by name."""
    banned = ('family"] ==', "family'] ==", 'kernel == "k', "KINDS")
    for f in BENCH_DIR.rglob("*.py"):
        if "tests" in f.relative_to(BENCH_DIR).parts:
            continue
        text = f.read_text()
        assert not [b for b in banned if b in text], f


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    for f in BENCH_DIR.rglob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax", "attwarp_tpu"), (f, m)


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH_DIR / "reference").rglob("*.py"):
        assert "attwarp_tpu_torch" not in f.read_text(), f
