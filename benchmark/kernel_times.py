"""Each hand-written kernel's device time in a saved trace, read two ways:
the union of its device kernels' intervals inside the traced slice, which
``trace.reduce_trace`` gives the ``k*_roofline`` readers, and the sum of
their durations, which it gave before. A kernel launched as a programmatic
dependent (K3's merge) starts inside the kernel it depends on, so the sum
counts their overlap twice.

    python3 benchmark/kernel_times.py benchmark/traces/<cell>

A ``--trace 1`` run leaves ``trace.json`` and ``kernel_least_s.json`` (each
kernel's summed least time over its recorded calls) in that directory; the
roofline share is printed both ways where the least time is there.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.trace import DEVICE_CATS, SLICE, clip, merge, read_trace  # noqa: E402


def kernel_times(events: List[dict], kernel_names: Dict[str, Sequence[str]]
                 ) -> Dict[str, Tuple[float, float]]:
    """Each kernel's (sum, union) of device seconds: the sum of the matching
    events' durations, and the union of their intervals clipped to the
    slice."""
    sl = next(e for e in events if e.get("name") == SLICE and e.get("ph") == "X"
              and e.get("cat") == "user_annotation")
    lo, hi = float(sl["ts"]), float(sl["ts"]) + float(sl["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    out = {}
    for k, subs in kernel_names.items():
        mine = [e for e in dev if any(s in e["name"] for s in subs)]
        if mine:
            total = sum(float(e["dur"]) for e in mine)
            union = merge(clip([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                                for e in mine], lo, hi))
            out[k] = (total / 1e6, sum(e - s for s, e in union) / 1e6)
    return out


def main(argv=None) -> int:
    from benchmark.harness import BENCH_DIR, kernel_table

    d = Path((argv or sys.argv[1:])[0])
    names = {k: tuple(m.TRACE_NAMES) for k, m in kernel_table(BENCH_DIR / "kernels").items()}
    times = kernel_times(read_trace(d / "trace.json"), names)
    least_path = d / "kernel_least_s.json"
    least = json.loads(least_path.read_text()) if least_path.exists() else {}
    for k, (total, union) in times.items():
        line = f"{k}: device s sum {total!r} union {union!r}"
        if k in least and union > 0:
            line += (f"; roofline % sum {100 * least[k] / total!r}"
                     f" union {100 * least[k] / union!r}")
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
