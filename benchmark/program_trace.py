"""The program's own spans in the traced slice's Chrome trace.

The program marks its parts with spans (``attwarp_tpu_torch/utils/
profiling.py``); under the slice's profiler session each span is a
``user_annotation`` on the host thread that ran it. ``ProgramTrace`` pairs
every such annotation with the device operations launched inside it: a
``cuda_runtime``/``cuda_driver`` launch inside the span's host interval
carries a ``correlation`` id, and the kernel, copy or set it launched
carries the same id. A span's device extent runs from the start of the
first of those operations to the end of the last, its own and its child
spans' alike.

The readers under ``metrics/`` take the trace of a ``--trace 1`` run
through ``for_reading``: the ``traces/*/trace.json`` whose size is the
run's ``trace_bytes``, loaded once. A program without spans gives a trace
with none, and a reader then reads nothing (None).

    python3 benchmark/program_trace.py [<cell> | <path of a trace.json>]

prints the slice's device-idle seconds by the innermost span the host was
in, and each span name's count, host seconds, self share (host time not
in a child span) and median device extent.
"""

from __future__ import annotations

import bisect
import functools
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.trace import DEVICE_CATS, SLICE, merge, read_trace  # noqa: E402

TRACES = Path(__file__).resolve().parent / "traces"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no span)"

Interval = Tuple[float, float]


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """Intersection of two sorted, non-overlapping interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in intervals)


class Span:
    __slots__ = ("name", "tid", "start", "end", "parent", "dev_start", "dev_end", "child_host")

    def __init__(self, name: str, tid, start: float, end: float):
        self.name, self.tid, self.start, self.end = name, tid, start, end
        self.parent: Optional[int] = None
        self.dev_start = float("inf")
        self.dev_end = float("-inf")
        self.child_host: List[Interval] = []

    @property
    def has_device(self) -> bool:
        return self.dev_end > self.dev_start


class ProgramTrace:
    """Chrome-trace events (times in microseconds) -> the program's spans,
    each with its parent and its device extent, and the slice's device
    busy intervals."""

    def __init__(self, events: List[dict]):
        sl = [e for e in events if e.get("name") == SLICE and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
        if sl:
            self.lo = float(sl[0]["ts"])
            self.hi = self.lo + float(sl[0]["dur"])
            self.host_tid = sl[0].get("tid")
        else:   # a trace of the program alone: its whole extent
            xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
            self.lo = min((float(e["ts"]) for e in xs), default=0.0)
            self.hi = max((float(e["ts"]) + float(e.get("dur", 0)) for e in xs), default=0.0)
            self.host_tid = None
        self.busy = merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
        self.spans: List[Span] = []
        by_tid: Dict[object, List[int]] = {}
        for e in events:
            if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                    and e.get("name") != SLICE):
                s = float(e["ts"])
                self.spans.append(Span(e["name"], e.get("tid"), s, s + float(e["dur"])))
        order = sorted(range(len(self.spans)),
                       key=lambda i: (self.spans[i].start, -self.spans[i].end))
        for i in order:
            by_tid.setdefault(self.spans[i].tid, []).append(i)
        if self.host_tid is None and by_tid:
            self.host_tid = max(by_tid, key=lambda t: len(by_tid[t]))
        for idxs in by_tid.values():   # nesting: the enclosing span still open
            stack: List[int] = []
            for i in idxs:
                sp = self.spans[i]
                while stack and self.spans[stack[-1]].end < sp.end:
                    stack.pop()
                if stack:
                    sp.parent = stack[-1]
                    self.spans[stack[-1]].child_host.append((sp.start, sp.end))
                stack.append(i)
        self._by_tid = by_tid
        self._pair_launches(events, dev)

    def innermost(self, tid, t: float, starts: Optional[List[float]] = None) -> Optional[int]:
        """The innermost span of thread ``tid`` open at host time ``t``."""
        idxs = self._by_tid.get(tid, [])
        if starts is None:
            starts = [self.spans[i].start for i in idxs]
        k = bisect.bisect_right(starts, t) - 1
        if k < 0:
            return None
        # out from the latest span started before t to the first that holds t
        i = idxs[k]
        while i is not None and self.spans[i].end < t:
            i = self.spans[i].parent
        return i

    def _pair_launches(self, events: List[dict], dev: List[dict]) -> None:
        ops: Dict[int, Interval] = {}
        for e in dev:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                ops[c] = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        starts = {tid: [self.spans[i].start for i in idxs] for tid, idxs in self._by_tid.items()}
        for e in events:
            if e.get("cat") not in LAUNCH_CATS:
                continue
            c = (e.get("args") or {}).get("correlation")
            if c not in ops or e.get("tid") not in starts:
                continue
            i = self.innermost(e["tid"], float(e["ts"]), starts[e["tid"]])
            if i is not None:
                sp = self.spans[i]
                s, t = ops[c]
                sp.dev_start, sp.dev_end = min(sp.dev_start, s), max(sp.dev_end, t)
        # children's operations count in their parents' extents: the deepest first
        depth = [0] * len(self.spans)
        for i, sp in enumerate(self.spans):
            p = sp.parent
            while p is not None:
                depth[i] += 1
                p = self.spans[p].parent
        for i in sorted(range(len(self.spans)), key=lambda i: -depth[i]):
            sp, p = self.spans[i], self.spans[i].parent
            if p is not None and sp.has_device:
                q = self.spans[p]
                q.dev_start, q.dev_end = min(q.dev_start, sp.dev_start), max(q.dev_end, sp.dev_end)

    # ── what the readers read ───────────────────────────────────────
    def extents(self, name: str) -> List[Interval]:
        """The device extent of each span of ``name`` that launched work, us."""
        return [(s.dev_start, s.dev_end) for s in self.spans if s.name == name and s.has_device]

    def median_ms(self, name: str) -> Optional[float]:
        ext = self.extents(name)
        return statistics.median(e - s for s, e in ext) / 1e3 if ext else None

    def mean_ms(self, name: str) -> Optional[float]:
        ext = self.extents(name)
        return sum(e - s for s, e in ext) / len(ext) / 1e3 if ext else None

    def idle_pct(self, name: str) -> Optional[float]:
        """The share of the union of the device extents of ``name`` in which
        no kernel, copy or set ran, in %."""
        union = merge(self.extents(name))
        total = length(union)
        if total <= 0:
            return None
        return 100.0 * (1.0 - length(intersect(self.busy, union)) / total)

    # ── the breakdown for PERF.md ───────────────────────────────────
    def idle_by_span(self) -> Dict[str, float]:
        """The slice's device-idle seconds by the innermost span the host
        thread that ran the program was in (``NO_SPAN`` outside any)."""
        idle, edges = [], [self.lo] + [x for s, e in intersect(self.busy, [(self.lo, self.hi)])
                                       for x in (s, e)] + [self.hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                idle.append((a, b))
        # the host's innermost-span timeline: each span's self segments
        segs: List[Tuple[float, float, str]] = []
        for i in self._by_tid.get(self.host_tid, []):
            sp = self.spans[i]
            cur = sp.start
            for s, e in sorted(sp.child_host):
                if s > cur:
                    segs.append((cur, s, sp.name))
                cur = max(cur, e)
            if sp.end > cur:
                segs.append((cur, sp.end, sp.name))
        segs.sort()
        out: Dict[str, float] = {}
        covered = 0.0
        j = 0
        for a, b in idle:
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < b:
                s, e, name = segs[k]
                d = min(b, e) - max(a, s)
                if d > 0:
                    out[name] = out.get(name, 0.0) + d / 1e6
                    covered += d
                k += 1
        out[NO_SPAN] = (length(idle) - covered) / 1e6
        return out

    def table(self) -> List[dict]:
        """Per span name: count, host seconds, self share of the host time
        (%), median device extent (ms)."""
        rows: Dict[str, dict] = {}
        for sp in self.spans:
            r = rows.setdefault(sp.name, {"name": sp.name, "count": 0, "host_s": 0.0,
                                          "self_s": 0.0})
            r["count"] += 1
            r["host_s"] += (sp.end - sp.start) / 1e6
            r["self_s"] += (sp.end - sp.start - length(merge(sp.child_host))) / 1e6
        for r in rows.values():
            r["self_pct"] = 100.0 * r["self_s"] / r["host_s"] if r["host_s"] > 0 else 0.0
            r["device_ms"] = self.median_ms(r["name"])
        return sorted(rows.values(), key=lambda r: -r["host_s"])


@functools.lru_cache(maxsize=2)
def _load(path: str, size: int, mtime: float) -> ProgramTrace:
    return ProgramTrace(read_trace(Path(path)))


def load(path: Path) -> ProgramTrace:
    st = path.stat()
    return _load(str(path), st.st_size, st.st_mtime)


def for_reading(r) -> Optional[ProgramTrace]:
    """The program trace of a reading's traced slice, or None where it has
    none (an untraced or CPU run, or no trace file of its size)."""
    if not r.trace or "trace_bytes" not in r.trace:
        return None
    for path in sorted(TRACES.glob("*/trace.json")):
        if path.stat().st_size == r.trace["trace_bytes"]:
            return load(path)
    return None


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.strip().splitlines()[-5], file=sys.stderr)
        return 2
    path = Path(argv[0])
    if not path.is_file():   # a cell's name
        path = TRACES / argv[0] / "trace.json"
    t = load(path)
    idle = t.idle_by_span()
    total = sum(idle.values())
    print(f"{path}: slice {(t.hi - t.lo) / 1e6:.4f} s, device idle {total:.4f} s")
    print("device idle by innermost span (s, % of idle):")
    for name, s in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  {name:24s} {s:.4f}  {100 * s / total if total else 0:.1f}%")
    print("spans: name, count, host s, self %, median device extent ms")
    for r in t.table():
        dm = "-" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
        print(f"  {r['name']:24s} {r['count']:5d} {r['host_s']:.4f} {r['self_pct']:5.1f} {dm}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
