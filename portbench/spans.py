"""A traced run's Chrome trace reduced by the program's own spans.

The program opens a ``repro_torch.<layer>`` span at each of its layer
boundaries while a profiler records (``src/repro_torch/spans.py``); the
profiler exports them as ``user_annotation`` events. :func:`reduce` gives,
for every span name (:class:`Row`):

- ``calls``; ``host_s``, the spans' durations, and ``self_s``, each less
  the part its child spans cover; ``durations``, one a call;
- ``device_s``: the kernels, copies and fills whose launch (found by
  correlation id) lies inside the span, and ``kernels``, the kernels among
  them;
- ``waits``: the host's waits for the device inside the span. A wait
  is a ``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` or
  ``cudaEventSynchronize``, or a copy whose device-side event names
  pageable memory, counted once for the innermost host op that makes it
  (a pageable copy and the synchronise that ends it are one wait);
- ``idle_s``: the gaps in the device's activity inside the benchmark's
  ``portbench.window`` (the same gaps :func:`portbench.trace.summarize`
  finds), each put down to the innermost span open on the window's
  thread when it began; the gaps outside every span are ``OUTSIDE``'s.

A launch or a wait belongs to the innermost span open on its thread at
that time; on a thread with none open (autograd's backward thread, where
remat's second forward opens spans of its own) to the innermost span open
on the window's thread. A span with no parent on its own thread takes
that one as its parent. Sums are inclusive: a span's row holds its
children's work, counted once where a name nests inside itself.
:func:`table` restricts the rows to the spans inside a span of a given
name.

    python3 -m portbench.spans build/portbench/trace/<cell>.json

prints the table of a traced run.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import json
import os
import sys
from pathlib import Path
from typing import Optional

from . import harness
from .trace import DEVICE_CATS, WINDOW, _union

PREFIX = "repro_torch."
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(outside every span)"


@dataclasses.dataclass
class Row:
    calls: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    kernels: int = 0
    waits: int = 0
    idle_s: float = 0.0
    durations: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Span:
    name: str
    tid: object
    start: float
    end: float
    parent: int = -1
    children: list = dataclasses.field(default_factory=list)
    device_us: float = 0.0
    kernels: int = 0
    waits: int = 0
    idle_us: float = 0.0


@dataclasses.dataclass
class Reduction:
    spans: list
    has_device: bool
    outside_idle_s: float


class _Innermost:
    """The innermost of nested intervals at a time, by thread: ``at(tid,
    ts)`` is the interval's index, or -1; ``parent[i]`` the index of the
    interval enclosing interval ``i`` on its thread, or -1."""

    def __init__(self, intervals: list):
        by_tid = collections.defaultdict(list)
        for i, (tid, a, b) in enumerate(intervals):
            by_tid[tid].append((a, -b, i))
        self.times: dict = {}
        self.ids: dict = {}
        self.parent = [-1] * len(intervals)
        for tid, items in by_tid.items():
            items.sort()
            times, ids, stack = [], [], []

            def close_until(t):
                while stack and intervals[stack[-1]][2] <= t:
                    end = intervals[stack.pop()][2]
                    # a partly overlapping pair must not step back in time
                    times.append(max(end, times[-1]))
                    ids.append(stack[-1] if stack else -1)

            for a, _, i in items:
                close_until(a)
                self.parent[i] = stack[-1] if stack else -1
                times.append(a)
                ids.append(i)
                stack.append(i)
            close_until(float("inf"))
            self.times[tid], self.ids[tid] = times, ids

    def at(self, tid, ts: float) -> int:
        times = self.times.get(tid)
        if not times:
            return -1
        j = bisect.bisect_right(times, ts) - 1
        return self.ids[tid][j] if j >= 0 else -1


def reduce(trace: dict) -> Reduction:
    """The spans of ``trace`` (a Chrome trace as the profiler exports it)
    with the work each holds itself; see the module docstring."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    window = next((e for e in events if e.get("name") == WINDOW), None)
    spans = [Span(e["name"][len(PREFIX):], e.get("tid"), float(e["ts"]),
                  float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIX)]
    if window is not None:
        main = window.get("tid")
    else:
        main = min(spans, key=lambda s: s.start).tid if spans else None
    inner = _Innermost([(s.tid, s.start, s.end) for s in spans])

    def holder(tid, ts: float) -> int:
        i = inner.at(tid, ts)
        return inner.at(main, ts) if i < 0 and tid != main else i

    # parents: the enclosing span on the thread, else the main thread's
    for i, s in enumerate(spans):
        s.parent = inner.parent[i]
        if s.parent < 0 and s.tid != main:
            s.parent = inner.at(main, s.start)
        if s.parent >= 0:
            spans[s.parent].children.append(i)

    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), float(e["ts"]))
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    waits = [(e.get("tid"), float(e["ts"])) for e in events
             if e.get("cat") in LAUNCH_CATS and e["name"] in SYNCS]
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        if e.get("cat") == "gpu_memcpy" and "Pageable" in e["name"]:
            waits.append(launch)
        i = holder(*launch)
        if i >= 0:
            spans[i].device_us += float(e["dur"])
            spans[i].kernels += e.get("cat") == "kernel"

    ops = [(e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "cpu_op"]
    op_at = _Innermost(ops)
    counted = set()
    for tid, ts in sorted(waits, key=lambda w: w[1]):
        op = op_at.at(tid, ts)
        key = (tid, op) if op >= 0 else (tid, ts)
        if key in counted:
            continue
        counted.add(key)
        i = holder(tid, ts)
        if i >= 0:
            spans[i].waits += 1

    outside = 0.0
    if window is not None:
        w0 = float(window["ts"])
        w1 = w0 + float(window["dur"])
        busy = _union([(max(float(e["ts"]), w0),
                        min(float(e["ts"]) + float(e["dur"]), w1))
                       for e in device if float(e["ts"]) < w1
                       and float(e["ts"]) + float(e["dur"]) > w0])
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                i = inner.at(main, a)
                if i >= 0:
                    spans[i].idle_us += b - a
                else:
                    outside += b - a
    return Reduction(spans, bool(device), outside * 1e-6)


def table(red: Reduction, within: Optional[str] = None) -> dict:
    """:class:`Row` by span name, of the spans inside (or named) ``within``
    where it is given."""
    spans = red.spans
    up = [_ancestors(spans, i) for i in range(len(spans))]
    order = sorted(range(len(spans)), key=lambda i: len(up[i]), reverse=True)
    incl = {}
    for i in order:                # children before their parents
        s = spans[i]
        acc = [s.device_us, s.kernels, s.waits, s.idle_us]
        for c in s.children:
            acc = [x + y for x, y in zip(acc, incl[c])]
        incl[i] = acc
    rows: dict = collections.defaultdict(Row)
    for i, s in enumerate(spans):
        names = {spans[j].name for j in up[i]}
        if within is not None and within != s.name and within not in names:
            continue
        row = rows[s.name]
        cover = _union([(max(spans[c].start, s.start),
                         min(spans[c].end, s.end)) for c in s.children
                        if spans[c].end > s.start and spans[c].start < s.end])
        dur = (s.end - s.start) * 1e-6
        row.calls += 1
        row.durations.append(dur)
        row.self_s += dur - sum(b - a for a, b in cover) * 1e-6
        if s.name in names:        # already inside one of its own name
            continue
        row.host_s += dur
        device_us, kernels, waits, idle_us = incl[i]
        row.device_s += device_us * 1e-6
        row.kernels += kernels
        row.waits += waits
        row.idle_s += idle_us * 1e-6
    return dict(rows)


def _ancestors(spans: list, i: int) -> list:
    """The indices of the spans enclosing span ``i``, innermost first."""
    out = []
    p = spans[i].parent
    while p >= 0:
        out.append(p)
        p = spans[p].parent
    return out


@functools.lru_cache(maxsize=1)
def _load(path: str, mtime_ns: int, size: int) -> Reduction:
    with open(path) as f:
        return reduce(json.load(f))


def load(path) -> Optional[Reduction]:
    """:func:`reduce` of the trace at ``path``, or None where there is no
    such file; the last file's reduction is kept while the file is
    unchanged (the metric readers of one run share it)."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return _load(str(path), st.st_mtime_ns, st.st_size)


def of_run(rec) -> Optional[Reduction]:
    """The reduction of a traced run's trace, or None for an untraced
    run."""
    if rec.trace is None:
        return None
    return load(harness.trace_path(rec.cell.name))


def format_table(red: Reduction) -> str:
    rows = table(red)
    out = [f"{'span':<24} {'calls':>7} {'host ms':>11} {'self ms':>11} "
           f"{'device ms':>11} {'kernels':>8} {'waits':>6} {'idle ms':>10}"]
    for name in sorted(rows, key=lambda n: rows[n].host_s, reverse=True):
        r = rows[name]
        out.append(f"{name:<24} {r.calls:>7} {r.host_s * 1e3:>11.3f} "
                   f"{r.self_s * 1e3:>11.3f} {r.device_s * 1e3:>11.3f} "
                   f"{r.kernels:>8} {r.waits:>6} {r.idle_s * 1e3:>10.3f}")
    out.append(f"{OUTSIDE:<24} {'':>7} {'':>11} {'':>11} {'':>11} {'':>8} "
               f"{'':>6} {red.outside_idle_s * 1e3:>10.3f}")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python3 -m portbench.spans <trace.json>",
              file=sys.stderr)
        return 2
    red = load(Path(args[0]))
    if red is None:
        print(f"portbench.spans: no trace at {args[0]}", file=sys.stderr)
        return 2
    sys.stdout.write(format_table(red))
    return 0


if __name__ == "__main__":
    sys.exit(main())
