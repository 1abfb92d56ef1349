"""The traced phase of a ``--trace 1`` run and its reduction.

:class:`TracedPhase` runs ``torch.profiler`` (host ops and the device's
kernels, copies and fills) over a fixed amount of the cell's work, under
a ``portbench.window`` annotation, and writes the Chrome trace and its
key averages (:func:`key_averages`) to ``build/portbench/trace/`` in the
checkout (one fixed file name a cell, overwritten by its next traced
run).

:func:`summarize` reduces the Chrome trace, by the trace's own clock:

- ``window_s``: the annotation's length; ``busy_s``: the union of the
  device's activity inside it;
- ``op_device_s``: device seconds of the kernels launched from inside
  each of the program's own ops (``repro_torch::<name>``: a kernel
  belongs to the op whose interval, on the launching thread, holds its
  launch);
- ``device_ops``: the ten kernels of most device time;
- ``idle_gaps``: the idle time inside the window, by what the host was
  doing when each gap began (the innermost host event then running on
  the main thread, under the benchmark's own innermost annotation), the
  ten largest.
"""

from __future__ import annotations

import bisect
import collections
import json
import time
from pathlib import Path
from typing import Optional

import torch

WINDOW = "portbench.window"
#: the benchmark's annotations around its calls into the program
PREFIX = "portbench."
#: the program's own ops (its kernels), to which device time is attributed
PROGRAM_OPS = "repro_torch::"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "cuda_driver")
NAME_CHARS = 160


class TracedPhase:
    """``with TracedPhase(path) as phase: ...`` profiles the block;
    ``phase.summary`` holds :func:`summarize`'s dict after it."""

    def __init__(self, trace_path: Path, device: torch.device):
        self.path = Path(trace_path)
        self.device = device
        self.summary: Optional[dict] = None
        self.parts: dict = {}

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.annotation = torch.profiler.record_function(WINDOW)
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.annotation.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        t0 = time.perf_counter()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        t1 = time.perf_counter()
        trace = json.loads(self.path.read_text())
        t2 = time.perf_counter()
        self.path.with_suffix(".key_averages.txt").write_text(
            key_averages(trace))
        self.summary = summarize(trace)
        t3 = time.perf_counter()
        self.parts = {"export": t1 - t0, "load": t2 - t1,
                      "reduce": t3 - t2,
                      "events": len(trace.get("traceEvents", []))}
        return False


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def key_averages(trace: dict, rows: int = 60) -> str:
    """The trace's events by category and name: calls, total and mean
    duration, the longest first (the profiler's own ``key_averages()``
    rebuilds every event in Python, minutes for a decode-heavy batch)."""
    total: dict = collections.defaultdict(float)
    calls: collections.Counter = collections.Counter()
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e:
            key = (e.get("cat", ""), e["name"])
            total[key] += float(e["dur"])
            calls[key] += 1
    out = [f"{'category':<16} {'calls':>8} {'total ms':>12} {'mean us':>12}"
           f"  name"]
    for key in sorted(total, key=total.get, reverse=True)[:rows]:
        cat, name = key
        out.append(f"{cat[:16]:<16} {calls[key]:>8} {total[key] / 1e3:>12.3f}"
                   f" {total[key] / calls[key]:>12.3f}  {_short(name)}")
    return "\n".join(out) + "\n"


def summarize(trace: dict) -> dict:
    """The reduction described in the module docstring, in seconds."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("name") == WINDOW]
    if not window:
        raise ValueError(f"trace: no {WINDOW!r} annotation")
    w = window[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    main_tid = w.get("tid")

    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    spans = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
             for e in device]
    busy = _union(spans)
    busy_us = sum(b - a for a, b in busy)

    # each kernel's launch, by correlation id, and the host op holding it
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), float(e["ts"]))
    ops_by_tid: dict = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"].startswith(PROGRAM_OPS):
            ops_by_tid[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    for ops in ops_by_tid.values():
        ops.sort()
    starts = {tid: [o[0] for o in ops] for tid, ops in ops_by_tid.items()}

    def holders(tid, ts: float) -> set:
        ops = ops_by_tid.get(tid, [])
        i = bisect.bisect_right(starts.get(tid, []), ts)
        names = set()
        for j in range(i - 1, max(i - 400, 0) - 1, -1):
            a, b, name = ops[j]
            if a <= ts <= b:
                names.add(name)
        return names

    op_device = collections.Counter()
    kernels = collections.Counter()
    for e in device:
        dur = float(e["dur"])
        kernels[e["name"]] += dur
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            for name in holders(*launch):
                op_device[name] += dur

    # idle gaps inside the window, by the host's innermost event then
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"])
                  for e in events if e.get("tid") == main_tid
                  and e.get("cat") in HOST_CATS
                  and e.get("cat") != "user_annotation")
    host_starts = [h[0] for h in host]
    marks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"])
                   for e in events if e.get("tid") == main_tid
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith(PREFIX) and e is not w)
    mark_starts = [m[0] for m in marks]

    def innermost(items, item_starts, ts, reach):
        i = bisect.bisect_right(item_starts, ts)
        for j in range(i - 1, max(i - reach, 0) - 1, -1):
            a, b, name = items[j]
            if a <= ts <= b:
                return name
        return None

    def doing(ts: float) -> str:
        mine = innermost(marks, mark_starts, ts, len(marks))
        inner = innermost(host, host_starts, ts, 64)
        return f"{mine or 'outside'}: {inner or 'python'}"

    gaps = collections.Counter()
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_short(doing(a))] += b - a

    us = 1e-6
    return {
        "window_s": (w1 - w0) * us,
        "busy_s": busy_us * us,
        "op_device_s": {k: v * us for k, v in op_device.items()},
        "device_ops": [[_short(k), v * us]
                       for k, v in kernels.most_common(10)],
        "idle_gaps": [[k, v * us] for k, v in gaps.most_common(10)],
    }
