"""What every run of a cell shares: the process clock, the run record
the metric readers read, the device description, the correctness
verdict and the result line.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Optional

import torch

from . import cell as cells

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

TRACE_DIR = cells.ROOT / "build" / "portbench" / "trace"


def process_start() -> float:
    """This process's start on the ``time.time()`` clock, from
    ``/proc/self/stat`` (to a clock tick), or now where that cannot be
    read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers (``portbench/metrics``).
    Times in seconds on the host's clock unless named otherwise."""

    kind: str                        # serve | train
    cell: cells.Cell
    device: str
    setup_s: float = math.nan
    window_s: float = math.nan
    # serving: one entry a batch of the window
    batch_start: list = dataclasses.field(default_factory=list)
    token_times: list = dataclasses.field(default_factory=list)
    prefill_s: list = dataclasses.field(default_factory=list)
    requests: int = 0
    tokens: int = 0
    # training: one entry a step of the window, each ending synchronised
    step_s: list = dataclasses.field(default_factory=list)
    positions: int = 0
    # the traced phase (trace.summarize), and the units of work it held
    trace: Optional[dict] = None
    traced_units: int = 0
    extra: dict = dataclasses.field(default_factory=dict)


def device_of(device: str) -> torch.device:
    return torch.device("cuda", 0) if device == "cuda" else torch.device(device)


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts, as ``nvidia-smi`` reads it,
    or None where it cannot be read (the shares of a peak assume 700 W)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(dev: torch.device, chips: int, peak: int,
             rec: Optional[Record] = None) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": chips, "memory_peak_bytes": int(peak),
               "power_limit_w": power_limit_w()}
    else:
        out = {"platform": dev.type, "kind": "host", "count": chips,
               "memory_peak_bytes": int(peak)}
    if rec is not None and rec.trace is not None:
        out["busy_s"] = rec.trace["busy_s"]
        out["window_s"] = rec.trace["window_s"]
    return out


def free(dev: torch.device) -> None:
    """Return what the program's freed state held to the device."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def read_metrics(rec: Record, trace: bool) -> dict:
    """Each of the cell's metrics of this kind of run, by its reader; an
    end-to-end metric must read, a per-layer one is left out where its
    reader finds nothing."""
    out = {}
    for m in rec.cell.metrics(trace):
        value = cells.reader(m["name"]).read(rec)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit, and whether every one is a
    finite number within it."""
    checks = {}
    ok = True
    for name, lim in limits["checks"].items():
        value = readings.get(name, math.nan)
        checks[name] = {"value": value, "limit": lim["limit"]}
        ok &= math.isfinite(value) and value <= lim["limit"]
    return ok, checks


def result(rec: Record, trace: bool, correct: bool, checks: dict,
           attempted: int, failed: int, device: dict) -> dict:
    out: dict[str, Any] = {
        "correct": bool(correct), "attempted": int(attempted),
        "failed": int(failed), "metrics": read_metrics(rec, trace),
        "device": device,
    }
    if trace and rec.trace is not None:
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["checks"] = checks
    return out


def check_lines(checks: dict) -> list[str]:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]


def forbidden_modules() -> list[str]:
    """Modules of ``sys.modules`` whose top-level name, compared whole, is
    JAX's, Flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def trace_path(workload: str) -> Path:
    return TRACE_DIR / f"{workload}.json"
