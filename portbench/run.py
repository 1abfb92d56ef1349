"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``src/repro_torch`` beside ``portbench``),
on a machine with as many CUDA cards as the cell asks for. The run builds
or loads the program's kernels from ``build/repro_torch/`` in the
checkout, draws its weights and inputs on the card from ``--seed``, warms
the cell's own shapes, measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints one JSON object as
the last line of standard output (the compared numbers beside their
limits also as the last lines of standard error). ``--trace 1`` reports
the per-layer metrics instead of the end-to-end ones, from a profiled
phase after the window; its Chrome trace and key averages are written to
``build/portbench/trace/``.

It exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, outside a checkout that holds the program, and
when ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded
once the run is over.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _fixed_caches() -> None:
    """The kernel caches a library of the program could use, at fixed
    paths inside the checkout (the program's own nvcc builds go to
    ``build/repro_torch/`` by itself)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float) -> dict:
    """One run of ``cell``: the result object (see the module docstring)."""
    from . import harness

    driver = importlib.import_module(f"portbench.{cell.traffic['driver']}")
    rec, readings, peak, _ = driver.run(cell, seed, seconds, trace, device,
                                        t_start)
    correct, checks = harness.verdict(readings, cell.limits)
    dev = harness.device_of(device)
    if rec.kind == "serve":
        unit_s = [t[-1] - s for s, t in zip(rec.batch_start, rec.token_times)]
    else:
        unit_s = rec.step_s
    q = statistics.quantiles(unit_s, n=4) if len(unit_s) > 1 else unit_s * 3
    print(f"portbench: {cell.name} seed {seed}: set-up {rec.setup_s:.3f} s "
          f"(" + ", ".join(f"{k} {v:.2f}" for k, v in
                           rec.extra["setup_parts"].items()) + "), window "
          f"{rec.window_s:.3f} s, {len(unit_s)} "
          f"{'batches' if rec.kind == 'serve' else 'steps'} of "
          f"{min(unit_s):.4f}/{q[0]:.4f}/{q[1]:.4f}/{q[2]:.4f}/"
          f"{max(unit_s):.4f} s (min/quartiles/max), reference "
          f"{rec.extra.get('reference_s', 0.0):.1f} s, peak {peak} bytes"
          + (", trace " + ", ".join(f"{k} {v:.1f}" for k, v in
                                     rec.extra["trace_parts"].items())
             if "trace_parts" in rec.extra else ""), file=sys.stderr)
    return harness.result(
        rec, trace, correct and rec.extra["failed"] == 0, checks,
        rec.extra["attempted"], rec.extra["failed"],
        harness.describe(dev, cell.chips, peak, rec))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from . import harness

    t_start = harness.process_start()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: no src/repro_torch under {ROOT}: run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    _fixed_caches()
    from . import cell as cells

    try:
        cell = cells.find(args.workload)
    except KeyError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                     t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    print("\n".join(harness.check_lines(result["checks"])), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
