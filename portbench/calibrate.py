"""Read a cell's compared numbers over many seeds in one process: the
readings that its limits are set from.

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--fault <name> --fault-seeds 21,22,23] \
        [--model num_layers=4 --model param_dtype='"float32"' ...]
        [--out build/portbench/calibration/<name>.jsonl]

For each seed it runs the cell as a run does, with a short window (a
serving cell's ``check_batches`` batches at the cell's own load, no
window for a training cell, whose numbers come from set-up's first
steps), and appends one JSON line: the seed, the program's readings and,
for a control seed, the control's (the reference in fp8, read beside the
float32 one). A fault seed runs the program with the fault planted
(:mod:`portbench.faults`). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--model", action="append", default=[],
                   help="key=value (JSON) over the configuration's model, "
                        "for a witness run at another size or dtype")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import importlib

    from . import cell as cells
    from . import faults

    cell = cells.find(args.workload)
    overrides = {}
    for item in args.model:
        key, value = item.split("=", 1)
        overrides[key] = json.loads(value)
    cell.config["model"].update(overrides)
    driver = importlib.import_module(f"portbench.{cell.traffic['driver']}")
    short = ({"window_batches": cell.traffic["check_batches"]}
             if cell.traffic["driver"] == "serve" else {"window_steps": 0})
    out = Path(args.out or ROOT / "build" / "portbench" / "calibration"
               / f"{cell.name}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    control = set(_seeds(args.control_seeds))
    runs = [(s, None) for s in _seeds(args.seeds)]
    runs += [(s, None) for s in sorted(control - set(_seeds(args.seeds)))]
    runs += [(s, args.fault) for s in _seeds(args.fault_seeds)]
    for seed, fault in runs:
        precisions = ("float32", "fp8") if seed in control and not fault \
            else ("float32",)
        plant = faults.ALL[fault]() if fault else contextlib.nullcontext()
        t0 = time.time()
        with plant:
            rec, readings, peak, _ = driver.run(
                cell, seed, 0.0, False, args.device, t0, precisions, **short)
        line = {"workload": cell.name, "seed": seed, "fault": fault,
                "model": overrides,
                "precisions": list(precisions), "readings": readings,
                "setup_s": rec.setup_s, "seconds": time.time() - t0,
                "peak_bytes": peak,
                "extra": {k: v for k, v in rec.extra.items()
                          if k in ("sample_batches", "losses", "leaves", "gaps",
                                   "reference_s")}}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
