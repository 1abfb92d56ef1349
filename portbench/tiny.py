"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can run in a
second or two: every width and count shrunk and the kinds of layer and
the traffic's shape kept, computed in float32 (a tiny model's bf16
rounding is not averaged over wide products, and would read above limits
set at the cell's own size)."""

from __future__ import annotations

import copy
import sys

from . import cell as cells

if str(cells.ROOT / "src") not in sys.path:
    sys.path.insert(0, str(cells.ROOT / "src"))

WIDTHS = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=512, param_dtype="float32",
              compute_dtype="float32")


def cell(name: str, model: dict = None, **traffic) -> cells.Cell:
    """Workload ``name`` at the CPU tests' size (``model`` and ``traffic``
    override the cut configuration's and traffic's keys)."""
    c = cells.find(name)
    c.config = copy.deepcopy(c.config)
    m = c.config["model"]
    m.update(WIDTHS)
    if m.get("num_experts"):
        m.update(num_experts=4, top_k=2)
    if m.get("encoder_layers"):
        m.update(encoder_layers=2)
    m.update(model or {})
    t = c.traffic = copy.deepcopy(c.traffic)
    if t["driver"] == "serve":
        t.update(batch=2, slots=2, prompt_tokens=16,
                 new_tokens=min(t["new_tokens"], 8), pool_batches=4)
    else:
        t.update(batch=4, source_frames=24, target_tokens=16)
    t.update(traffic)
    return c


def names() -> list[str]:
    return [w["name"] for w in cells.benchmark()["workloads"]]
