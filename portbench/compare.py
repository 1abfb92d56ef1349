"""The numbers that decide ``correct``, from the program's outputs and the
reference's.

Serving: at every position of the sample, the reference's largest logit
less the reference's logit of the token the program served there (the
gap). ``logit_gap`` is the widest gap; ``logit_gap_q90`` the 90th
percentile of the gaps (``torch.quantile``'s linear interpolation). A
sound program's greedy tokens lie within its rounding of the best, but
where its bf16 rounding moves a token across a routing decision (a
near-tie of the ``top_k``-th and next expert, or a pair dropped at
capacity) the logits move by far more: at full width and depth such
events put gaps of 0.2-1.0 on 5-7 % of the positions of sound runs and
of the fp8 control alike, so the widest gap catches a token altered
outright, and the 90th percentile, which such events do not reach,
tells the rounding of bf16 from fp8's (``PERF.md``, the readings). The
control is read the same way for the tokens the fp8 reference puts
first.

Training, for the first steps that set-up drives and the reference
follows:

- ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` over the
  steps, each step's loss as the program reports it (its last
  microbatch's);
- ``grad_gap``: the worst leaf's ``| |g| - |g_ref| |`` over the larger of
  ``|g_ref|`` and the median leaf's ``|g_ref|``, ``g`` the first step's
  gradient as the optimizer got it (its first moment over ``1 - beta1``);
- ``update_gap``: the same of each leaf's change over the steps, leaves
  whose reference gradient is under a thousandth of the median leaf's
  left out (they move by round-off alone).
"""

from __future__ import annotations

import statistics

import torch

#: a leaf whose first reference gradient is under this share of the median
#: leaf's is left out of the change
MOVE_FLOOR = 1e-3


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``max_v L[..., v] - L[..., token]`` at every position."""
    return (ref_logits.amax(dim=-1)
            - ref_logits.gather(-1, tokens[..., None])[..., 0])


def serving(logits: dict, served: list) -> dict:
    """``logit_gap`` and ``logit_gap_q90`` of the served tokens, and the
    control's (``control_*``, the tokens the fp8 reference puts first)
    where it ran beside the float32 one."""
    f32 = logits["float32"]
    out = _gap_numbers(torch.cat([gaps(r, t).flatten()
                                  for r, t in zip(f32, served)]))
    if "fp8" in logits:
        control = _gap_numbers(torch.cat([
            gaps(r, c.argmax(dim=-1)).flatten()
            for r, c in zip(f32, logits["fp8"])]))
        out.update({f"control_{k}": v for k, v in control.items()})
    return out


def _gap_numbers(every: torch.Tensor) -> dict:
    return {"logit_gap": float(every.max()),
            "logit_gap_q90": float(torch.quantile(every, 0.9))}


def spread(every: torch.Tensor) -> dict:
    """How a set of gaps spreads: the widest, the mean, quantiles and the
    shares above 0 and above 0.05."""
    q = torch.quantile(every, torch.tensor([0.5, 0.9, 0.95, 0.99],
                                           device=every.device))
    return {"widest": float(every.max()), "mean": float(every.mean()),
            "q50_q90_q95_q99": [float(x) for x in q],
            "share_above_0": float((every > 0).float().mean()),
            "share_above_0.05": float((every > 0.05).float().mean())}


def gap_summary(logits: dict, served: list, top: int = 6) -> dict:
    """How the served tokens' gaps spread (for a calibration's record),
    the widest with their place ``(batch, request, token)`` and the
    reference's own margin there (its best logit less its second); and,
    where the control ran, how its tokens' gaps spread."""
    rows = []
    for j, (r, t) in enumerate(zip(logits["float32"], served)):
        g = gaps(r, t)
        top2 = r.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        for idx in g.flatten().topk(min(top, g.numel())).indices.tolist():
            b, i = divmod(idx, g.shape[1])
            rows.append((float(g[b, i]), j, b, i, float(margin[b, i])))
    out = spread(torch.cat([gaps(r, t).flatten()
                            for r, t in zip(logits["float32"], served)]))
    out["positions"] = sum(t.numel() for t in served)
    out["at"] = sorted(rows, reverse=True)[:top]
    if "fp8" in logits:
        out["control"] = spread(torch.cat([
            gaps(r, c.argmax(dim=-1)).flatten()
            for r, c in zip(logits["float32"], logits["fp8"])]))
    return out


def worst_leaf(got: dict, want: dict, leaves=None) -> tuple[float, str]:
    """The largest ``|got - want| / max(want, median want)`` over the
    leaves (norms by name), and its leaf."""
    leaves = sorted(want if leaves is None else leaves)
    med = statistics.median(want[n] for n in want)
    worst, at = 0.0, ""
    for n in leaves:
        gap = abs(got[n] - want[n]) / max(want[n], med, 1e-30)
        if gap > worst or not at:
            worst, at = gap, n
    return worst, at


def training(prog: dict, ref: dict) -> dict:
    """The three training numbers, and the leaves behind the two by leaf.
    ``prog`` and ``ref`` each hold ``losses``, ``grad_norms`` and
    ``update_norms`` (by leaf)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = worst_leaf(prog["grad_norms"], ref["grad_norms"])
    med = statistics.median(ref["grad_norms"].values())
    moved = [n for n, g in ref["grad_norms"].items() if g >= MOVE_FLOOR * med]
    update_gap, update_leaf = worst_leaf(prog["update_norms"],
                                         ref["update_norms"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap, "grad_leaf": grad_leaf,
            "update_leaf": update_leaf,
            "left_out": sorted(set(ref["grad_norms"]) - set(moved))}
