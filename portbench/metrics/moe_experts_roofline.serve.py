"""moe_experts_roofline.serve: the least time of the traced batches'
expert products over the device time under the program's ``moe.experts``
spans, in percent (:mod:`portbench.spans`).

A call's least time is the larger of its operations at the bf16 peak,
``2 · n · T · k · d · f`` (``n`` products a pair: 3 for a gated activation,
2 otherwise; ``T`` the call's tokens, the batch's prompt tokens in a
prefill and one a request in a decode step), and its bytes at the HBM
rate: the weights of the experts the call touches once, ``n · d · f`` an
expert in the parameters' dtype, and the routed pairs' input and output
rows in the compute dtype. The calls are counted from the trace: the
``moe.experts`` spans inside ``model.prefill`` and inside
``model.decode_step``.

The trace does not say which experts a call touched, nor which pairs
were dropped, so two assumptions stand in. The experts touched are those
expected under uniform routing, ``E · (1 − (1 − k/E)^T)``: a decode step's
8 tokens × 4 pairs over 16 experts touch 14.4 of them, a prefill all 16.
Uniform routing touches the most experts in expectation, so where the
router is skewed this counts more bytes than were needed. Dropped pairs
are not subtracted, so their operations and rows count as needed too.
Both make the least time longer than what the call had to do: the share
reads high, by the share of dropped pairs and of untouched experts that
uniform routing would have touched, and never low."""

import torch

from portbench import costs, spans


def _least_seconds(model: dict, tokens: int) -> float:
    d, f, e, k = (model["d_model"], model["d_ff"], model["num_experts"],
                  model["top_k"])
    n = 3 if model["act"] in ("swiglu", "geglu") else 2
    wbytes = getattr(torch, model["param_dtype"]).itemsize
    xbytes = getattr(torch, model["compute_dtype"]).itemsize
    touched = e * (1.0 - (1.0 - k / e) ** tokens)
    flops = 2.0 * n * tokens * k * d * f
    nbytes = n * touched * d * f * wbytes + 2 * tokens * k * d * xbytes
    return max(flops / costs.PEAK_FLOPS, nbytes / costs.HBM_BW)


def read(rec):
    if rec.kind != "serve" or not rec.cell.model.get("num_experts"):
        return None
    red = spans.of_run(rec)
    if red is None or not red.has_device:
        return None
    spent = spans.table(red).get("moe.experts")
    if spent is None or spent.device_s <= 0:
        return None
    tr, model = rec.cell.traffic, rec.cell.model
    lanes = min(tr["batch"], tr["slots"])
    least = 0.0
    for within, tokens in (("model.prefill", lanes * tr["prompt_tokens"]),
                           ("model.decode_step", lanes)):
        calls = spans.table(red, within=within).get("moe.experts")
        if calls is not None:
            least += calls.calls * _least_seconds(model, tokens)
    return 100.0 * least / spent.device_s
