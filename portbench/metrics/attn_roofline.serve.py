"""attn_roofline.serve: the least time of the traced prefills' sequence
attention (``portbench.costs.prefill_attention_seconds``: each layer's
causal call, the larger of its operations at the bf16 peak and its bytes
at the HBM rate) over the device time of the kernels the trace finds
under the program's ``repro_torch::flash_attention*`` ops, in percent."""

from portbench import costs


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    spent = sum(s for op, s in rec.trace["op_device_s"].items()
                if op.startswith("repro_torch::flash_attention"))
    if spent <= 0:
        return None
    tr = rec.cell.traffic
    least = costs.prefill_attention_seconds(
        rec.cell.model, tr["batch"], tr["prompt_tokens"]) * rec.traced_units
    return 100.0 * least / spent
