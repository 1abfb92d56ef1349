"""attn_roofline.train: the least time of the traced steps' attention
(``portbench.costs.train_attention_seconds``: each call's forward and
backward once) over the device time of the kernels the trace finds under
the program's ``repro_torch::flash_attention*`` ops (remat's second
forward included), in percent."""

from portbench import costs


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    spent = sum(s for op, s in rec.trace["op_device_s"].items()
                if op.startswith("repro_torch::flash_attention"))
    if spent <= 0:
        return None
    tr = rec.cell.traffic
    src = tr["source_frames"] if rec.cell.model.get("encoder_layers") else 0
    least = costs.train_attention_seconds(
        rec.cell.model, tr["batch"], src, tr["target_tokens"],
        tr["train_config"]["microbatches"]) * rec.traced_units
    return 100.0 * least / spent
