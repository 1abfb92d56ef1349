"""mfu.train: the model operations of the window's steps
(``portbench.costs.train_step_flops``, remat's recomputation not counted)
over the window's seconds at the bf16 peak, in percent."""

from portbench import costs


def read(rec):
    if rec.kind != "train" or not rec.step_s:
        return None
    tr = rec.cell.traffic
    src = tr["source_frames"] if rec.cell.model.get("encoder_layers") else 0
    flops = costs.train_step_flops(rec.cell.model, tr["batch"], src,
                                   tr["target_tokens"])
    return 100.0 * flops * len(rec.step_s) / (rec.window_s
                                              * costs.PEAK_FLOPS)
