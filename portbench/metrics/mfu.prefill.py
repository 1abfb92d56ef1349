"""mfu.prefill: a prefill's operations (``portbench.costs.prefill_flops``)
over its median synchronised time at the bf16 peak, in percent."""

import statistics

from portbench import costs


def read(rec):
    if rec.kind != "serve" or not rec.prefill_s:
        return None
    tr = rec.cell.traffic
    flops = costs.prefill_flops(rec.cell.model, tr["batch"],
                                tr["prompt_tokens"])
    return 100.0 * flops / (statistics.median(rec.prefill_s)
                            * costs.PEAK_FLOPS)
