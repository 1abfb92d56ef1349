"""mfu.serve: the window's roofline time over its length, in percent. A
batch's roofline time is its prefill's operations at the bf16 peak and
each decode step's weight and KV-cache bytes at the HBM rate
(``portbench.costs.serve_batch_seconds``)."""

from portbench import costs


def read(rec):
    if rec.kind != "serve" or not rec.token_times:
        return None
    tr = rec.cell.traffic
    per_batch = costs.serve_batch_seconds(rec.cell.model, tr["batch"],
                                          tr["prompt_tokens"],
                                          tr["new_tokens"])
    return 100.0 * per_batch * len(rec.token_times) / rec.window_s
