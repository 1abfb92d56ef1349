"""prefill_ms.serve: the median over the window's batches of the
engine's ``prefill_fn`` call, synchronised (in a traced run), in
milliseconds."""

import statistics


def read(rec):
    if rec.kind != "serve" or not rec.prefill_s:
        return None
    return statistics.median(rec.prefill_s) * 1e3
