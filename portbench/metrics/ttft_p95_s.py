"""ttft_p95_s: the 95th percentile, over every request of the window, of
the time from its batch's call into the engine to its first token on the
host (numpy's linear interpolation; the requests of one batch share
their batch's time)."""

import numpy as np


def read(rec):
    if rec.kind != "serve" or not rec.token_times:
        return None
    per = rec.requests // len(rec.token_times)
    ttft = [t[0] - s for s, t in zip(rec.batch_start, rec.token_times)]
    return float(np.percentile(np.repeat(ttft, per), 95))
