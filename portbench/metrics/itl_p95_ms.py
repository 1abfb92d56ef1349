"""itl_p95_ms: the 95th percentile, over every gap between consecutive
tokens of every request of the window, of the gap in milliseconds
(numpy's linear interpolation; the requests of one batch share their
batch's gaps)."""

import numpy as np


def read(rec):
    if rec.kind != "serve" or not rec.token_times:
        return None
    per = rec.requests // len(rec.token_times)
    gaps = np.concatenate([np.diff(t) for t in rec.token_times])
    if gaps.size == 0:
        return None
    return float(np.percentile(np.repeat(gaps, per), 95)) * 1e3
