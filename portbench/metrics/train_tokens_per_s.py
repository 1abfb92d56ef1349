"""train_tokens_per_s: positions trained in the window (source frames and
target tokens) over the window's seconds, each step ending in a
synchronise."""


def read(rec):
    if rec.kind != "train" or not rec.step_s:
        return None
    return rec.positions * len(rec.step_s) / rec.window_s
