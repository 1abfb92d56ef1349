"""decode_step_ms.serve: the window's decode time over its decode steps,
in milliseconds: for each batch, its first token on the host to its last
one, over the steps between them."""


def read(rec):
    if rec.kind != "serve":
        return None
    steps = sum(len(t) - 1 for t in rec.token_times)
    if steps <= 0:
        return None
    return sum(t[-1] - t[0] for t in rec.token_times) / steps * 1e3
