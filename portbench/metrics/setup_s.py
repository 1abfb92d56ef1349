"""setup_s: process start to the window's first batch or step (loading,
drawing the weights, building or loading the kernels, the warm-up)."""


def read(rec):
    return rec.setup_s
