"""host_syncs.train: the host's waits for the device inside the program's
``train.step`` span, over the traced steps (:mod:`portbench.spans` says
what a wait is; those of remat's second forward, on autograd's thread,
count in their step)."""

from portbench import spans


def read(rec):
    if rec.kind != "train":
        return None
    red = spans.of_run(rec)
    if red is None or not red.has_device:
        return None
    step = spans.table(red).get("train.step")
    if step is None:
        return None
    return step.waits / step.calls
