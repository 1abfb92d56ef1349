"""decode_host_ms.serve: the median, over the traced phase's decode steps,
of the host's time in the program's ``model.decode_step`` span, in
milliseconds (:mod:`portbench.spans`): the Python dispatch of a step and
the waits inside it, under the profiler (which lengthens the host's
side; the device's work is the same)."""

import statistics

from portbench import spans


def read(rec):
    if rec.kind != "serve":
        return None
    red = spans.of_run(rec)
    step = spans.table(red).get("model.decode_step") if red else None
    if step is None:
        return None
    return statistics.median(step.durations) * 1e3
