"""host_syncs.serve: the host's waits for the device a decode step: the
mean over the traced phase's ``model.decode_step`` spans of the waits
inside one, plus the same mean of the ``serve.token_to_host`` spans that
bring each step's token to the host (:mod:`portbench.spans` says what a
wait is)."""

from portbench import spans


def read(rec):
    if rec.kind != "serve":
        return None
    red = spans.of_run(rec)
    if red is None or not red.has_device:
        return None
    rows = spans.table(red)
    step, copy = rows.get("model.decode_step"), rows.get("serve.token_to_host")
    if step is None or copy is None:
        return None
    return step.waits / step.calls + copy.waits / copy.calls
