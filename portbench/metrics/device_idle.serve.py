"""device_idle.serve: the share of the window in which no kernel, copy or
fill ran on the device, in percent: one less the device's busy time a
batch, read from the traced phase after the window (the profiler does not
slow the device's work, but its host-side recording would lengthen the
gaps), over the window's time a batch."""


def read(rec):
    if rec.kind != "serve" or rec.trace is None or rec.trace["busy_s"] <= 0:
        return None
    if not rec.traced_units or not rec.token_times:
        return None
    busy = rec.trace["busy_s"] / rec.traced_units
    return 100.0 * (1.0 - busy / (rec.window_s / len(rec.token_times)))
