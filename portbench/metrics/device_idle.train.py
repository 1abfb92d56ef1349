"""device_idle.train: the share of the window in which no kernel, copy or
fill ran on the device, in percent: one less the device's busy time a
step, read from the traced phase after the window (the profiler does not
slow the device's work, but its host-side recording would lengthen the
gaps), over the window's time a step."""


def read(rec):
    if rec.kind != "train" or rec.trace is None or rec.trace["busy_s"] <= 0:
        return None
    if not rec.traced_units or not rec.step_s:
        return None
    busy = rec.trace["busy_s"] / rec.traced_units
    return 100.0 * (1.0 - busy / (rec.window_s / len(rec.step_s)))
