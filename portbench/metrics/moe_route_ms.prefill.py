"""moe_route_ms.prefill: the device milliseconds a traced prefill spends
under the program's ``moe.route`` spans (the float32 router, its top-k and
each pair's rank within its expert from the one-hot cumulative sum): their
device time inside the ``model.prefill`` spans over the number of those
spans (:mod:`portbench.spans`)."""

from portbench import spans


def read(rec):
    if rec.kind != "serve":
        return None
    red = spans.of_run(rec)
    if red is None or not red.has_device:
        return None
    rows = spans.table(red, within="model.prefill")
    route, prefill = rows.get("moe.route"), rows.get("model.prefill")
    if route is None or prefill is None or route.device_s <= 0:
        return None
    return route.device_s / prefill.calls * 1e3
