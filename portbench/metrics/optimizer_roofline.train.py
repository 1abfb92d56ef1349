"""optimizer_roofline.train: the least time of the traced steps' AdamW
updates over the device time under the program's ``train.optimizer``
spans, in percent (:mod:`portbench.spans`).

An update's least time is its bytes at the HBM rate: for each trainable
parameter (counted from :func:`portbench.reference.transformer.
parameter_shapes`) its value read and written in the parameters' dtype,
its gradient read (the float32 accumulator when the step runs
microbatches, else the parameters' dtype), and both moments read and
written in ``opt_state_dtype``; its few operations a parameter take less
time at any peak."""

import math

import torch

from portbench import costs, spans
from portbench.reference import transformer as ref


def read(rec):
    if rec.kind != "train":
        return None
    red = spans.of_run(rec)
    if red is None or not red.has_device:
        return None
    opt = spans.table(red).get("train.optimizer")
    if opt is None or opt.device_s <= 0:
        return None
    model, tcfg = rec.cell.model, rec.cell.traffic["train_config"]
    params = sum(math.prod(s) for s in ref.parameter_shapes(model).values())
    pbytes = getattr(torch, model["param_dtype"]).itemsize
    sbytes = getattr(torch, tcfg["opt_state_dtype"]).itemsize
    gbytes = 4 if tcfg["microbatches"] > 1 else pbytes
    per_param = 2 * pbytes + gbytes + 4 * sbytes
    least = opt.calls * params * per_param / costs.HBM_BW
    return 100.0 * least / opt.device_s
