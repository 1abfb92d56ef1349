"""``portbench.spans`` on hand-written Chrome traces (device time by
correlation id, a second thread's launches, waits, idle gaps), the six
readers of the program's spans, and the tiny cells' traced runs on the
CPU."""

import json
import math
import time

import pytest
import torch

from portbench import cell as cells
from portbench import costs, harness, run, spans, tiny, trace
from portbench.reference import transformer as ref

MAIN, BACKWARD, STREAM = 1, 2, 7
NEW_READERS = ("moe_route_ms.prefill", "moe_experts_roofline.serve",
               "decode_host_ms.serve", "host_syncs.serve", "host_syncs.train",
               "optimizer_roofline.train")


class Trace:
    """A Chrome trace written event by event, as the profiler exports it."""

    def __init__(self):
        self.events = []
        self.corr = 0

    def x(self, name, cat, tid, ts, dur, **args):
        self.events.append({"ph": "X", "name": name, "cat": cat, "tid": tid,
                            "ts": ts, "dur": dur, "args": args})

    def span(self, name, ts, end, tid=MAIN):
        self.x(spans.PREFIX + name, "user_annotation", tid, ts, end - ts)
        # the device-side copy the profiler adds, which is not a span
        self.x(spans.PREFIX + name, "gpu_user_annotation", STREAM, ts,
               end - ts)

    def launch(self, tid, ts, cat, name, start, dur,
               call="cudaLaunchKernel"):
        self.corr += 1
        self.x(call, "cuda_runtime", tid, ts, 0.5, correlation=self.corr)
        self.x(name, cat, STREAM, start, dur, correlation=self.corr)

    def wait(self, tid, ts, call="cudaStreamSynchronize"):
        self.corr += 1
        self.x(call, "cuda_runtime", tid, ts, 1.0, correlation=self.corr)

    def pageable_copy(self, tid, ts):
        """A blocking copy as ``Tensor.to`` makes it: the op, the copy from
        pageable memory and the synchronise that ends it."""
        self.x("aten::copy_", "cpu_op", tid, ts, 4.0)
        self.launch(tid, ts + 1, "gpu_memcpy",
                    "Memcpy HtoD (Pageable -> Device)", ts + 1.5, 0.5,
                    call="cudaMemcpyAsync")
        self.wait(tid, ts + 2)

    def dump(self, path):
        path.write_text(json.dumps({"traceEvents": self.events}))
        return path


def training_trace() -> Trace:
    t = Trace()
    t.x(trace.WINDOW, "user_annotation", MAIN, 0, 200)
    t.span("train.step", 10, 190)
    t.span("train.forward", 20, 60)
    t.span("moe", 25, 55)
    t.span("moe.route", 30, 40)
    t.span("train.backward", 70, 170)
    # remat's second forward, on autograd's thread
    t.span("block.attention", 80, 100, tid=BACKWARD)
    t.launch(MAIN, 4, "kernel", "k_outside", 5.5, 1)
    t.launch(MAIN, 32, "kernel", "k_route", 33, 5)
    t.pageable_copy(MAIN, 34)
    t.launch(MAIN, 50, "kernel", "k_moe", 51, 3)
    t.x("aten::copy_", "cpu_op", MAIN, 52, 1)
    t.launch(MAIN, 52.2, "gpu_memcpy", "Memcpy DtoD (Device -> Device)",
             52.5, 1, call="cudaMemcpyAsync")
    t.launch(BACKWARD, 85, "kernel", "k_attention", 86, 10)
    t.pageable_copy(BACKWARD, 90)
    # launched on the backward thread with no span open there
    t.launch(BACKWARD, 120, "kernel", "k_backward", 121, 20)
    t.wait(MAIN, 180, call="cudaDeviceSynchronize")
    return t


def test_device_time_by_correlation_and_the_second_thread():
    red = spans.reduce({"traceEvents": training_trace().events})
    rows = spans.table(red)
    us = 1e-6
    # moe.route: its kernel and the pageable copy; moe adds k_moe and DtoD
    assert rows["moe.route"].device_s == pytest.approx(5.5 * us)
    assert rows["moe"].device_s == pytest.approx(9.5 * us)
    assert rows["block.attention"].device_s == pytest.approx(10.5 * us)
    assert rows["train.backward"].device_s == pytest.approx(30.5 * us)
    assert rows["train.step"].device_s == pytest.approx(40 * us)
    assert rows["train.step"].kernels == 4 and rows["moe"].kernels == 2
    assert {n: r.calls for n, r in rows.items()} == {
        n: 1 for n in ("train.step", "train.forward", "moe", "moe.route",
                       "train.backward", "block.attention")}
    # host time, and self time less the children (the other thread's too)
    assert rows["train.step"].host_s == pytest.approx(180 * us)
    assert rows["train.step"].self_s == pytest.approx(40 * us)
    assert rows["train.backward"].self_s == pytest.approx(80 * us)
    inside = spans.table(red, within="train.forward")
    assert set(inside) == {"train.forward", "moe", "moe.route"}


def test_waits_count_once_an_op_and_pageable_copies_block():
    red = spans.reduce({"traceEvents": training_trace().events})
    rows = spans.table(red)
    # the copy and its synchronise are one wait; the DtoD copy is none
    assert rows["moe.route"].waits == 1
    assert rows["moe"].waits == 1
    assert rows["block.attention"].waits == 1
    assert rows["train.backward"].waits == 1
    # the bare cudaDeviceSynchronize, outside any op, is the third
    assert rows["train.step"].waits == 3


def test_idle_gaps_go_to_the_span_open_on_the_main_thread():
    events = training_trace().events
    red = spans.reduce({"traceEvents": events})
    rows = spans.table(red)
    us = 1e-6
    # [0, 5.5] and [6.5, 33] fall outside every span
    assert red.outside_idle_s == pytest.approx(32 * us)
    assert rows["moe.route"].idle_s == pytest.approx(13 * us)   # [38, 51]
    assert rows["moe"].idle_s == pytest.approx(45 * us)         # + [54, 86]
    assert rows["train.backward"].idle_s == pytest.approx(84 * us)
    assert rows["train.step"].idle_s == pytest.approx(129 * us)
    # the same gaps as the benchmark's own reduction finds
    total = sum(s for _, s in trace.summarize({"traceEvents": events})
                ["idle_gaps"])
    assert red.outside_idle_s + rows["train.step"].idle_s == \
        pytest.approx(total)


def test_the_command_prints_the_table_and_a_trace_is_read_once(tmp_path,
                                                                capsys):
    path = training_trace().dump(tmp_path / "cell.json")
    assert spans.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert out.split("\n")[0].split()[:3] == ["span", "calls", "host"]
    assert "train.step" in out and spans.OUTSIDE in out
    assert spans.load(path) is spans.load(path)
    assert spans.load(tmp_path / "none.json") is None
    assert spans.main([str(tmp_path / "none.json")]) == 2


def _record(tmp_path, monkeypatch, name, events, **traffic):
    c = tiny.cell(name, **traffic)
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path)
    (tmp_path / f"{c.name}.json").write_text(
        json.dumps({"traceEvents": events}))
    rec = harness.Record(kind=c.traffic["driver"], cell=c, device="cuda")
    rec.trace, rec.traced_units = {}, 1
    return rec


def _read(name, rec):
    return cells.reader(name).read(rec)


def serving_trace() -> Trace:
    t = Trace()
    t.x(trace.WINDOW, "user_annotation", MAIN, 0, 1000)
    t.span("serve.generate", 0, 1000)
    t.span("model.prefill", 10, 110)
    t.span("moe", 20, 100)
    t.span("moe.route", 20, 30)
    t.launch(MAIN, 25, "kernel", "k_route", 26, 7)
    t.span("moe.experts", 40, 90)
    t.launch(MAIN, 45, "kernel", "k_experts", 46, 50)
    for a, b in ((200, 300), (400, 520)):
        t.span("model.decode_step", a, b)
        t.span("moe", a + 10, a + 60)
        t.span("moe.experts", a + 10, a + 50)
        t.launch(MAIN, a + 15, "kernel", "k_experts", a + 16, 20)
        t.pageable_copy(MAIN, a + 70)
        t.pageable_copy(MAIN, a + 80)
    for a in (120, 330, 540):
        t.span("serve.token_to_host", a, a + 10)
        t.pageable_copy(MAIN, a + 2)
    return t


def test_the_serving_readers_on_a_traced_batch(tmp_path, monkeypatch):
    rec = _record(tmp_path, monkeypatch, "dbrx_132b.serve.p2048",
                  serving_trace().events)
    assert _read("moe_route_ms.prefill", rec) == pytest.approx(7e-3)
    assert _read("decode_host_ms.serve", rec) == pytest.approx(0.110)
    assert _read("host_syncs.serve", rec) == 3   # 2 a step, 1 a token
    m, tr = rec.cell.model, rec.cell.traffic
    d, f, e, k = m["d_model"], m["d_ff"], m["num_experts"], m["top_k"]

    def least(tokens):
        # swiglu, float32 at the tests' size; the experts uniform routing
        # is expected to touch
        touched = e * (1 - (1 - k / e) ** tokens)
        weights = 3 * touched * d * f * 4
        return max(2 * 3 * tokens * k * d * f / costs.PEAK_FLOPS,
                   (weights + 2 * tokens * k * d * 4) / costs.HBM_BW)

    lanes = tr["batch"]
    want = least(lanes * tr["prompt_tokens"]) + 2 * least(lanes)
    assert _read("moe_experts_roofline.serve", rec) == \
        pytest.approx(100 * want / 90e-6)
    for name in ("host_syncs.train", "optimizer_roofline.train"):
        assert _read(name, rec) is None


def test_the_expert_roofline_counts_the_experts_a_call_touches():
    least = cells.reader("moe_experts_roofline.serve")._least_seconds
    model = {"d_model": 6144, "d_ff": 10752, "num_experts": 16, "top_k": 4,
             "act": "swiglu", "param_dtype": "bfloat16",
             "compute_dtype": "bfloat16"}
    expert = 3 * 6144 * 10752 * 2
    rows = 2 * 4 * 6144 * 2
    # a decode step of 8 tokens: 32 pairs over 16 experts touch 14.4
    touched = 16 * (1 - 0.75 ** 8)
    assert touched == pytest.approx(14.398, abs=1e-3)
    assert least(model, 8) == pytest.approx(
        (touched * expert + 8 * rows) / costs.HBM_BW)
    # one token touches its 4 experts; a prefill touches all 16 and is
    # bound by its operations
    assert least(model, 1) == pytest.approx((4 * expert + rows) / costs.HBM_BW)
    assert least(model, 16384) == pytest.approx(
        2 * 3 * 16384 * 4 * 6144 * 10752 / costs.PEAK_FLOPS)


def test_the_training_readers_on_traced_steps(tmp_path, monkeypatch):
    t = Trace()
    t.x(trace.WINDOW, "user_annotation", MAIN, 0, 1000)
    for a in (0, 500):
        t.span("train.step", a, a + 490)
        t.span("train.optimizer", a + 400, a + 480)
        t.launch(MAIN, a + 405, "kernel", "k_adamw", a + 406, 30)
        for w in (a + 100, a + 200, a + 300):
            t.pageable_copy(MAIN, w)
    rec = _record(tmp_path, monkeypatch, "seamless_m4t_medium.train.s2048",
                  t.events)
    assert _read("host_syncs.train", rec) == 3
    params = sum(math.prod(s) for s in
                 ref.parameter_shapes(rec.cell.model).values())
    # float32 value read and written, float32 accumulated gradient,
    # bfloat16 moments read and written
    least = 2 * params * (2 * 4 + 4 + 4 * 2) / costs.HBM_BW
    assert _read("optimizer_roofline.train", rec) == \
        pytest.approx(100 * least / 60e-6)
    for name in ("moe_route_ms.prefill", "decode_host_ms.serve",
                 "host_syncs.serve", "moe_experts_roofline.serve"):
        assert _read(name, rec) is None


@pytest.mark.parametrize("name", tiny.names())
def test_a_trace_without_program_spans_reads_nothing(tmp_path, monkeypatch,
                                                     name):
    """A program that opens no span (the parent of this benchmark's span
    readers) leaves each new metric out, without an error."""
    t = training_trace()
    t.events = [e for e in t.events if not e["name"].startswith(spans.PREFIX)]
    rec = _record(tmp_path, monkeypatch, name, t.events)
    for metric in NEW_READERS:
        assert _read(metric, rec) is None, metric
    rec.trace = None
    for metric in NEW_READERS:
        assert _read(metric, rec) is None, metric


@pytest.mark.parametrize("name", [n for n in tiny.names() if ".serve." in n])
def test_a_tiny_traced_serving_run_reports_the_decode_step_host_time(
        name, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = run.execute(tiny.cell(name), 2**31 + 777, 0.5, True, "cpu",
                          time.time())
    finally:
        torch.set_num_threads(before)
    assert res["correct"] is True
    got = res["metrics"]
    assert got["decode_host_ms.serve"]["unit"] == "ms"
    assert got["decode_host_ms.serve"]["value"] > 0
    # the CPU has no device trace: the device's readers read nothing
    assert not {"moe_route_ms.prefill", "moe_experts_roofline.serve",
                "host_syncs.serve"} & set(got)
    assert (tmp_path / f"{name}.json").exists()
