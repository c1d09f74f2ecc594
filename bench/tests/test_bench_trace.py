"""The program's spans beside the benchmark's reading of the trace, on
synthetic profiler records: host ops named after the program's spans
(``repro_torch.trace``), which leave no range on the device's timeline,
change nothing the reader gives; and the arithmetic of ``queue_wait_ms``."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench import spec
from bench import tracing as tr


class Ev:
    """One record of ``kineto_results.events()``: times in µs."""

    def __init__(self, name, start, dur, *, device=False, annotation=False,
                 corr=0, thread=0):
        self._name, self._start, self._dur = name, start, dur
        self._device, self._annotation = device, annotation
        self._corr, self._thread = corr, thread

    def name(self):
        return self._name

    def start_ns(self):
        return int(self._start * 1000)

    def duration_ns(self):
        return int(self._dur * 1000)

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def is_user_annotation(self):
        return self._annotation

    def correlation_id(self):
        return self._corr

    def device_resource_id(self):
        return self._thread


def kernel(name, start, dur, corr=0):
    return Ev(name, start, dur, device=True, corr=corr, thread=7)


def read_trace(events, span_names=("serve.insert", "serve.tick")):
    tracer = tr.Tracer(True)
    tracer.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))
    return tracer.read(set(span_names))


def metric(name, run):
    return spec.metric_reader(name).read(run)


def program_span(name, start, dur, thread=1):
    """A span of the program: a host op, not a user annotation."""
    return Ev(name, start, dur, thread=thread)


def test_program_spans_change_nothing_the_reader_gives():
    bench_events = [
        Ev(tr.WINDOW, 0, 100, annotation=True, thread=1),
        Ev(tr.WINDOW, 0, 100, device=True, annotation=True, thread=7),
        Ev("serve.insert", 0, 60, annotation=True, thread=1),
        Ev("serve.insert", 22, 30, device=True, annotation=True, thread=7),
        kernel("gemm_a", 22, 8), kernel("elementwise_b", 40, 12),
        kernel("outside_the_window", 150, 10),
        Ev("aten::mm", 11, 3, thread=1)]
    program = [program_span("engine.prefill", 5, 45),
               program_span("model.attn", 10, 10),
               program_span("moe.backward", 40, 20, thread=2),
               program_span("step.adamw", 70, 5)]
    parent = read_trace(bench_events)
    change = read_trace(bench_events[:4] + program + bench_events[4:])
    assert change == parent
    assert parent["device"] == [(22, 30, "gemm_a"), (40, 52, "elementwise_b")]
    assert parent["spans"] == [(0, 60, "serve.insert")]
    assert tr.breakdown(change) == tr.breakdown(parent)


def test_queue_wait_ms():
    run = {"kind": "serve", "stats": {"queue_wait_s": 3.0, "queued": 2000}}
    assert metric("queue_wait_ms", run) == pytest.approx(1.5)
    # the parent's engine counts no queue wait
    assert metric("queue_wait_ms", {"kind": "serve",
                                    "stats": {"decode_steps": 4}}) is None
    assert metric("queue_wait_ms", {"kind": "train", "steps": 3}) is None
