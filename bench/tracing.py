"""The traced run's reading of the card: torch.profiler over the window,
the device intervals read from the profiler's raw records (building its
event tree over hundreds of thousands of kernels would take minutes), the
benchmark's own host spans (``record_function`` around the calls into each
layer), and what they give: the union of device intervals (busy time), the
time by kernel name, and each idle gap named by the span the host was in.
A copy of the reading in the repository's ``chip_smoke.profiled``.
"""
from __future__ import annotations

import contextlib
import time

import torch

WINDOW = "bench.window"
OUTSIDE = "host.loop"        # the host in the window, in no span of ours


class Tracer:
    """Spans and the profiler; without ``enabled`` both are no-ops."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.marks = []         # (what set-up finished, host clock)

    def mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter()))

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
                torch.cuda.synchronize()
        self.prof = prof

    def read(self, span_names) -> dict:
        """{"device": [(start_us, end_us, name)], "spans": [(start_us,
        end_us, name)] of ``span_names``, "window": (start_us, end_us)},
        device intervals clipped to the window."""
        from torch.autograd import DeviceType
        device, spans, window = [], [], None
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            if e.device_type() == DeviceType.CUDA:
                # a span of ours shows on the device's timeline too, as
                # the range of the kernels it launched: not device work
                if e.name() not in span_names and e.name() != WINDOW:
                    device.append((start, end, e.name()))
            else:
                name = e.name()
                if name == WINDOW:
                    window = (start, end)
                elif name in span_names:
                    spans.append((start, end, name))
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        device = sorted((max(s, window[0]), min(t, window[1]), n)
                        for s, t, n in device
                        if t > window[0] and s < window[1])
        if not device:
            raise RuntimeError("the profiler recorded no device activity "
                               "in the window")
        return {"device": device, "spans": sorted(spans), "window": window}


def busy_intervals(device):
    """The union of the device intervals, as sorted disjoint (start, end)."""
    out = []
    for s, t, _ in device:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_us(device) -> float:
    return sum(t - s for s, t in busy_intervals(device))


def by_name(device) -> dict:
    out = {}
    for s, t, n in device:
        out[n] = out.get(n, 0.0) + t - s
    return out


def idle_by_span(trace) -> dict:
    """Idle device time in the window, in µs, by the host span that covers
    the middle of each gap (the innermost, that is the latest started)."""
    busy = busy_intervals(trace["device"])
    lo, hi = trace["window"]
    gaps, cur = [], lo
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    spans = trace["spans"]
    out, j, open_ = {}, 0, []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while j < len(spans) and spans[j][0] <= mid:
            open_.append(spans[j])
            j += 1
        open_ = [sp for sp in open_ if sp[1] > mid]
        name = open_[-1][2] if open_ else OUTSIDE
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def breakdown(trace) -> dict:
    """The ten device operations that took most time and the idle time by
    host span, in seconds."""
    ops = sorted(by_name(trace["device"]).items(), key=lambda kv: -kv[1])
    gaps = sorted(idle_by_span(trace).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], v / 1e6] for n, v in ops[:10]],
            "idle_gaps": [[n, v / 1e6] for n, v in gaps[:10]]}
