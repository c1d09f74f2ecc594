"""Spans of the port's own work, for a trace.

A span is a host record function opened only while a profiler records;
otherwise ``span`` returns one shared no-op context, so an untraced run
pays a single boolean check a span. A profiler that records the CPU and
CUDA puts these host spans and CUPTI's device records on one clock in one
trace: each kernel can be put down to the span that was open where it was
launched (the correlation id of its launch record), and each idle gap of
the device to the span the host was in.

A span is recorded as a host op (``_RecordFunctionFast``), not as a user
annotation (``torch.profiler.record_function``): the profiler repeats a
user annotation on the device's timeline as the range of the kernels
launched inside it, which a reader of device intervals would count as
device work, and which fills the idle gaps it measures.

Names are ``<layer>.<part>`` (``engine.prefill``, ``model.attn``,
``moe.experts``, ``step.adamw``); none holds a substring of a kernel's
name.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
_Record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context recording ``name`` while a profiler records, else a
    no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Record(name)


class _Open(torch.autograd.Function):
    """Identity on a layer's output; its backward opens the span."""

    @staticmethod
    def forward(ctx, y, name, open_spans):
        ctx.name, ctx.open_spans = name, open_spans
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        rf = _Record(ctx.name)
        rf.__enter__()
        ctx.open_spans.append(rf)
        return g, None, None


class _Close(torch.autograd.Function):
    """Identity on a layer's input; its backward closes the span."""

    @staticmethod
    def forward(ctx, x, open_spans):
        ctx.open_spans = open_spans
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.open_spans:
            ctx.open_spans.pop().__exit__(None, None, None)
        return g, None


def backward_span(name: str, fn, x, *args):
    """``fn(x, *args)``, whose backward is recorded as the span ``name``:
    from the output's gradient to the input's. The two identity nodes
    that mark it are put into the autograd graph only while a profiler
    records and ``x`` needs a gradient; otherwise this is ``fn(x,
    *args)``. Work autograd recomputes inside the backward records its
    own spans again, nested in this one."""
    if not (_profiler._is_profiler_enabled and torch.is_grad_enabled()
            and x.requires_grad):
        return fn(x, *args)
    open_spans = []
    y = fn(_Close.apply(x, open_spans), *args)
    return _Open.apply(y, name, open_spans)
