"""Named spans at the port's layer boundaries, on the profiler's clock.

`span(name)` opens a `torch.profiler.record_function` range only when the
calling thread is being profiled (torch.profiler records the thread that
started it, and only that one); otherwise it returns one shared no-op
context and enters nothing. The profiler that is running (the train
CLI's `--profile-dir`, or any caller's `torch.profiler.profile`) is the
only consumer: the spans land in its trace beside torch's ops and the
device's kernels, on one clock. Span names are plain dotted strings with
nothing variable in them (`train.*`, `recognizer.*`, `beam.*`).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A record_function range `name` when this thread is profiled, else
    a shared no-op context (a with-block on it costs under a microsecond
    of host time; a bare record_function about ten)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
