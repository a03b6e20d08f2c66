"""The traced stretch of a `--trace 1` run: torch.profiler over a few
steady steps inside the window, its chrome trace parsed into device
intervals, and what the per-layer readers and the breakdown take from
it.

Only device-side events count as device work: kernels, copies and
memsets. The stretch is the span of the harness's own record_function
range "bench.traced" on the same clock; it ends after a synchronize, so
every kernel launched inside it has finished inside it. Idle gaps are
the holes in the union of the device intervals over that span, each
labelled by what the host was doing at the gap's middle: the innermost
record_function range (the harness's own spans, or torch's) and the
innermost torch op of any of the process's threads.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
SPAN = "bench.traced"
TOP = 10


class Stretch:
    """Start and stop the profiler around part of a window."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.rf = None
        self.summary = None

    @property
    def running(self) -> bool:
        return self.prof is not None

    def start(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.rf = record_function(SPAN)
        self.rf.__enter__()

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rf.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        self.summary = summarize(events)


def warm_profiler(device):
    """One tiny profiled op, so that the profiler's own first start
    (CUPTI set-up) falls into set-up and not into the window."""
    s = Stretch(device)
    s.start()
    torch.ones(8, device=device).sum()
    s.stop()


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> dict:
    """Chrome-trace events -> {span_s, busy_s, kernels [(name, start_us,
    dur_us)], marks [(name, start_us, dur_us, thread)] of the harness's
    record_function ranges, device_ops [[name, s]], idle_gaps [[label,
    s]]}."""
    spans = [e for e in events if e.get("name") == SPAN
             and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    if not spans:
        raise RuntimeError("the profiler's trace holds no harness span")
    span = spans[0]
    lo, hi = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    kernels = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
        if b > a:
            kernels.append((e.get("name", "?"), a, b - a))
    busy = _union([(a, a + d) for _, a, d in kernels])
    busy_us = sum(b - a for a, b in busy)
    by_name: dict[str, float] = {}
    for name, _, d in kernels:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("name") != SPAN
            and e.get("pid") == span.get("pid")
            and float(e["ts"]) <= hi
            and float(e["ts"]) + float(e["dur"]) >= lo]
    gaps, at = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [[_label(host, (a + b) / 2), (b - a) / 1e6]
                for a, b in gaps[:TOP]]
    marks = [(e["name"], float(e["ts"]), float(e["dur"]), e.get("tid"))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") != SPAN
             and lo <= float(e["ts"]) <= hi]
    return {"span_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
            "kernels": kernels, "marks": sorted(marks, key=lambda m: m[1]),
            "device_ops": [[n[:160], d / 1e6] for n, d in ops],
            "idle_gaps": labelled}


def _label(host: list, t: float) -> str:
    """The innermost record_function range (the harness's or torch's)
    and the innermost torch op that the process's threads were inside
    at time t."""
    live = [e for e in host
            if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
    spans = [e for e in live if e.get("cat") == "user_annotation"]
    ops = [e for e in live if e.get("cat") == "cpu_op"]
    inner = lambda es: min(es, key=lambda e: float(e["dur"]))["name"]  # noqa
    parts = ([inner(spans)] if spans else []) + ([inner(ops)] if ops else [])
    return "/".join(parts)[:160] if parts else "host idle or in Python"


def kernel_seconds(summary: dict, patterns, exclude=()) -> float:
    """Device seconds of the traced kernels whose names hold any of
    `patterns` and none of `exclude`."""
    return sum(d for name, _, d in summary["kernels"]
               if any(p in name for p in patterns)
               and not any(x in name for x in exclude)) / 1e6


def marked_batches(summary: dict, span: str, rows: str) -> list:
    """The `span` ranges wholly inside the stretch, each with the rows
    that the harness recorded in the `rows` mark right after it on the
    same thread (a JSON list in the mark's name after `rows` and a
    space) and the kernels that started inside it:
    [(rows, [(name, start_us, dur_us)])]."""
    marks = summary["marks"]
    out = []
    for i, (name, ts, dur, tid) in enumerate(marks):
        if name != span:
            continue
        nxt = next((m for m in marks[i + 1:]
                    if m[3] == tid and m[0].startswith(rows + " ")), None)
        if nxt is None:
            continue
        ks = [k for k in summary["kernels"] if ts <= k[1] <= ts + dur]
        out.append((json.loads(nxt[0][len(rows) + 1:]), ks))
    return out
