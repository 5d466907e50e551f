"""The traced window: ``torch.profiler`` (CUPTI) over the window, its Chrome
trace reduced to what the per-layer readers and ``breakdown`` need.

The benchmark marks its own spans with ``record_function`` (``SPANS``); the
window is the span ``portbench.window``, and every device interval is cut to
it. The reduction keeps:

* ``busy_s``: the union of the device's kernels, copies and sets;
* ``window_s``: the window's length on the trace's clock;
* ``kernels``: the number of kernels launched in the window;
* ``device_s_by_name``: each kernel's (or copy's) device seconds by name;
* ``idle_by_cause``: the seconds the device stood idle, by the benchmark
  span open halfway through each gap and the innermost host op in progress
  then.
"""

from __future__ import annotations

import bisect
import contextlib
import gzip
import json
import os
import tempfile

WINDOW = "portbench.window"
SPANS = ("portbench.analyze_batch", "portbench.results_to_host", "portbench.cli_call",
         "portbench.request")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# how far back among the host ops that began before a gap's middle to look
# for one still in progress then
HOST_OP_LOOKBACK = 256


def profile():
    """A profiler of host and device activity, not yet started."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def events(prof) -> list:
    """The trace's complete events (``ph == "X"``), through a Chrome trace
    written to ``TMPDIR`` and deleted at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            trace = json.load(fh)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.remove(path)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    """Merged ``[(start, end)]`` of sorted intervals."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(evs: list) -> dict:
    """The window's summary (see the module's docstring); times in seconds.
    Raises ``ValueError`` when the trace has no window span or no device
    activity in it."""
    win = [e for e in evs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} span")
    w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    dev = []
    by_name: dict = {}
    n_kernels = 0
    for e in evs:
        cat = str(e.get("cat", "")).lower()
        if cat not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        s, t = max(s, w0), min(s + d, w1)
        if t <= s:
            continue
        dev.append((s, t))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s) * 1e-6
        n_kernels += cat == "kernel"
    if not dev:
        raise ValueError("no device activity in the traced window")
    busy = _union(sorted(dev))
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))

    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in evs
                   if e.get("cat") == "user_annotation" and e.get("name") in SPANS)
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in evs
                 if e.get("cat") == "cpu_op")
    op_starts = [o[0] for o in ops]
    span_starts = [s[0] for s in spans]

    def innermost(items, starts, at, lookback):
        i = bisect.bisect_right(starts, at)
        for j in range(i - 1, max(i - 1 - lookback, -1), -1):
            if items[j][1] > at:
                return items[j][2]
        return None

    idle: dict = {}
    for s, t in gaps:
        mid = 0.5 * (s + t)
        cause = (f"{innermost(spans, span_starts, mid, len(spans)) or 'no span'}/"
                 f"{innermost(ops, op_starts, mid, HOST_OP_LOOKBACK) or 'no host op'}")
        idle[cause] = idle.get(cause, 0.0) + (t - s) * 1e-6
    return {"busy_s": sum(t - s for s, t in busy) * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "kernels": n_kernels, "device_s_by_name": by_name, "idle_by_cause": idle}


def top(mapping: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(mapping.items(), key=lambda kv: -kv[1])[:n]]


def device_seconds(summary: dict, kernel: str):
    """Device seconds of the kernels whose name holds ``kernel``, or None
    where none ran in the window."""
    hits = [v for k, v in summary["device_s_by_name"].items() if kernel in k]
    return sum(hits) if hits else None
