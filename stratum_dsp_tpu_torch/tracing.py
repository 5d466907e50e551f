"""The port's one tracer: spans, counters and their reset.

A span marks a stage of the work (``span``); ``host_read`` marks a point
where the host waits for the card: a read of a device tensor on the host
(``.tolist()``, ``bool(...)``, ``nonzero``, ``.cpu()``), or a copy from
pageable host memory to the card, which PyTorch makes wait for the stream
(``cudaMemcpyAsync`` and then ``cudaStreamSynchronize``). ``count`` adds to
a named counter.

Recording is on while a ``torch.profiler`` records in the thread that
opened the call, or inside ``recording()``; otherwise a span costs one check
and records nothing. The on state and the open span travel with the work to
worker threads that run it through ``contextvars.copy_context().run`` (the
batch CLI's decode thread, ``parallel.mesh.map_on_devices``), where the
profiler itself does not reach. A span that records:

* opens a record function ``stratum.<name>`` (what
  ``torch.profiler.record_function`` opens), so that it lies in the
  profiler's trace beside the kernels;
* keeps a record in memory (``spans()``): its name, its id and its
  parent's, the id of its call (one an ``analyze_batch_arrays`` call; the
  shards of a mesh share their call's), its thread, its start and end in ns
  on the profiler's clock (``time.time_ns()``, which the Chrome trace's
  ``baseTimeNanoseconds + ts * 1000`` follows), the counts made while it
  was the innermost open span, and its attributes;
* on a CUDA device (its own, or its parent's), records a timing event at
  its open and at its close on the current stream: ``stream_ms`` is the
  time between the two on the device's timeline, ``host_ms`` end minus
  start. ``host_read`` spans record no events.

Counters are always on: plain integer adds to a process-wide table
(``counters()``), and to the innermost open span where one records.
``reset()`` clears both tables; ``stratum_dsp_tpu_torch.reset_launch_counts``
calls it.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time

import torch

_LOCK = threading.Lock()
_COUNTERS: dict = {}
_RECORDS: list = []
_SPAN_IDS = itertools.count(1)
_CALL_IDS = itertools.count(1)
# the innermost open span that records, in this context
_OPEN: contextvars.ContextVar = contextvars.ContextVar("stratum_open_span", default=None)
_FORCED: contextvars.ContextVar = contextvars.ContextVar("stratum_recording", default=False)
_OFF = contextlib.nullcontext()


def _on() -> bool:
    return (_OPEN.get() is not None or _FORCED.get()
            or torch.autograd._profiler_enabled())


class _Span:
    """One recording span; its fields become the record ``spans()`` gives."""

    __slots__ = ("id", "name", "parent", "call", "thread", "start_ns", "end_ns", "counts",
                 "attrs", "device", "stream_ms", "_new_call", "_events", "_stream", "_fn",
                 "_token")

    def __init__(self, name: str, device, new_call: bool, attrs: dict, timed: bool = True):
        self.name, self.attrs, self._new_call = name, attrs, new_call
        self.device = None if device is None else torch.device(device)
        self.counts: dict = {}
        self.stream_ms = self._stream = None
        self._events = () if timed else None

    def __enter__(self):
        outer = _OPEN.get()
        self.id = next(_SPAN_IDS)
        self.parent = outer.id if outer is not None else None
        self.call = outer.call if outer is not None else None
        if self._new_call and self.call is None:
            self.call = next(_CALL_IDS)
        if self.device is None and outer is not None:
            self.device = outer.device
        self.thread = threading.get_ident()
        # the record function of ``torch.profiler.record_function`` without
        # its operator dispatch: the profiler stamps it within microseconds
        # of the two clock reads around it
        self.start_ns = time.time_ns()
        self._fn = torch.autograd._record_function_with_args_enter("stratum." + self.name)
        if self._events is not None and self.device is not None and self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            self._events = (start,)
        self._token = _OPEN.set(self)
        return self

    def __exit__(self, *exc):
        _OPEN.reset(self._token)
        if self._events:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            self._events = (self._events[0], end)
        torch.autograd._record_function_with_args_exit(self._fn)
        self.end_ns = time.time_ns()
        # a closed span keeps only its record
        self._fn = self._token = self._stream = None
        with _LOCK:
            _RECORDS.append(self)
        return False

    def record(self) -> dict:
        if self._events:
            self._events[1].synchronize()
            self.stream_ms = self._events[0].elapsed_time(self._events[1])
            self._events = ()
        return {"id": self.id, "name": self.name, "parent": self.parent, "call": self.call,
                "thread": self.thread, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "host_ms": (self.end_ns - self.start_ns) / 1e6, "stream_ms": self.stream_ms,
                "counts": dict(self.counts), "attrs": dict(self.attrs)}


def span(name: str, *, device=None, call: bool = False, **attrs):
    """A context manager for one span named ``name`` (``stratum.<name>`` in
    the profiler's trace). ``device``: the device whose current stream the
    span times (children take their parent's); ``call``: the span opens a
    call, with a new call id unless it lies inside one already; ``attrs``
    go into its record."""
    if not _on():
        return _OFF
    return _Span(name, device, call, attrs)


def host_read(site: str):
    """A ``host_read`` span (attribute ``site``) around one point where the
    host waits for the card, and one more ``host_reads`` count. A constant
    table's upload (``ops/tables.py``) is one, once a device."""
    count("host_reads")
    if not _on():
        return _OFF
    return _Span("host_read", None, False, {"site": site}, timed=False)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and to the innermost open span."""
    inner = _OPEN.get()
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n
        if inner is not None:
            inner.counts[name] = inner.counts.get(name, 0) + n


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches``, under the tracer's lock:
    the shards of a mesh on distinct cards launch from one host thread
    each."""
    with _LOCK:
        wrapper.launches += 1


@contextlib.contextmanager
def recording():
    """Record spans inside this block, with or without a profiler."""
    token = _FORCED.set(True)
    try:
        yield
    finally:
        _FORCED.reset(token)


def spans() -> list:
    """The records of the spans closed since the last ``reset()``, in the
    order they opened (``stream_ms`` waits for the span's close event)."""
    with _LOCK:
        done = list(_RECORDS)
    return [s.record() for s in sorted(done, key=lambda s: (s.start_ns, s.id))]


def counters() -> dict:
    """The process-wide counters since the last ``reset()``."""
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    """Set every counter to 0 and drop the recorded spans."""
    with _LOCK:
        _COUNTERS.clear()
        _RECORDS.clear()
