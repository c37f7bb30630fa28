"""Tracing and profiling hooks.

Counterpart of ``gpvae_tpu/utils/profiling.py``:

* :func:`trace` -- ``torch.profiler`` around the wrapped steps, written
  as a Chrome trace that TensorBoard's profiler plugin and
  ``chrome://tracing`` read;
* :func:`span` (and :func:`spanned`, its decorator), :func:`spans`,
  :func:`clear_spans` -- the port's own spans at its layers, recorded
  only while a ``torch.profiler`` collects;
* :class:`StepTimer` -- steps/s and elapsed time, waiting for the device
  when asked;
* :func:`device_memory_stats` -- live and peak bytes of the caching
  allocator and the card's memory.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

from gpvae_tpu_torch.utils.debug import leaves_with_path


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the block, the host's ops and, where a
    card is present, its kernels: ``with trace("prof") as prof: ...``
    writes ``<host>_<pid>.<time>.pt.trace.json`` into ``log_dir`` and
    yields the ``torch.profiler.profile`` (``prof.key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


# the newest records kept by span(); older ones are dropped
SPAN_BUFFER = 65_536
_SPANS: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    """One closed span (see :func:`span`).  ``parent`` is the ``id`` of
    the innermost span open on the same thread when it opened (None at
    the top), the host interval is ``time.perf_counter_ns``, and
    ``device_ms`` the stream's time between the span's two CUDA events
    (None where it recorded none: a span not asked for it, on the CPU,
    during a CUDA graph's capture)."""
    id: int
    name: str
    parent: int | None
    host_start_ns: int
    host_end_ns: int
    device_ms: float | None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6


def _open_spans() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    """An open span: a ``record_function`` range in the profiler's trace,
    then a record in :func:`spans`' buffer."""
    __slots__ = ("name", "device", "id", "parent", "t0", "t1", "_range")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self) -> None:
        stack = _open_spans()
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self._range = _autograd_profiler.record_function(self.name)
        self._range.__enter__()
        if self.device and torch.cuda.is_initialized() and \
                not torch.cuda.is_current_stream_capturing():
            self.device = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.device[0].record()
        else:
            self.device = None
        stack.append(self)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self.device is not None:
            if torch.cuda.is_current_stream_capturing():
                self.device = None
            else:
                self.device[1].record()
        _open_spans().pop()
        self._range.__exit__(*exc)
        _SPANS.append(self)


def span(name: str, *, device: bool = False):
    """The one way the port marks a layer: ``with span("gpvae.kl"): ...``.

    Off unless a ``torch.profiler`` is collecting (its active cycle, not
    its warm-up): then it returns one shared no-op context.  On, it opens
    ``record_function(name)``, an event in the profiler's trace beside the
    kernels, and on closing appends a :class:`SpanRecord` to a buffer of
    the newest :data:`SPAN_BUFFER` (:func:`spans`).  With ``device`` it
    also records two CUDA events on the current stream, where the process
    has initialised CUDA, for the span's device interval; each pair costs
    tens of microseconds to a tenth of a millisecond of host under the
    profiler, so only the spans whose device interval is read ask for
    them.  A span changes nothing
    that is computed."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def spanned(name: str, *, device: bool = False):
    """Decorate a function so that each call runs inside
    ``span(name, device=device)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, device=device):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans() -> list[SpanRecord]:
    """The buffer's records, oldest closed first, each span's device
    interval resolved (waiting for its end event)."""
    out = []
    for s in list(_SPANS):
        if isinstance(s.device, tuple):
            start, end = s.device
            end.synchronize()
            s.device = start.elapsed_time(end)
        out.append(SpanRecord(s.id, s.name, s.parent, s.t0, s.t1, s.device))
    return out


def clear_spans() -> None:
    """Empty :func:`spans`' buffer."""
    _SPANS.clear()


class StepTimer:
    """Steps/s over the wall clock, with a wait for the device on read.

    Usage::

        timer = StepTimer()
        for batch in batches:
            metrics = train_step(state, batch, beta)
            timer.tick()
            if state.step % 500 == 0:
                print(timer.report(metrics["loss"]))
    """

    def __init__(self):
        self._t0 = time.perf_counter()
        self._ticks = 0

    def tick(self, n: int = 1) -> None:
        self._ticks += n

    def report(self, sync_on=None) -> dict:
        """``steps_per_sec``, ``elapsed_s`` and ``steps`` since the last
        report (or the start), then restart.  With ``sync_on`` (a tensor,
        or a dict or list of them) the host first waits for the device of
        each CUDA tensor in it, so the clock covers the queued work."""
        if sync_on is not None:
            for device in {leaf.device for _, leaf in leaves_with_path(sync_on)
                           if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
                torch.cuda.synchronize(device)
        now = time.perf_counter()
        dt = now - self._t0
        out = {"steps_per_sec": self._ticks / max(dt, 1e-9),
               "elapsed_s": dt, "steps": self._ticks}
        self._t0 = now
        self._ticks = 0
        return out


def device_memory_stats(device=None) -> dict:
    """``bytes_in_use`` and ``peak_bytes_in_use`` of PyTorch's caching
    allocator on ``device`` (the current CUDA device by default) and
    ``bytes_limit``, the card's memory; ``{}`` on the CPU, which has no
    such record (the JAX package's keys; its ``{}`` where a device keeps
    none)."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                device).total_memory}
