"""A profiled stretch of the timed path, read from ``torch.profiler``'s
trace, with the port's own launch counters as its witness.

Copied from ``chip_smoke.py``'s ``device_profile``: one warm-up cycle whose
events are dropped (without it the trace loses the first launches of a
stretch), then the stretch itself.  A stretch in which the profiler saw a
different number of launches of any hand-written kernel than the port's
launch counters (``ops.*.LAUNCHES``) counted is taken again, three takes
in all; then :class:`BlindProfiler` is raised, and no device time or idle
share of such a stretch is ever reported.
"""
from __future__ import annotations

import bisect
import importlib
import re
import time
from dataclasses import dataclass, field

import torch

from portbench.harness import PACKAGE, RunError

# the port's launch counters: (module, attribute, the names of the kernels
# each counted launch runs on the card)
COUNTERS = {
    "gram_chol": ("ops.gram_chol", "LAUNCHES", r"\bgram_chol_kernel\b"),
    "tri_inv": ("ops.tri_inv", "LAUNCHES", r"\btri_inv_kernel\b"),
    "chol_block": ("ops.chol_block", "LAUNCHES", r"\bchol_block_kernel\b"),
    "gram_panel": ("ops.blocked", "PANEL_LAUNCHES", r"\bgram_panel_kernel\b"),
    "hist_panel": ("ops.blocked", "HIST_LAUNCHES", r"\bhist_panel_kernel\b"),
    "panel_solve": ("ops.blocked", "SOLVE_LAUNCHES", r"\bpanel_solve_kernel\b"),
    "diag_logdet": ("ops.logdet", "LAUNCHES", r"\bdiag_logdet_kernel\b"),
    "trail_panel": ("ops.trail", "PANEL_LAUNCHES", r"\btrail_panel_kernel\b"),
    "trail_update": ("ops.trail", "UPDATE_LAUNCHES", r"\btrail_update_kernel\b"),
    "durbin": ("ops.durbin", "KERNEL_LAUNCHES",
               r"\bdurbin_(window_|window_finish_)?kernel\b"),
    "durbin_bwd": ("ops.durbin", "BWD_KERNEL_LAUNCHES",
                   r"\bdurbin_bwd_(window_|front_|start_|finish_)?kernel\b"),
}
TAKES = 3
SPAN = "portbench.stretch"
# device records that are copies or fills, not kernels
_NOT_KERNEL = re.compile(r"^(Memcpy|Memset)")


class BlindProfiler(RunError):
    """The profiler missed launches the counters counted, in every take."""


def read_counters() -> dict[str, int]:
    """The counters the port has, by name (a counter it lacks is left out)."""
    out = {}
    for name, (module, attr, _) in COUNTERS.items():
        mod = importlib.import_module(f"{PACKAGE}.{module}")
        if hasattr(mod, attr):
            out[name] = getattr(mod, attr)
    return out


@dataclass
class Trace:
    """One profiled stretch: its device records (``names``, ``starts``,
    ``ends`` in µs, on the profiler's clock), the stretch's span on the
    same clock, the units of work it did (steps or calls), its host wall
    time, the counters' launches in it, and what the host was doing in the
    device's idle gaps (``gaps``: name -> µs)."""
    names: list[str]
    starts: list[float]
    ends: list[float]
    span: tuple[float, float]
    units: int
    host_s: float
    counted: dict[str, int]
    gaps: dict[str, float] = field(default_factory=dict)
    takes: int = 1

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-6

    def kernel_idx(self, pattern: str | None = None) -> list[int]:
        """Indices of the kernels (no copies, no fills) whose names match
        ``pattern`` (every kernel when None)."""
        rx = re.compile(pattern) if pattern else None
        return [i for i, n in enumerate(self.names)
                if not _NOT_KERNEL.match(n) and (rx is None or rx.search(n))]

    def seconds(self, idx) -> float:
        """Summed durations of the records ``idx``, in seconds."""
        return sum(self.ends[i] - self.starts[i] for i in idx) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of every device record's interval, clipped to the
        span."""
        lo, hi = self.span
        ivs = sorted((max(s, lo), min(e, hi))
                     for s, e in zip(self.starts, self.ends) if e > lo and s < hi)
        out: list[list[float]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> list[tuple[float, float]]:
        lo, hi = self.span
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations that took most time, ``[name,
        seconds]``."""
        by: dict[str, float] = {}
        for name, s, e in zip(self.names, self.starts, self.ends):
            by[name] = by.get(name, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[short(k), v * 1e-6] for k, v in top]

    def top_gaps(self, n: int = 10) -> list[list]:
        top = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-6] for k, v in top]


def short(name: str, limit: int = 120) -> str:
    """A kernel's name without its trailing argument list, at most
    ``limit`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0:
                    name = name[:i]
                break
    return name.strip()[:limit]


def _host_activity(cpu: list, gaps: list[tuple[float, float]]) -> dict:
    """Each gap's duration, summed by the name of the innermost host event
    (of the stretch's own thread) that was running at its midpoint: a
    sweep over the events sorted by start, a stack of the enclosing
    ones."""
    cpu = sorted(cpu, key=lambda ev: (ev[0], -ev[1]))
    starts = [ev[0] for ev in cpu]
    out: dict[str, float] = {}
    stack: list = []
    at = 0
    for lo, hi in sorted(gaps):
        mid = 0.5 * (lo + hi)
        stop = bisect.bisect_right(starts, mid)
        while at < stop:
            ev = cpu[at]
            while stack and stack[-1][1] < ev[0]:
                stack.pop()
            stack.append(ev)
            at += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(no host event)"
        out[name] = out.get(name, 0.0) + (hi - lo)
    return out


def _trace(events, units: int, host_s: float, counted: dict) -> Trace:
    from torch.autograd import DeviceType

    span = next((e for e in events if e.name == SPAN
                 and e.device_type == DeviceType.CPU), None)
    if span is None:
        raise BlindProfiler(f"the profiler lost the stretch's span {SPAN!r}")
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    cpu = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CPU and e.thread == span.thread
           and e is not span and not e.name.startswith("ProfilerStep")]
    tr = Trace([e.name for e in dev], [e.time_range.start for e in dev],
               [e.time_range.end for e in dev],
               (span.time_range.start, span.time_range.end), units, host_s,
               counted)
    tr.gaps = _host_activity(cpu, tr.idle_gaps())
    return tr


def missing_launches(tr: Trace) -> dict[str, tuple[int, int]]:
    """``{counter: (seen, counted)}`` wherever the profiler saw another
    number of a hand-written kernel's launches than its counter counted."""
    out = {}
    for name, counted in tr.counted.items():
        seen = len(tr.kernel_idx(COUNTERS[name][2]))
        if seen != counted:
            out[name] = (seen, counted)
    return out


def profile(stretch) -> Trace:
    """``stretch()`` (which does its work, waits for the card and returns
    the units it did) run twice under the profiler, the first cycle a
    dropped warm-up; retaken while any hand-written kernel's launches seen
    and counted differ, :data:`TAKES` takes in all."""
    from torch.profiler import ProfilerActivity, record_function, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    missing = {}
    for take in range(1, TAKES + 1):
        traces = []
        with torch.profiler.profile(
                activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: traces.append(list(p.events()))
        ) as prof:
            stretch()
            prof.step()
            before = read_counters()
            with record_function(SPAN):
                t0 = time.perf_counter()
                units = stretch()
                host_s = time.perf_counter() - t0
            after = read_counters()
            prof.step()
        if len(traces) != 1:
            raise BlindProfiler(f"the profiler returned {len(traces)} traces")
        counted = {k: after[k] - before[k] for k in after}
        tr = _trace(traces[0], units, host_s, counted)
        tr.takes = take
        missing = missing_launches(tr)
        if not missing and tr.kernel_idx():
            return tr
    raise BlindProfiler(f"in {TAKES} takes the profiler saw other launch "
                        f"counts than the port's counters (seen, counted): "
                        f"{missing or 'no kernel at all'}")
