"""The device trace of a run: ``torch.profiler`` with the device's
activity alone (host events would cost seconds on a ``parity`` request),
read back as intervals on the host's clock.

The trace covers the last ``TRACE_S`` seconds of the measured window, not
all of it: reading a trace back costs about three host seconds per traced
second at batch 8 (some 45,000 device activities a second), and a traced
run has to end within its time limit on a slower host too. The loops call
``poll`` with the window's elapsed seconds between requests; it starts the
profiler where the span begins, and ``close`` stops and reads it after the
window, so that only the profiler's start falls inside the window
(``stall_s``; collection toggled on and off inside a window recorded
nothing on the card's PyTorch 2.11).

A spin kernel launched right after a synchronize, at a known host time,
ties the trace's clock to the host's: each device interval is shifted by
the gap between the two, so that the harness's host spans can label the
device's idle gaps. A traced span that recorded no device activity, or no
marker, is no trace: ``require`` raises ``NoTrace``, and the run prints no
result rather than an idle share of 100 %.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import torch

Interval = Tuple[str, float, float]  # (name, start, end), seconds on time.perf_counter's clock
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
TRACE_S = 15.0  # the traced span of a window


class NoTrace(RuntimeError):
    """A traced run whose trace holds nothing to read."""


def traced_span(seconds: float) -> Tuple[float, float]:
    """(from, to) in a window of ``seconds``: its last ``TRACE_S``."""
    return max(0.0, seconds - TRACE_S), seconds


class DeviceTrace:
    """Collects the device intervals from the start of the traced span of
    one window to ``close``."""

    def __init__(self, seconds: float):
        self.span = traced_span(seconds)
        self.events: List[Interval] = []
        self.aligned = False
        self.t0: Optional[float] = None  # where the trace starts on the host's clock
        self.stall_s = 0.0  # what starting the profiler took from the window
        self.read_s = 0.0  # stopping and reading it back, after the window
        self._prof = None
        self._host_ns = 0

    def poll(self, elapsed: float) -> Optional[str]:
        """"start" where ``elapsed`` seconds of the window start the traced
        span and the profiler was started; None otherwise."""
        if self.t0 is not None or elapsed < self.span[0]:
            return None
        from torch.profiler import ProfilerActivity, profile

        begin = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self.t0, self._host_ns = time.perf_counter(), time.time_ns()
        torch.cuda._sleep(1000)
        self.stall_s = self.t0 - begin
        return "start"

    def close(self):
        """Stops the profiler, if it runs, and reads the trace back."""
        if self._prof is None:
            return
        begin = time.perf_counter()
        torch.cuda.synchronize()
        self._prof.stop()
        raw = _device_events(self._prof)
        self._prof = None
        marks = [start for name, start, _ in raw if MARKER in name]
        # the marker starts a launch's latency after the host's stamp (µs)
        offset_ns = (marks[0] - self._host_ns) if marks else 0
        self.aligned = bool(marks)
        ref = offset_ns + self._host_ns
        self.events = sorted((name, self.t0 + (s - ref) / 1e9, self.t0 + (e - ref) / 1e9)
                             for name, s, e in raw if MARKER not in name)
        self.read_s = time.perf_counter() - begin

    def require(self):
        """Raises ``NoTrace`` unless the traced span started, recorded some
        device activity and the marker that ties its clock to the host's."""
        if self.t0 is None:
            raise NoTrace("the traced span never started: no request ran past its start")
        if not self.events:
            raise NoTrace("the profiler recorded no device activity in the traced span")
        if not self.aligned:
            raise NoTrace(f"no {MARKER} marker in the trace: its clock cannot be tied to the host's")


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device activity: kernels, copies
    and sets, on the profiler's own clock, read from its raw records (the
    profiler's own summaries take minutes over a window's ~10^6 events)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]


def clip(events: Sequence[Interval], t0: float, t1: float) -> List[Interval]:
    return [(n, max(s, t0), min(e, t1)) for n, s, e in events if e > t0 and s < t1]


def union(events: Sequence[Interval]) -> List[Tuple[float, float]]:
    """The device's busy intervals: overlapping activities counted once."""
    merged: List[List[float]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(events: Sequence[Interval]) -> float:
    return sum(e - s for s, e in union(events))


def idle_share(run) -> Optional[float]:
    """The device's idle share of a run's traced window, in %: 1 - the
    union of every device activity's interval (kernels, copies, sets;
    overlaps counted once) over the window; None without a trace."""
    if run.device_events is None or not run.trace_window_s:
        return None
    return 100.0 * (1.0 - busy_seconds(run.device_events) / run.trace_window_s)


def gaps(events: Sequence[Interval], t0: float, t1: float) -> List[Tuple[float, float]]:
    """The idle intervals of [t0, t1]."""
    out, at = [], t0
    for s, e in union(clip(events, t0, t1)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if t1 > at:
        out.append((at, t1))
    return out


def by_name(events: Sequence[Interval], top: int = 10) -> List[list]:
    """The device operations that took the most time, summed by name."""
    total = defaultdict(float)
    for n, s, e in events:
        total[n] += e - s
    return [[n[:120], t] for n, t in sorted(total.items(), key=lambda x: -x[1])[:top]]


def label_gaps(idle: Sequence[Tuple[float, float]], spans: Sequence[Interval], t0: float,
               top: int = 10) -> List[list]:
    """The longest idle gaps, each named by the shortest harness span that
    covered its middle on the host (``host: other`` where none did) and its
    start in the window."""
    out = []
    for s, e in sorted(idle, key=lambda g: -(g[1] - g[0]))[:top]:
        mid = (s + e) / 2
        covering = [(b - a, name) for name, a, b in spans if a <= mid <= b]
        label: Optional[str] = min(covering)[1] if covering else None
        out.append([f"{label or 'host: other'} at +{s - t0:.6f} s", e - s])
    return out
