"""Spans: where the port's host and device time goes.

``with span(name, device=None):`` around a piece of work does two things.

Always, it adds one count and the host seconds of the block to the
process totals of ``name``; with a CUDA ``device`` it also records a
pair of CUDA events on the device's current stream, whose elapsed time
is folded into the name's device seconds once the events are complete
(polled, never waited on) or when the totals are read.  A span never
waits for the device.  ``into=`` takes further :class:`Tally` objects
(a model's :class:`~ecwam_tpu_torch.model.driver.StepTimers`, the CLI's
``OutputTimers``) that take the same seconds: device time from the
events on CUDA, host time elsewhere.

While tracing is on, it also appends the interval ``(name, parent,
start_ns, end_ns)``, with ``parent`` the innermost span open around it
(None at the top) and the ends read from ``time.time_ns()``, the clock
``torch.profiler`` stamps its events with; with CUDA in use it pushes
an NVTX range ``ecwam.<name>`` for ``nsys``.  Tracing is on while a
``torch.profiler`` records in the process, or between :func:`start` and
:func:`stop`.  A span never opens a ``record_function``: the profiler
would put that range on the device's timeline, among the operations.

:func:`report` returns the totals, the intervals and the counters: the
launch counters of kernels A and B and those set by :func:`set_counter`;
:func:`write_chrome` writes the intervals and totals as a Chrome trace
(Perfetto loads it).

The spans, each with what reads it: ``advect`` and ``phys`` (device
timed) in the models' ``advance`` (``StepTimers``); ``newwind`` around
``newwind.forcing``, ``newwind.upload``, ``newwind.rows`` and the
device-timed ``refresh`` around ``refresh.gradi`` and ``refresh.cfl``
(the idle share of the device inside the port; the refresh's device and
host time a refresh); the set-up's
``setup.tables``, ``setup.upload`` and ``model.init``; the CLI's
``output.products``, ``output.secondorder``, ``output.d2h``,
``output.write``, ``restart``, ``rim`` and ``boundary``
(``OutputTimers``).  The counter ``cfl_dropped_rows`` is the number of
SRL rows whose current terms the last CFL current retry dropped (None
before the first).
"""

from __future__ import annotations

import collections
import json
import os
import time

import torch

NVTX_PREFIX = "ecwam."

_profiling = torch._C._autograd._profiler_enabled
_perf_counter = time.perf_counter


class Tally:
    """Seconds taken from spans: the device time of CUDA event pairs,
    folded as they complete, plus host seconds where a span ran without
    a CUDA device.  Reading waits only on this tally's own events."""

    __slots__ = ("_s", "_pending")

    def __init__(self):
        self._s = 0.0
        self._pending = collections.deque()

    def add_host(self, seconds: float) -> None:
        self._s += seconds

    def add_events(self, start, end) -> None:
        p = self._pending
        p.append((start, end))
        while p and p[0][1].query():
            a, b = p.popleft()
            self._s += a.elapsed_time(b) * 1e-3

    @property
    def seconds(self) -> float:
        p = self._pending
        while p:
            a, b = p.popleft()
            b.synchronize()
            self._s += a.elapsed_time(b) * 1e-3
        return self._s


class _Total:
    __slots__ = ("count", "host_s", "device")

    def __init__(self):
        self.count = 0
        self.host_s = 0.0
        self.device = None


_totals: dict = {}
# counters beyond the launch counters: an int, a 0-d tensor (read from its
# device only by report()) or None where nothing has set it yet
_counters: dict = {"cfl_dropped_rows": None}
_intervals: list = []
_open: list = []          # names of the open spans, innermost last
_forced = False


def tracing() -> bool:
    """Whether spans record intervals now."""
    return _forced or _profiling()


def start() -> None:
    """Record intervals from now on, profiler or not; drops those kept
    so far."""
    global _forced
    _intervals.clear()
    _forced = True


def stop() -> None:
    global _forced
    _forced = False


class span:
    """A span ``name`` around a block (see the module's docstring);
    ``device``: where the block's work runs (timed by CUDA events when it
    is a CUDA device); ``into``: tallies that take its seconds too."""

    __slots__ = ("name", "device", "into", "_t0", "_ns", "_ev", "_parent",
                 "_nvtx")

    def __init__(self, name: str, device=None, into=()):
        self.name = name
        if device is not None:
            if not isinstance(device, torch.device):
                device = torch.device(device)
            if device.type != "cuda":
                device = None
        self.device = device
        self.into = into

    def __enter__(self):
        if _forced or _profiling():
            self._parent = _open[-1] if _open else None
            self._nvtx = (self.device is not None
                          or torch.cuda.is_initialized())
            if self._nvtx:
                torch.cuda.nvtx.range_push(NVTX_PREFIX + self.name)
            self._ns = time.time_ns()
        else:
            self._ns = None
        _open.append(self.name)
        if self.device is not None:
            self._ev = torch.cuda.Event(enable_timing=True)
            self._ev.record(torch.cuda.current_stream(self.device))
        self._t0 = _perf_counter()
        return self

    def __exit__(self, *exc):
        dt = _perf_counter() - self._t0
        t = _totals.get(self.name)
        if t is None:
            t = _totals[self.name] = _Total()
        t.count += 1
        t.host_s += dt
        if self.device is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            if t.device is None:
                t.device = Tally()
            t.device.add_events(self._ev, end)
            for tally in self.into:
                tally.add_events(self._ev, end)
        else:
            for tally in self.into:
                tally.add_host(dt)
        _open.pop()
        if self._ns is not None:
            _intervals.append((self.name, self._parent, self._ns,
                               time.time_ns()))
            if self._nvtx:
                torch.cuda.nvtx.range_pop()
        return False


def set_counter(name: str, value) -> None:
    """Set the counter ``name`` to ``value``, an int or a 0-d tensor on
    any device; a tensor is not read (nor waited for) until
    :func:`report`."""
    _counters[name] = value


def _launch_counters() -> dict:
    """The launch counters of kernels A and B (both modes)."""
    from ecwam_tpu_torch.ops import propagation_cuda as pcu
    from ecwam_tpu_torch.ops.physics import implsch_cuda as ipk
    return {"advect.launches": pcu.advect.launches,
            "implsch_srl.launches": ipk.implsch_srl.launches,
            "implsch_srl.full_launches": ipk.implsch_srl.full_launches}


def report() -> dict:
    """``totals``: name → count, host seconds and device seconds (None
    for a span without a CUDA device), the device time waited for;
    ``intervals``: the (name, parent, start_ns, end_ns) recorded while
    tracing; ``counters``: the launch counters of kernels A and B and
    those of :func:`set_counter`, as ints (None where unset)."""
    totals = {n: dict(count=t.count, host_s=t.host_s,
                      device_s=None if t.device is None
                      else t.device.seconds)
              for n, t in _totals.items()}
    counters = _launch_counters()
    counters.update({k: None if v is None else int(v)
                     for k, v in _counters.items()})
    return dict(totals=totals, intervals=list(_intervals),
                counters=counters)


def write_chrome(path: str) -> None:
    """:func:`report`'s intervals as complete events of a Chrome trace
    (µs since the epoch), its totals and counters under ``otherData``."""
    rep = report()
    pid = os.getpid()
    events = [dict(name=n, cat="ecwam", ph="X", ts=s * 1e-3,
                   dur=(e - s) * 1e-3, pid=pid, tid=0,
                   args={} if p is None else {"parent": p})
              for n, p, s, e in rep["intervals"]]
    with open(path, "w") as f:
        json.dump(dict(traceEvents=events, displayTimeUnit="ms",
                       otherData=dict(totals=rep["totals"],
                                      counters=rep["counters"])), f)
