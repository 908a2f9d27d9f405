"""Reading the profiler's trace of a window.

The traced window runs under ``torch.profiler`` with the harness's
spans (``record_function`` named ``wb.<layer>``) around each call into a
layer.  From the profiler's events this module takes the device
operations (kernels, copies, sets) with their launch's host time, and
the spans.  A device operation belongs to the innermost span that holds
the host event it was launched under; an idle gap of the device to the innermost span the host was in
when the gap began.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

SPAN_PREFIX = "wb."


@dataclasses.dataclass
class Op:
    name: str
    start: float      # device µs
    dur: float
    span: str         # innermost harness span of its launch, or ""


@dataclasses.dataclass
class Trace:
    ops: list
    spans: list       # (name, start µs, end µs), host
    window: tuple     # (start µs, end µs) of the wb.window span

    def busy_us(self) -> float:
        """The union of the device operations' intervals in the window."""
        return sum(e - s for s, e in self.busy_intervals())

    def busy_intervals(self) -> list:
        w0, w1 = self.window
        iv = sorted((max(o.start, w0), min(o.start + o.dur, w1))
                    for o in self.ops)
        out = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def idle_gaps(self) -> list:
        """(host span at the gap's start, µs) of each idle stretch of the
        device inside the window."""
        w0, w1 = self.window
        busy = self.busy_intervals()
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        out = []
        for i in range(0, len(edges), 2):
            s, e = edges[i], edges[i + 1]
            if e > s:
                out.append((self.span_at(s), e - s))
        return out

    def span_at(self, t: float) -> str:
        """The innermost harness span that contains host time ``t``."""
        best, width = "", float("inf")
        for name, s, e in self.spans:
            if s <= t <= e and e - s < width and name != "window":
                best, width = name, e - s
        return best

    def kernels(self, match) -> tuple[float, int]:
        """(device µs, count) of the operations whose name ``match``es."""
        ev = [o for o in self.ops if match(o.name)]
        return sum(o.dur for o in ev), len(ev)


def from_profiler(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile``, from its events
    in memory (nothing is written to disk)."""
    cuda = torch.autograd.DeviceType.CUDA
    return build((e.device_type() == cuda, e.name(), e.start_ns() * 1e-3,
                  e.duration_ns() * 1e-3, e.correlation_id(),
                  e.linked_correlation_id())
                 for e in prof.profiler.kineto_results.events())


def build(events) -> Trace:
    """The trace of ``events``: (on the device, name, start µs, duration
    µs, correlation id, linked correlation id).  A device operation's
    linked id is the correlation id of the host event it was launched
    under (an operator, or the innermost ``record_function``); the
    harness's spans are the host events named ``wb.<name>``, one
    ``wb.window`` among them."""
    host = {}
    spans, dev = [], []
    for on_dev, name, start, dur, corr, linked in events:
        if on_dev:
            if not name.startswith(SPAN_PREFIX):
                dev.append((name, start, dur, linked))
            continue
        host[corr] = start
        if name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], start, start + dur))
    window = next(((s, e) for n, s, e in spans if n == "window"), None)
    if window is None:
        raise ValueError("the trace has no wb.window span")
    inner = sorted((s, e, n) for n, s, e in spans if n != "window")
    starts = [s for s, _, _ in inner]

    def span_of(t):
        if t is None:
            return ""
        best, width = "", float("inf")
        i = bisect.bisect_right(starts, t)
        # spans nest, so the innermost is among the last few that start
        # before t
        for s, e, n in reversed(inner[max(0, i - 64):i]):
            if s <= t <= e and e - s < width:
                best, width = n, e - s
        return best

    ops = [Op(n, s, d, span_of(host.get(c))) for n, s, d, c in dev
           if window[0] <= s <= window[1]]
    return Trace(ops=ops, spans=spans, window=window)
