"""The traced window: a `torch.profiler` trace of the card's activity over a
fixed amount of work, reduced to device intervals in memory.

A copy of the port's `utils/profiling.trace`, with its pad: the profiler
moves the card's timestamps onto the host clock and drops the device events
that land outside its window, so the block is wrapped in `PAD_S` of quiet
on both sides.  The window itself is a `record_function` span around the
work and its final synchronize; every device event (kernel, copy, set) is
clipped to it.  Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

PAD_S = 0.05
WINDOW = "benchmark.window"


@dataclass
class Trace:
    """Device ops as (name, start_s, seconds), host ops likewise, both from
    the window's start; `window_s` its length, `busy_s` the union of the
    device ops, `idle_gaps` the gaps between them as (start_s, seconds)."""

    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    window_s: float = 0.0
    busy_s: float = 0.0
    idle_gaps: List[Tuple[float, float]] = field(default_factory=list)

    def kernel_seconds(self, matches) -> Tuple[float, int]:
        """(device seconds, count) of the ops whose name `matches`."""
        hits = [d for n, _, d in self.device_ops if matches(n)]
        return sum(hits), len(hits)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device ops that took most time, summed by name, and the
        longest idle gaps summed by the host op that was running through
        them (the innermost one at the gap's middle)."""
        by_op: Dict[str, float] = {}
        for name, _, d in self.device_ops:
            by_op[name] = by_op.get(name, 0.0) + d
        host = sorted((s, s + d, n) for n, s, d in self.host_ops
                      if n != WINDOW)
        starts = [h[0] for h in host]
        by_host: Dict[str, float] = {}
        for start, d in self.idle_gaps:
            label = _covering(host, starts, start + d / 2)
            by_host[label] = by_host.get(label, 0.0) + d
        def top_of(m):
            return [[n[:160], s] for n, s in
                    sorted(m.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_host)}


def _covering(host, starts, t: float, depth: int = 4096) -> str:
    """The name of the host op that started last among those running at
    `t` (the innermost of nested ops), looking back `depth` ops."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, i - depth):i]):
        if e >= t:
            return name
    return "host: no op"


def _on_device(event) -> bool:
    return str(event.device_type()).endswith("CUDA")


def _annotation(event) -> bool:
    """A span the profiler mirrors onto the device's timeline from a
    `record_function` (no device work of its own)."""
    if hasattr(event, "is_user_annotation") and event.is_user_annotation():
        return _on_device(event)
    return _on_device(event) and event.name() == WINDOW


def _ns(event, what: str) -> float:
    if hasattr(event, f"{what}_ns"):
        return float(getattr(event, f"{what}_ns")())
    return 1e3 * float(getattr(event, f"{what}_us")())


@contextlib.contextmanager
def traced(device: torch.device):
    """Trace the block on `device` (the card; the CPU in the tests, where
    the host ops stand in for nothing but the window).  Yields a `Trace`
    that is filled when the block ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    out = Trace()
    with profile(activities=activities) as prof:
        time.sleep(PAD_S if on_card else 0.0)
        with record_function(WINDOW):
            yield out
            if on_card:
                torch.cuda.synchronize(device)
        time.sleep(PAD_S if on_card else 0.0)
    _reduce(prof, out)


def _reduce(prof, out: Trace) -> None:
    events = [e for e in prof.profiler.kineto_results.events()
              if not _annotation(e)]
    window = [e for e in events if e.name() == WINDOW
              and not _on_device(e)]
    if not window:
        raise RuntimeError("the profiler lost the window's span")
    w0 = _ns(window[0], "start")
    w1 = w0 + _ns(window[0], "duration")
    out.window_s = (w1 - w0) / 1e9
    dev, host = [], []
    for e in events:
        start, dur = _ns(e, "start"), _ns(e, "duration")
        lo, hi = max(start, w0), min(start + dur, w1)
        if hi <= lo:
            continue
        item = (e.name(), (lo - w0) / 1e9, (hi - lo) / 1e9)
        if _on_device(e):
            dev.append(item)
        else:
            host.append(item)
    dev.sort(key=lambda t: t[1])
    out.device_ops, out.host_ops = dev, host
    busy, gaps, end = 0.0, [], 0.0
    for _, s, d in dev:
        if s > end:
            gaps.append((end, s - end))
        busy += max(0.0, s + d - max(s, end))
        end = max(end, s + d)
    if out.window_s > end:
        gaps.append((end, out.window_s - end))
    out.busy_s, out.idle_gaps = busy, gaps
