"""Intervals read on the card's clock.

A CUDA event recorded on a stream with no work queued completes when the
host records it, so two such events time the host's interval between them
on the device's clock, to about a microsecond; an event behind queued work
completes when that work does.  On the CPU, which only the tests use, the
host clock stands in.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class Stopwatch:
    """One interval at a time: `start()`, `stop()`, then `read_ms()` (which
    waits for the end) before the next `start()`."""

    def __init__(self, device):
        self._cuda = torch.device(device).type == "cuda"
        if self._cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
        self._t: Optional[float] = None

    def start(self) -> None:
        if self._cuda:
            self._a.record()
        else:
            self._t = time.perf_counter()

    def stop(self) -> None:
        if self._cuda:
            self._b.record()
        else:
            self._t = (time.perf_counter() - self._t) * 1e3

    def read_ms(self) -> float:
        if self._cuda:
            self._b.synchronize()
            return self._a.elapsed_time(self._b)
        return self._t


class Marks:
    """Events recorded behind queued work, read once it has all finished:
    device milliseconds between consecutive pairs."""

    def __init__(self, device):
        self._cuda = torch.device(device).type == "cuda"
        self._marks = []

    def mark(self):
        if self._cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self._marks.append(e)
        else:
            self._marks.append(time.perf_counter())

    def spans_ms(self, pairs):
        """Milliseconds of each (start index, end index) pair."""
        if self._cuda:
            torch.cuda.synchronize()
            return [self._marks[a].elapsed_time(self._marks[b])
                    for a, b in pairs]
        return [(self._marks[b] - self._marks[a]) * 1e3 for a, b in pairs]


class SetupSpans:
    """Host seconds of named set-up stages, each closed by a synchronize
    with the device so it holds its own device work."""

    def __init__(self, device):
        self._cuda = torch.device(device).type == "cuda"
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._cuda:
                torch.cuda.synchronize()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
