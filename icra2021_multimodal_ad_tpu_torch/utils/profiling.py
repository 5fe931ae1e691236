"""Timing and tracing: the PyTorch counterpart of the JAX package's
`utils/profiling.py` (the reference's ad-hoc `time.time()` prints,
novelty_detection.py:216-221, utils/metric.py:208-224, FullTest.py:126-128,
realtime_tester.py:292-309).

  * `span`: a named host span of the program (the streaming tick's and the
    trainer's stages), recorded by whatever `torch.profiler` is running, on
    the timeline of the card's kernels and copies; with no profiler
    recording it is one shared no-op context.  The program keeps no span
    log: the profiler's holder does.
  * `timed`: a host-clock span that ends with `torch.cuda.synchronize` on
    the device it times, so it covers the device's work and not only its
    launch (a bare host clock around CUDA calls measures the launch; the
    reference's numbers had this flaw).
  * `timed_loop` and `timed_loop_stats`: a body run n times on the device
    with a carried tensor, timed with CUDA events; the fixed cost is taken
    out by differencing a 1-iteration run.
  * `trace`: a `torch.profiler` Chrome trace of the CPU and, on the card,
    the CUDA activity.

Every function times the card unless the caller asks for the CPU, where
the host clock stands in for the events; a CUDA device on a host without
CUDA raises (utils/device.py).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable

import torch

from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)


#: the context every span returns while no profiler is recording
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a span while a profiler is recording
    (`torch.profiler.record_function`), and otherwise the shared no-op
    context: no allocation and no clock read, so a span on the tick's path
    costs a check when nothing traces it.  Never place one inside a
    function that a `graphs.Program` captures: host code there does not
    run on a replay."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def timed(fn, *args, warmup: int = 1, iters: int = 10, device="cuda", **kw):
    """Mean host time of fn(*args) after `warmup` calls (first-call costs
    such as a kernel's build excluded), the span closed by a synchronize
    with `device`, so it covers the device's work."""
    dev = resolve_device(device)
    for _ in range(max(warmup, 0)):
        fn(*args, **kw)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    synchronize(dev)
    return (time.perf_counter() - t0) / iters


def retry(f, attempts: int = 3, wait_s: float = 20.0):
    """Retry a thunk across transient errors; the last one is re-raised."""
    last = None
    for i in range(attempts):
        try:
            return f()
        except Exception as e:  # noqa: BLE001 — re-raised after attempts
            last = e
            if i + 1 < attempts:
                time.sleep(wait_s)
    raise last


def _loop_harness(make_body: Callable, device):
    """The one timing method of timed_loop and timed_loop_stats: run(n)
    calls body(i, carry) n times from a zero scalar on the device, each
    iteration depending on the last; measure(n) times it with CUDA events
    (the host clock on the CPU) and synchronizes."""
    dev = resolve_device(device)

    def run(n: int) -> torch.Tensor:
        body = make_body()
        carry = torch.zeros((), device=dev)
        for i in range(n):
            carry = body(i, carry)
        return carry

    def measure(n: int) -> float:
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        float(run(n))
        return time.perf_counter() - t0

    return run, measure


def timed_loop_stats(make_body: Callable, n_iters: int = 20,
                     repeats: int = 3, device="cuda") -> dict:
    """Seconds per iteration as {"median_s", "min_s", "max_s", "samples"},
    each sample an independent PAIRED difference (tn_i - t1_i) / n_iters.

    A pair can come out non-positive when noise lands on its 1-iteration
    end.  Invalid pairs are discarded and re-measured (up to 2 * repeats
    extra), never clamped: a clamped 1e-9 would publish an absurd rate.
    If every pair is noise, the difference of the medians of all endpoints
    is the one sample, and if even that is not positive, this raises: no
    number is better than a fabricated one."""
    run, measure = _loop_harness(make_body, device)
    retry(lambda: measure(1))  # first calls: builds, caches
    retry(lambda: measure(n_iters + 1))
    samples, t1s, tns = [], [], []
    budget = 3 * max(repeats, 1)
    while len(samples) < max(repeats, 1) and budget > 0:
        budget -= 1
        t1 = retry(lambda: measure(1))
        tn = retry(lambda: measure(n_iters + 1))
        t1s.append(t1)
        tns.append(tn)
        if tn - t1 > 0:
            samples.append((tn - t1) / n_iters)
    if not samples:
        est = (statistics.median(tns) - statistics.median(t1s)) / n_iters
        if est <= 0:
            raise RuntimeError(
                f"timing not resolvable over the noise: every paired sample "
                f"and the median-endpoint difference came out non-positive "
                f"(t1s={[f'{t:.6f}' for t in t1s]}, "
                f"tns={[f'{t:.6f}' for t in tns]}); raise n_iters")
        samples = [est]
    return {
        "median_s": float(statistics.median(samples)),
        "min_s": float(min(samples)),
        "max_s": float(max(samples)),
        "samples": len(samples),
    }


def timed_loop(make_body: Callable, n_iters: int = 20, repeats: int = 3,
               device="cuda") -> float:
    """Seconds per iteration of the carried loop: the median of `repeats`
    (n_iters + 1)-iteration runs less the median of `repeats` 1-iteration
    runs, over n_iters; at least 1e-9, JAX's floor (timed_loop_stats
    re-measures instead)."""
    run, measure = _loop_harness(make_body, device)
    retry(lambda: measure(1))
    t1 = statistics.median(retry(lambda: measure(1))
                           for _ in range(max(repeats, 1)))
    retry(lambda: measure(n_iters + 1))
    tn = statistics.median(retry(lambda: measure(n_iters + 1))
                           for _ in range(max(repeats, 1)))
    return max((tn - t1) / n_iters, 1e-9)


#: seconds a trace on the card stays quiet before the block and after it.
#: The profiler moves the card's timestamps onto the host clock and drops
#: the device events that land outside its window; on the H100 that move
#: was seen up to 5.09 ms early, which dropped the block's first events;
#: with this pad none were lost in 80 profiles (CHANGES.md, the entry that
#: added the pad).
DEVICE_PAD_S = 0.05


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("build", "torch-trace"),
          device="cuda", pad_s: float = DEVICE_PAD_S):
    """A torch.profiler trace of the block, written as a Chrome trace to
    `log_dir`/trace.json: the CPU activity, and the CUDA activity when
    `device` is the card, with `pad_s` of quiet on either side of the
    block.  Yields the profiler (key_averages() sums the time by
    kernel)."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    else:
        pad_s = 0.0
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(pad_s)
        yield prof
        synchronize(dev)
        time.sleep(pad_s)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
