#!/usr/bin/env python3
"""The program's spans (`utils/profiling.span`) on the card: what they
cost, whether they share the device trace's clock, and how much of the
device's idle time they cover.

  * cost: `with span(...)` entered and left 200,000 times with no profiler
    recording and 20,000 times under one, microseconds each (the loop's
    own cost beside it);
  * the robot tick of the benchmark's `all_1728.tick_nap` cell (its set-up
    from `benchmark/harness/entries/tick.py`): the host's time to launch
    a tick's two replays with no profiler; `--ticks` ticks traced as the
    benchmark traces them, spans on and spans off (each module's `span`
    swapped for the shared no-op), in turn, twice; per traced tick the
    host ms, and for the runs with spans the share of ticks whose device
    ops (found by the correlation id of the replay that issued them)
    start after the tick's `tick.launch` starts and end before its
    `tick.wait` ends, within 5 us, with the two clocks' checks apart
    (`aligned`); each span's self ms and device-idle ms a tick, and the
    idle under no span;
  * a whole job of the `all_1728.train` cell, traced likewise: its host
    seconds with spans and without, the same split a job, and the CUDA
    runtime's allocation calls by span.

Needs one NVIDIA card; prints a JSON line per measurement and writes them
all to `--out`:

    python3 scripts/torch_span_probe.py [--seed 7] [--ticks 300] \
        [--out chiprun_out/span_probe.json]
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness import manifest as mf  # noqa: E402
from benchmark.harness import trace as bt  # noqa: E402
from benchmark.metrics import _spans  # noqa: E402
from icra2021_multimodal_ad_tpu_torch import train  # noqa: E402
from icra2021_multimodal_ad_tpu_torch.data import streaming  # noqa: E402
from icra2021_multimodal_ad_tpu_torch.utils import profiling  # noqa: E402

OUT: list = []
SLACK_US = 5.0


def emit(**kw) -> None:
    OUT.append(kw)
    print(json.dumps(kw), flush=True)


def span_cost() -> None:
    from torch.profiler import ProfilerActivity, profile

    def per_call_us(n, body):
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        return (time.perf_counter() - t0) / n * 1e6

    def entered():
        with profiling.span("tick.stage"):
            pass

    def empty():
        pass

    emit(what="span_cost", off_us=per_call_us(200_000, entered),
         loop_us=per_call_us(200_000, empty))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = per_call_us(20_000, entered)
    emit(what="span_cost", on_us=on)


@contextlib.contextmanager
def spans_off():
    """The tick's and the trainer's spans swapped for the shared no-op."""
    saved = streaming.span, train.span
    streaming.span = train.span = lambda name: profiling._OFF
    try:
        yield
    finally:
        streaming.span, train.span = saved


def traced(work):
    """`work()` traced as the benchmark's window traces it; (the reduced
    `Trace`, the profiler's events, the window's host seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out = bt.Trace()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(bt.PAD_S)
        t0 = time.perf_counter()
        with record_function(bt.WINDOW):
            work()
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        time.sleep(bt.PAD_S)
    bt._reduce(prof, out)
    return out, prof.events(), seconds


def split(trace, per: str) -> dict:
    """Per span: count, self ms and device-idle ms per `per` span; the idle
    under no span, and the total."""
    st = _spans.stats(trace)
    n = st[per][0]
    idle = sum(d for _, d in trace.idle_gaps)
    under = sum(v[2] for v in st.values())
    return {"per": n,
            "spans": {k: {"count": c, "self_ms": 1e3 * s / n,
                          "idle_ms": 1e3 * i / n}
                      for k, (c, s, i) in sorted(st.items())},
            "idle_ms": 1e3 * idle / n,
            "idle_no_span_ms": 1e3 * (idle - under) / n,
            "idle_no_span_share": (idle - under) / idle if idle else None,
            "idle_share": 1 - trace.busy_s / trace.window_s}


def deciles(xs) -> list:
    return statistics.quantiles(xs, n=10) if len(xs) > 1 else list(xs)


def aligned(events) -> dict:
    """Per `tick` span: its device ops are those of the replays launched
    inside its `tick.launch` (by correlation id); the share of ticks whose
    first op starts no earlier than 5 us before `tick.launch` starts and
    whose last op ends no later than 5 us after its `tick.wait` ends.
    Beside it, the two clocks apart: the graph launches (CUDA runtime
    calls, on the host's clock) outside every `tick.launch` span, and each
    replay's first device op against its own launch call, which it cannot
    precede."""
    from torch.autograd import DeviceType

    def rng(e):
        return e.time_range.start, e.time_range.end

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ticks = sorted(rng(e) for e in cpu if e.name == "tick")
    launches = sorted(rng(e) for e in cpu if e.name == "tick.launch")
    waits = sorted(rng(e) for e in cpu if e.name == "tick.wait")
    graph = {e.id: rng(e) for e in cpu if e.name == "cudaGraphLaunch"}
    ops = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.id in graph:
            ops.setdefault(e.id, []).append(rng(e))
    outside = sum(not any(a <= s and t <= b for a, b in launches)
                  for s, t in graph.values())
    after_call = [min(r[0] for r in ops[c]) - graph[c][0] for c in ops]
    good, leads, lags = 0, [], []
    for t0, t1 in ticks:
        launch = next(r for r in launches if t0 <= r[0] <= t1)
        wait = next(r for r in waits if t0 <= r[0] <= t1)
        mine = [r for c, (start, _) in graph.items()
                if launch[0] <= start <= launch[1] for r in ops.get(c, [])]
        if not mine:
            continue
        leads.append(min(r[0] for r in mine) - launch[0])
        lags.append(wait[1] - max(r[1] for r in mine))
        good += leads[-1] >= -SLACK_US and lags[-1] >= -SLACK_US
    return {"ticks": len(ticks), "with_ops": len(leads), "aligned": good,
            "share": good / len(ticks) if ticks else None,
            "lead_us_deciles": deciles(leads),
            "lag_us_deciles": deciles(lags),
            "lead_us_first_last_10": [statistics.mean(leads[:10]),
                                      statistics.mean(leads[-10:])]
            if leads else None,
            "graph_launches": len(graph),
            "launches_outside_their_span": outside,
            "op_after_its_launch_us_deciles": deciles(after_call),
            "ops_before_their_launch": sum(d < -SLACK_US
                                           for d in after_call)}


def runtime_by_span(trace) -> dict:
    """Seconds of the CUDA runtime's allocation calls a job, by the
    innermost program span each starts in."""
    pieces = _spans._pieces(_spans._spans(trace))
    starts = [p[0] for p in pieces]
    out: dict = {}
    for name, start, d in trace.host_ops:
        if name not in ("cudaMalloc", "cudaFree", "cudaHostAlloc",
                        "cudaFreeHost"):
            continue
        i = bisect.bisect_right(starts, start) - 1
        owner = (pieces[i][2] if i >= 0 and start < pieces[i][1]
                 else "no span")
        key = f"{owner}:{name}"
        out[key] = out.get(key, 0.0) + d
    return out


def launch_us(e, n: int = 300) -> list:
    """Deciles of the host's us to launch a tick's two replays with no
    profiler running, each pair launched onto an idle card."""
    det = e.detector
    mfcc = next(iter(det._mfcc_programs.values()))
    prog = next(iter(det._bundle_and_programs()[1].values()))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        mfcc.launch(0)
        prog.launch(0)
        times.append((time.perf_counter() - t0) * 1e6)
        prog.wait(0)
    return deciles(times)


def entry(cell: str, seed: int):
    manifest = mf.Manifest(ROOT)
    w = manifest.cell(cell)
    config, traffic = manifest.config(w), mf.traffic(w["traffic"])
    return mf.entry(traffic["entry"])(config, traffic, seed, "cuda"), traffic


def tick(seed: int, n: int) -> None:
    e, _ = entry("all_1728.tick_nap", seed)
    e._ticks(100)
    emit(what="tick_launch_untraced", us_deciles=launch_us(e))
    for rnd, on in enumerate((True, False, False, True)):
        with (contextlib.nullcontext() if on else spans_off()):
            trace, events, seconds = traced(lambda: e._ticks(n))
        row = {"what": "tick", "round": rnd, "spans": on,
               "host_ms_per_tick": 1e3 * seconds / n,
               "device_ms_per_tick": 1e3 * trace.busy_s / n,
               "idle_share": 1 - trace.busy_s / trace.window_s}
        if on:
            row["split"] = split(trace, "tick")
            row["clock"] = aligned(events)
        emit(**row)


def job(seed: int) -> None:
    e, _ = entry("all_1728.train", seed)
    for rnd, on in enumerate((True, False, False, True)):
        with (contextlib.nullcontext() if on else spans_off()):
            trace, _, seconds = traced(e._job)
        row = {"what": "train", "round": rnd, "spans": on,
               "host_s_per_job": seconds,
               "device_s_per_job": trace.busy_s,
               "idle_share": 1 - trace.busy_s / trace.window_s}
        if on:
            row["split"] = split(trace, "train.job")
            row["allocations_s"] = runtime_by_span(trace)
        emit(**row)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--ticks", type=int, default=300)
    p.add_argument("--out", default=os.path.join("chiprun_out",
                                                 "span_probe.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 3
    from benchmark.harness.cli import card_line

    emit(what="card", card=card_line())
    span_cost()
    tick(args.seed, args.ticks)
    job(args.seed)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(OUT, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
