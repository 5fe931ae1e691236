"""One run of one cell: set-up, the timed window (or the traced one), the
import check, the reference check, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line on standard output is the result object; the numbers that
decide `correct` are the last lines on standard error and the result's
last key.  A run without a card, or with fewer cards than the cell asks
for, prints no result and exits with 3.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Optional

#: top-level module names the run's process may not hold once the window
#: has closed: JAX and the package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "icra2021_multimodal_ad_tpu")


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names among the loaded modules, each name
    compared whole (the port's own name starts with the JAX package's)."""
    names = modules if modules is not None else list(sys.modules)
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


@dataclass
class Readings:
    """What a per-layer metric's `read(ctx)` may read: the cell's
    configuration and traffic, the traced window (`trace`, and `units`:
    the work it ran), and the timed window's readings (`window`)."""

    config: dict
    traffic: dict
    trace: object
    units: dict
    window: dict


def run_cell(manifest, name: str, seed: int, seconds: float, trace: bool,
             device, started_s: float, sizes: Optional[dict] = None
             ) -> Optional[dict]:
    """One run of cell `name`; the result object, or None (and the reason
    on standard error) where the run may print none.  `started_s`: the
    host clock (`time.perf_counter`) when the process started.  `sizes`
    ({"config": {...}, "traffic": {...}}) shrinks the cell for the CPU
    tests; a benchmark run passes none."""
    import torch

    from benchmark.harness import manifest as mf
    from benchmark.harness.trace import traced

    cell = manifest.cell(name)
    config, traffic = manifest.config(cell), mf.traffic(cell["traffic"])
    config.update((sizes or {}).get("config", {}))
    traffic.update((sizes or {}).get("traffic", {}))
    limits = mf.limits(name)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    started_entry = time.perf_counter()
    entry = mf.entry(traffic["entry"])(config, traffic, seed, device)
    setup_s = time.perf_counter() - started_s
    ends = entry.window(seconds)
    ends["setup_s"] = setup_s
    result = {"correct": False, "attempted": int(ends["attempted"]),
              "failed": int(ends["failed"])}
    if trace:
        with traced(device) as tr:
            units = entry.traced()
        ctx = Readings(config, traffic, tr, units, entry.readings())
        metrics = {}
        for m in manifest.per_layer(cell):
            value = mf.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(ends[m["name"]]),
                               "unit": m["unit"]}
                   for m in manifest.end_to_end(cell)}
    bad = forbidden_modules()
    if bad:
        print(f"the run's process holds {bad}: the benchmark runs the port "
              f"alone", file=sys.stderr)
        return None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print("bench-info " + json.dumps(
        {"cell": name, "seed": seed, "card": card_line() if cuda else "cpu",
         "window": {k: v for k, v in entry.readings().items()
                    if not isinstance(v, list)},
         "start_to_entry_s": started_entry - started_s,
         "end_to_end": ends}), flush=True)
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = entry.check(limits)
    result["correct"] = bool(checks) and all(c.ok for c in checks)
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def main(argv, started_s: float, root: str) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness.manifest import Manifest

    manifest = Manifest(root)
    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell["chips"])):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"host has {have}", file=sys.stderr)
        return 3
    result = run_cell(manifest, args.workload, args.seed % (1 << 63),
                      args.seconds, bool(args.trace), "cuda", started_s)
    if result is None:
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
