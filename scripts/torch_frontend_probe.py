"""Read the robot tick's front end (normalize and fuse) off a traced window
of one of the benchmark's tick cells.

Builds the cell as `benchmark/run.py` does (set-up and warm-up ticks), then
traces the traffic's `trace_ticks` ticks with `benchmark/harness/trace.py`.
In the trace's device ops, in time order, a tick's front end is every op
after the last host-to-device copy (the tick program's staged payloads)
that precedes an FC kernel (`benchmark/metrics/_kernels.FC`), up to that
kernel; FC kernels with no copy since the one before (the tick's later
passes) start none.  Prints one JSON line: the medians over the ticks of
the front end's device ms, its op count and its span (the copy's end to
the FC kernel's start, node gaps included), the window's busy device ms a
tick, and the front end's ops summed by name.  On the card, from the root
of the checkout to read (its port and its benchmark are the ones run):

    python3 scripts/torch_frontend_probe.py --workload all_1728.tick_base --seed 7
"""

import argparse
import json
import os
import statistics
import sys


def front_ends(device_ops, is_fc):
    """[[(name, seconds), ...] of each tick's front end, span seconds] from
    device ops (name, start s, seconds) in time order."""
    out, copy_end, ops = [], None, []
    for name, start, seconds in device_ops:
        if name.startswith("Memcpy HtoD"):
            copy_end, ops = start + seconds, []
        elif is_fc(name):
            if copy_end is not None:
                out.append((ops, start - copy_end))
            copy_end, ops = None, []
        elif copy_end is not None:
            ops.append((name, seconds))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="all_1728.tick_base")
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    root = os.getcwd()
    sys.path.insert(0, root)
    import torch

    from benchmark.harness import manifest as mf
    from benchmark.harness.trace import traced
    from benchmark.metrics._kernels import FC

    manifest = mf.Manifest(root)
    cell = manifest.cell(args.workload)
    config, traffic = manifest.config(cell), mf.traffic(cell["traffic"])
    if traffic["entry"] != "tick":
        raise SystemExit(f"{args.workload} is not a tick cell")
    entry = mf.entry("tick")(config, traffic, args.seed, "cuda")
    with traced(torch.device("cuda")) as tr:
        ticks = entry.traced()["ticks"]
    found = front_ends(tr.device_ops, FC)
    by_name = {}
    for ops, _ in found:
        for name, seconds in ops:
            by_name[name[:100]] = by_name.get(name[:100], 0.0) + seconds
    n = max(len(found), 1)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "root": root,
        "card": torch.cuda.get_device_name(0), "ticks": ticks,
        "front_ends_found": len(found),
        "front_end_device_ms": 1e3 * statistics.median(
            sum(s for _, s in ops) for ops, _ in found) if found else None,
        "front_end_ops": statistics.median(
            len(ops) for ops, _ in found) if found else None,
        "front_end_span_ms": 1e3 * statistics.median(
            span for _, span in found) if found else None,
        "busy_ms_per_tick": 1e3 * tr.busy_s / ticks,
        "ops_by_name_ms_per_tick": {
            k: 1e3 * v / n for k, v in sorted(by_name.items(),
                                              key=lambda kv: -kv[1])}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
