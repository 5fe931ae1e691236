"""Read a cell's numbers for its limits: the program's, the control's and
the faults', seed by seed, on the card at the cell's own sizes.

    python3 benchmark/controls/control.py --workload all_1728.tick_nap \
        --seeds 11,12,13 --what program,tf32 [--seconds 3] [--diagnose]

`--what`: `program` (the program's own numbers after a short window at the
cell's load, as a run compares them), `tf32` (the plain reference in fp32
with TF32 products, put in the program's place), `float32` (the same with
TF32 off), `tf32_ae` (tick cells: the frontend in fp32, the autoencoder
and its score in TF32), `e4m3` (the bf16 tick: the frontend in fp32, the
float64 whitening, the autoencoder and the NAP score on e4m3 operands;
`benchmark/reference/precision.py`), `fault:<stale|half_batch|altered>`
(training: the reference in fp32 with the fault planted),
`planted:<fault>` (training: the program
with a fault of `benchmark/controls/faults.py` planted in its replayed
epochs, a set-up and window of its own).  Each seed is one set-up; every
number goes to standard output as one JSON line.  `--diagnose` adds, for
training, each epoch's gap of the program and the reference's lower
precisions; for NAP, the whitening gap of the program's fit and of each
control's at several cuts.  The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import manifest as mf  # noqa: E402


#: the cuts, relative to the largest variance, at which `--diagnose` reads
#: the NAP whitening gaps
CUTS = (1e-2, 1e-3, 1e-4, 1e-5, 1e-6)


def diagnose_nap(entry, controls) -> dict:
    """NAP: at each cut, the largest |entry| and the largest diagonal gap
    of `whitened_cov - I`, of the program's fit and of each control's."""
    from benchmark.reference import nap

    ref = entry.reference()["fit"]
    fits = {"program": entry.prog_stats}
    fits.update((c, entry.reference(c)["fit"]) for c in controls)
    out = {}
    for name, fit in fits.items():
        a = nap.whitened_cov(fit, ref, min(CUTS))
        a.diagonal().sub_(1.0)
        var = ref["raw_var"].double()
        n_above = [int((var > c * var.max()).sum()) for c in CUTS]
        out[name] = {f"{c:g}": [float(a[:m, :m].abs().max()),
                                float(a.diagonal()[:m].abs().max()), m]
                     for c, m in zip(CUTS, n_above)}
    return out


def diagnose(entry, controls=("tf32",)) -> dict:
    """Training: each epoch's relative gap of the program's and the
    reference's lower precisions to float64, and the float64 histories;
    NAP: `diagnose_nap`."""
    from benchmark.harness.entries import train

    if not isinstance(entry, train.Entry):
        if getattr(entry, "prog_stats", None) is None:
            return {}
        return diagnose_nap(entry, controls)
    base = entry.reference()
    series = {"program": entry.last}
    for name in ("float32", "tf32"):
        series[name] = entry.reference(name)
    out = {name: {k: [abs(a - b) / b for a, b in zip(r[k], base[k])]
                  for k in ("train_history", "valid_history")}
           for name, r in series.items()}
    out["float64"] = {k: base[k] for k in ("train_history", "valid_history")}
    out["best_epoch"] = base["best_epoch"]
    return out


def run_entry(traffic: dict, config: dict, seed: int, seconds: float,
              device: str = "cuda"):
    """The cell's entry on `device`, set up, run for `seconds` and its
    program state released, ready for its checks."""
    entry = mf.entry(traffic["entry"])(config, traffic, seed, device)
    entry.window(seconds)
    entry.release()
    gc.collect()
    torch.cuda.empty_cache()
    return entry


def emit(cell: str, seed: int, what: str, checks) -> None:
    print(json.dumps({"cell": cell, "seed": seed, "what": what,
                      **{c.name: c.value for c in checks}}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program,tf32")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--diagnose", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    manifest = mf.Manifest(ROOT)
    cell = manifest.cell(args.workload)
    config = manifest.config(cell)
    traffic = mf.traffic(cell["traffic"])
    limits = mf.limits(args.workload)
    whats = args.what.split(",")
    planted = [w for w in whats if w.startswith("planted:")]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if len(planted) < len(whats):
            entry = run_entry(traffic, config, seed, args.seconds,
                              args.device)
            for what in whats:
                if what in planted:
                    continue
                checks = (entry.check(limits) if what == "program"
                          else entry.control(limits, what))
                emit(args.workload, seed, what, checks)
            if args.diagnose:
                controls = [w for w in whats
                            if w in ("tf32", "float32", "tf32_ae", "e4m3")]
                print(json.dumps({"cell": args.workload, "seed": seed,
                                  "diagnose": diagnose(entry, controls)}),
                      flush=True)
            del entry
            gc.collect()
            torch.cuda.empty_cache()
        for what in planted:
            from benchmark.controls.faults import planted as plant

            with plant(what.split(":", 1)[1]):
                entry = run_entry(traffic, config, seed, args.seconds,
                                  args.device)
            emit(args.workload, seed, what, entry.check(limits))
            del entry
            gc.collect()
            torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
