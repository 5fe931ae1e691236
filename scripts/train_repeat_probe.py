"""Times the port's training jobs on the card as a one-worker sweep and the
train CLI run them, at the CLI's default configuration (`all_1728` of the
benchmark: All sensors, 1728 -> 100, batch 7000, 20 epochs, lr 1e-3).

The port's `sweep.main` runs with one worker over `--seeds`, each grid
point `sweep.run_one`: a `NoveltyDetecter.train` job (fused, as the sweep's
verbose 0 trains) and its BASE/SAP/NAP test.  The data loaders are replaced
by seeded in-memory fused windows of the configuration's split sizes
(29,400 / 9,800 / 16,800, drawn by `benchmark/harness/inputs.py`), so no
ETL and no feature cache is timed.  One seed is one point, as the CLI's one
job in a process of its own.  Prints one JSON line per point: the train
job's and the test's seconds (the device synchronized around each), the
kept programs' hits and misses so far, and the memory the process holds
reserved when the test starts.

    python scripts/train_repeat_probe.py --seeds 11,12,13,14,15
    python scripts/train_repeat_probe.py --device cpu --scale 0.002 \
        --grid '{"n_layers": [2], "btl_size": [3], "n_epochs": [3]}'
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark.harness import inputs  # noqa: E402
from icra2021_multimodal_ad_tpu_torch import sweep, train  # noqa: E402
from icra2021_multimodal_ad_tpu_torch.data import dataset  # noqa: E402

#: train, valid and test rows of the CLI's 56,000-row slice
SPLITS = {"train": 29400, "valid": 9800, "test": 16800}
TEST_ANOMALY_SHARE = 0.3


class _Windows:
    """The loaders' manager: each split's seeded windows and labels."""

    def __init__(self, cfg, device, splits):
        self.splits = {}
        for name, n in splits.items():
            share = TEST_ANOMALY_SHARE if name == "test" else 0.0
            x, y = inputs.fused_windows(n, cfg.input_size, cfg.seed, name,
                                        device, anomaly_share=share)
            self.splits[name] = (x, y.long())

    def get_transformed_data(self, name):
        return self.splits[name]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, rows, key):
    def run(self, *args, **kw):
        _sync(self.device)
        if key == "test_s" and self.device.type == "cuda":
            rows[-1]["reserved_gb_at_test"] = (
                torch.cuda.memory_reserved(self.device) / 2 ** 30)
        t0 = time.perf_counter()
        out = fn(self, *args, **kw)
        _sync(self.device)
        rows[-1][key] = time.perf_counter() - t0
        return out
    return run


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=str, default="11,12,13,14,15")
    p.add_argument("--out", type=str, default="chiprun_out/probe_sweep.csv")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--scale", type=float, default=1.0,
                   help="share of each split's rows to draw")
    p.add_argument("--grid", type=str, default="{}",
                   help="JSON of further grid fields, for a small dry run")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    splits = {k: max(int(n * args.scale), 8) for k, n in SPLITS.items()}

    def loaders(cfg, device="cuda", **_):
        return _Windows(cfg, device, splits), "train", "valid", "test"

    rows = []
    det = train.NoveltyDetecter
    det.train = _timed(det.train, rows, "train_s")
    det.test = _timed(det.test, rows, "test_s")
    run_one = sweep.run_one

    def point(overrides, device="cuda"):
        rows.append({"seed": overrides["seed"]})
        t0 = time.perf_counter()
        out = run_one(overrides, device=device)
        programs = getattr(train, "PROGRAMS", None)
        rows[-1].update(point_s=time.perf_counter() - t0,
                        hits=getattr(programs, "hits", None),
                        misses=getattr(programs, "misses", None),
                        valid_loss=out["valid_loss"],
                        nap_auroc=out["nap_auroc"])
        print(json.dumps(rows[-1]), flush=True)
        return out

    dataset.get_loaders = loaders
    sweep.run_one = point
    grid = {**json.loads(args.grid), "seed": seeds, "feature_cache": [0]}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    t0 = time.perf_counter()
    sweep.main(["--grid", json.dumps(grid), "--out", args.out,
                "--max_workers", "1"], device=args.device)
    name = (torch.cuda.get_device_name() if args.device.startswith("cuda")
            else args.device)
    print(json.dumps({"sweep_s": time.perf_counter() - t0,
                      "points": len(rows), "device": name}), flush=True)


if __name__ == "__main__":
    main()
