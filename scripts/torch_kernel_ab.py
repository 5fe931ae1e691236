#!/usr/bin/env python3
"""The port's two hand-written kernels in two trees, timed on one card.

    python3 scripts/torch_kernel_ab.py A_TREE B_TREE

A_TREE and B_TREE are checkouts of this repository, for example the parent
commit unpacked with `git archive` into a directory that .gitignore lists
(`build/parent`) and `.`.  The script runs one worker process per tree in
the order A, B, B, A.  Each worker imports that tree's package, so it
builds that tree's `csrc/` sources with that tree's `ops/_build.py`, and
prints one JSON line:

  * golden: the checked-in model, NAP stats and fixture windows scored in
    fp32 (`score_nap_windows`) twice, the max relative error against the
    frozen `nap_score` column (contract 2e-3), whether the two runs are
    bit-identical, and the bf16 bundle's Pearson against fp32;
  * kernel times (CUDA events, median of 25, L2 flushed before each call,
    host overhead kept out): `fused_mlp` 1728 -> 1402 at B = 10 and 7000
    and `nap_score` at B = 10 and 4096, K = 5482, J = 4096, in fp32 and
    bf16, and `nap_score` at the train-and-score shape B = 4096,
    K = J = 5482 in fp32;
  * `score_nap_windows` latency (host clock to a synchronize, median of 25)
    at B = 10 and 4096 in fp32 and bf16.

Weights and whitening stats are random from fixed seeds, at the canonical
widths (Config() defaults).  The last line sums up each number: the two
runs of A, the two of B, and mean(B) / mean(A).  Needs one NVIDIA card.
"""

from __future__ import annotations

import csv
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = 25
K, J = 5482, 4096


def device_ms(fn, flush) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(RUNS):
        flush.zero_()
        torch.cuda._sleep(200_000)  # the host queues fn before start fires
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def wall_ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def worker(tree: str) -> dict:
    """Every number of one tree; imports that tree's package."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from icra2021_multimodal_ad_tpu_torch.config import (
        Config,
        get_input_size,
    )
    from icra2021_multimodal_ad_tpu_torch.models.builder import (
        get_model,
        load_model,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
        mlp_pack,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_pack,
        nap_score,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.normalize import (
        RotaterStats,
        StandardizerStats,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
        NapStats,
        load_nap_stats,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.serving import (
        cast_floats,
        make_serving,
    )

    assert os.path.samefile(
        os.path.dirname(sys.modules["icra2021_multimodal_ad_tpu_torch"]
                        .__file__), os.path.join(tree,
                                                 "icra2021_multimodal_ad_"
                                                 "tpu_torch"))
    out = {"tree": os.path.abspath(tree)}

    golden = os.path.join(tree, "datasets", "golden")
    cfg, model = load_model(os.path.join(golden, "model"))
    stats = load_nap_stats(os.path.join(golden, "nap_stats.npz"))
    x = torch.from_numpy(np.load(os.path.join(
        golden, "fixture_windows.npz"))["x"]).cuda()
    with open(os.path.join(golden, "caltime_test.csv"), newline="") as f:
        col = np.array([float(r["nap_score"]) for r in csv.DictReader(f)])
    serving = make_serving(cfg, model, nap_stats=stats)
    s1, s2 = serving.score_nap_windows(x), serving.score_nap_windows(x)
    s16 = make_serving(cfg.replace(compute_dtype="bfloat16"), model,
                       nap_stats=stats).score_nap_windows(x)
    a = s1.double().cpu().numpy()
    out["golden_fp32_max_rel_err"] = float(np.max(np.abs(a - col) / col))
    out["golden_fp32_repeat_identical"] = bool(torch.equal(s1, s2))
    out["golden_bf16_pearson"] = float(np.corrcoef(
        a, s16.double().cpu().numpy())[0, 1])

    cfg = Config()
    cfg = cfg.replace(input_size=get_input_size(cfg))
    model = get_model(cfg, torch.Generator().manual_seed(cfg.seed))
    rng = np.random.default_rng(0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731

    def random_stats(k, j):
        return NapStats(
            RotaterStats(f32(rng.normal(size=k)),
                         f32(rng.normal(size=(k, j)) / np.sqrt(k))),
            StandardizerStats(f32(rng.normal(size=j)),
                              f32(rng.uniform(0.5, 2.0, j)))).to("cuda")

    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        m = model if dtype == torch.float32 else cast_floats(model, dtype)
        layer = mlp_pack(m.encoder, dtype).layers[0]
        for b in (10, 7000):
            xb = torch.randn(b, layer.w.shape[1], generator=g, device="cuda")
            if dtype == torch.bfloat16:
                xb = xb.to(dtype)
            out[f"fused_mlp_1728x1402_b{b}_{name}_ms"] = device_ms(
                lambda: fused_mlp_layer(layer, xb), flush)
    shapes = [("fp32", torch.float32, J, (10, 4096)),
              ("bf16", torch.bfloat16, J, (10, 4096)),
              ("fp32", torch.float32, K, (4096,))]
    for name, dtype, j, batches in shapes:
        pack = nap_pack(random_stats(K, j), dtype)
        for b in batches:
            xb = torch.randn(b, K, generator=g, device="cuda")
            out[f"nap_score_b{b}_k{K}_j{j}_{name}_ms"] = device_ms(
                lambda: nap_score(pack, xb), flush)
    stats = random_stats(K, J)
    req = torch.rand(4096, cfg.input_size, generator=g, device="cuda")
    for name in ("float32", "bfloat16"):
        serv = make_serving(cfg.replace(compute_dtype=name), model,
                            nap_stats=stats)
        for b in (10, 4096):
            out[f"score_nap_windows_b{b}_{name}_ms"] = wall_ms(
                lambda: serv.score_nap_windows(req[:b]))
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--worker":
        import torch

        if not torch.cuda.is_available():
            print("torch_kernel_ab: needs an NVIDIA card", file=sys.stderr)
            return 2
        print(json.dumps(worker(argv[2])), flush=True)
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    trees = {"A": os.path.abspath(argv[1]), "B": os.path.abspath(argv[2])}
    rows = {"A": [], "B": []}
    for label in "ABBA":
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             trees[label]],
            cwd=trees[label], capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout, res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": label, **row}), flush=True)
        rows[label].append(row)
    summary = {}
    for key in rows["A"][0]:
        a = [r[key] for r in rows["A"]]
        b = [r[key] for r in rows["B"]]
        summary[key] = {"A": a, "B": b}
        if all(isinstance(v, float) for v in a + b):
            summary[key]["B_over_A"] = statistics.mean(b) / statistics.mean(a)
    print(json.dumps({"nvidia_smi": smi, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
