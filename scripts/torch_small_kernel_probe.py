#!/usr/bin/env python3
"""Where the time of the two small-batch kernels goes, from stamps inside
them.

    python3 scripts/torch_small_kernel_probe.py [--runs N]

Builds a copy of `csrc/nap_score.cu` and `csrc/fused_mlp.cu` with
-DSMALL_PROBE (`csrc/probe.cuh`) into build/small_probe/, where thread 0
of every block records %globaltimer at its entry, at every ring stage it
starts, before and after every grid sync and at its exit, and drives
variant 4 of each through the port's own wrappers (the stamped libraries
stand in for the built ones): the NAP score at K = 5482 and J = 400,
3370, 4096 and 5482 (the split-K path, the hand camera's and the robot's
ticks), and the canonical encoder (1728 -> ... -> 100, random BN stats),
each at B = 1, 10 and 32, the L2 flushed before each call.  A one-thread
kernel stamps the device clock just before each launch, with the host
queued ahead behind a sleep, so the gap to the first block's entry is the
launch's device-side cost.

Each shape prints one JSON line: the median over N runs (default 15) of
the critical path, which sums to the launch's time from the stamp to its
last block's exit:

  * `launch_us`: the stamp to the first block's entry;
  * `segments`: per stretch between grid syncs, the last block's arrival
    at the sync (or exit) less the first entry or the previous sync's
    release (`critical_us`), and the mean block's own time
    (`mean_block_us`), the mean time from a block's start of the stretch
    to its first ring stage (`prologue_us`), the mean time between its
    stages (`stage_us`) and the stages a block ran (`stages`);
  * `compute_us` and `fold_us`: over the whole launch, the mean time from
    a stage's start to its work items' end, and from there to the end of
    the owners' adds (the rest of a stage is the wait for the next);
  * `syncs`: per grid sync, the last arrival to the first release
    (`us`) and the spread of the arrivals (`arrival_spread_us`);
  * `epilogue_us`: the last release to the last exit;
  * `total_us`, and `device_ms` (CUDA events, the unstamped library, as
    chip_smoke.device_ms).

Needs one NVIDIA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PER_BLOCK = 2048
BS = (1, 10, 32)
NAP_K, NAP_J = 5482, (400, 3370, 4096, 5482)


def build_probe_libs() -> dict:
    """nvcc -DSMALL_PROBE copies of both libraries, built in parallel."""
    from icra2021_multimodal_ad_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "small_probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("nap_score", "fused_mlp"):
        out = os.path.join(out_dir, f"lib{name}_probe.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DSMALL_PROBE", "-o",
               out, str(_build.CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -DSMALL_PROBE failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(out)
        libs[name].small_probe_arm.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name].small_probe_stamp.argtypes = [ctypes.c_void_p] * 2
    return libs


def split(stamp_ns: int, marks: list) -> dict:
    """The critical path of one launch from its blocks' marks: marks[b] is
    block b's list of (t_ns, tag, aux)."""
    blocks = [m for m in marks if m]
    entry = [m[0][0] for m in blocks if m[0][1] == 1]
    exits = [m[-1][0] for m in blocks if m[-1][1] == 5]
    n_sync = max(sum(1 for _, tag, _ in m if tag == 3) for m in blocks)
    before = [[t for t, tag, _ in m if tag == 3] for m in blocks]
    after = [[t for t, tag, _ in m if tag == 4] for m in blocks]
    us = lambda ns: ns / 1e3  # noqa: E731
    out = {"blocks": len(blocks), "launch_us": us(min(entry) - stamp_ns)}
    segs, syncs, start = [], [], min(entry)
    starts = [m[0][0] for m in blocks]
    for k in range(n_sync + 1):
        ends = ([b[k] for b in before if len(b) > k] if k < n_sync
                else exits)
        mine = [(b[k] if k < n_sync else m[-1][0]) - s
                for b, m, s in zip(before, blocks, starts)
                if k == n_sync or len(b) > k]
        seg = {"critical_us": us(max(ends) - start),
               "mean_block_us": us(statistics.mean(mine))}
        ready = [[t for t, tag, _ in m if tag == 2 and t >= s
                  and (k == n_sync or t < b[k])]
                 for m, b, s in zip(blocks, before, starts)
                 if k == n_sync or len(b) > k]
        firsts = [r[0] - s for r, s in zip(ready, starts) if r]
        gaps = [y - x for r in ready for x, y in zip(r, r[1:])]
        # within a stage: ready -> its items computed (6) -> its totals
        # added (7); the rest of a gap is the wait for the next stage
        parts = {6: [], 7: []}
        for m in blocks:
            prev = None
            for t, tag, _ in m:
                if tag in (2, 6, 7):
                    if prev is not None and tag in parts and prev[1] == tag - (
                            4 if tag == 6 else 1):
                        parts[tag].append(t - prev[0])
                    prev = (t, tag)
        mean = lambda v: us(statistics.mean(v)) if v else None  # noqa: E731
        seg.update(prologue_us=mean(firsts), stage_us=mean(gaps),
                   stages=statistics.mean(len(r) for r in ready))
        if k == 0:
            out.update(compute_us=mean(parts[6]), fold_us=mean(parts[7]))
        segs.append(seg)
        if k < n_sync:
            arrive = [b[k] for b in before if len(b) > k]
            release = [a[k] for a in after if len(a) > k]
            syncs.append({"us": us(min(release) - max(arrive)),
                          "arrival_spread_us": us(max(arrive) - min(arrive))})
            start = min(release)
            starts = [a[k] if len(a) > k else start for a in after]
    out.update(segments=segs, syncs=syncs,
               epilogue_us=segs[-1]["critical_us"],
               total_us=us(max(exits) - stamp_ns))
    return out


def median_split(runs: list) -> dict:
    """Key by key, the median of several runs' splits."""
    runs = [r for r in runs if r is not None]
    if not runs:
        return None
    first = runs[0]
    if isinstance(first, dict):
        return {k: median_split([r[k] for r in runs]) for k in first}
    if isinstance(first, list):
        return [median_split([r[i] for r in runs])
                for i in range(min(len(r) for r in runs))]
    return statistics.median(runs)


def probe(lib, fn, grid_max: int, runs: int, flush) -> dict:
    import torch

    buf = torch.zeros(grid_max * PER_BLOCK * 2, dtype=torch.int64,
                      device="cuda")
    stamp = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fn()
    out = []
    for _ in range(runs):
        buf.zero_()
        flush.zero_()
        if lib.small_probe_arm(buf.data_ptr(), PER_BLOCK) != 0:
            raise RuntimeError("small_probe_arm failed")
        # ~1 ms on the card: the host queues the stamp and the launch behind it
        torch.cuda._sleep(2_000_000)
        if lib.small_probe_stamp(stamp.data_ptr(), stream) != 0:
            raise RuntimeError("small_probe_stamp failed")
        fn()
        torch.cuda.synchronize()
        lib.small_probe_arm(None, 0)
        raw = buf.view(grid_max, PER_BLOCK, 2).cpu().numpy()
        counts = (raw[:, :, 0] != 0).sum(axis=1)
        marks = [[(t, v & 0xFF, v >> 8) for t, v in raw[b, :n].tolist()]
                 for b, n in enumerate(counts.tolist())]
        out.append(split(int(stamp.item()), marks))
    return median_split(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=15)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from icra2021_multimodal_ad_tpu_torch.ops import _build, mlp_kernel
    from icra2021_multimodal_ad_tpu_torch.ops import nap_kernel

    if not torch.cuda.is_available():
        print("torch_small_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    built = _build.build(["nap_score", "fused_mlp"])
    libs = build_probe_libs()
    flush = chip_smoke.l2_flush()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid_max = 4 * sms
    gen = torch.Generator(device="cuda").manual_seed(3)
    model = chip_smoke.random_bn_model(seed=11)
    pack = mlp_kernel.mlp_pack(model.encoder)
    nap_packs = {j: nap_kernel.nap_pack(chip_smoke.random_stats(
        NAP_K, j, seed=j)) for j in NAP_J}
    rows = []
    for b in BS:
        x = torch.randn(b, pack.layers[0].w.shape[1], generator=gen,
                        device="cuda")
        launch = lambda: mlp_kernel.fused_mlp_module(pack, x)  # noqa: E731
        _build._loaded["fused_mlp"] = ctypes.CDLL(str(
            _build.library_path("fused_mlp")))
        dev = chip_smoke.device_ms(launch, flush)
        _build._loaded["fused_mlp"] = libs["fused_mlp"]
        rows.append(dict(kernel="fc_module_kernel", shape="encoder", b=b,
                         device_ms=dev, **probe(libs["fused_mlp"], launch,
                                                grid_max, args.runs, flush)))
        for j, npack in nap_packs.items():
            xn = torch.randn(b, NAP_K, generator=gen, device="cuda")
            launch = lambda: nap_kernel.nap_score(npack, xn, 4)  # noqa: E731
            _build._loaded["nap_score"] = ctypes.CDLL(str(
                _build.library_path("nap_score")))
            dev = chip_smoke.device_ms(launch, flush)
            _build._loaded["nap_score"] = libs["nap_score"]
            rows.append(dict(kernel="nap_small_kernel", shape=f"J = {j}",
                             b=b, device_ms=dev,
                             **probe(libs["nap_score"], launch, grid_max,
                                     args.runs, flush)))
    for row in rows:
        print(json.dumps({"card": smi, **row}), flush=True)
    print(json.dumps({"probe": "done", "card": smi, "built": sorted(built),
                      "shapes": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
