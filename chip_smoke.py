#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printing one JSON line or more:

1. device and build: the card, its power limit, the kernels' build time
   (one nvcc per source, all started together), the fp32 flags (no TF32);
2. every kernel against its plain version, each of its dispatch variants
   (64 x 64 tiles for small batches, wide tiles for large ones) in fp32 and
   bf16 at every batch of CHECK_B, with the variant the wrapper picks
   marked: the NAP score on ragged, floored and canonical shapes and at the
   train-and-score shape (K = J = 5482); the fused FC layer on a ragged
   shape with and without BN and activation and at every canonical layer
   shape (a bf16 layer's bf16 output must be its fp32 output rounded); and
   whole canonical modules; the fp32 small-batch variant 4 of each kernel
   at every batch it takes, also equal to variant 0 bit for bit;
2b. small batches: every tap of the whole-module FC launch against
   variant 0's launch per layer (`torch.equal`) and against the plain layer
   loop, on the canonical encoder and decoder with random BN statistics at
   SMALL_B; the one-launch NAP score against variant 0 (`torch.equal`) and
   its plain version at K = 5482, J = 400 and 4096, floored and not, and on
   the golden stats and windows; both beside variant 0 in `device_ms` and
   `time_ms` with their bounds (a module's is its layers' sum; NAP also its
   plain version's `device_ms`), registers and spills: each must be faster
   than variant 0 at every B <= SMALL_MAX_B and spill nothing; whether
   each beats, in `device_ms`, its plain version (NAP) or one `torch.mm`
   per layer (the module) is printed, not required; and the large-batch NAP
   score at the train CLI's shape (variants 0 and 1 share variant 4's
   order of sums);
2c. the tick's front end (`ops/frontend_kernel.frontend_fuse`, one launch
   from uint8 or fp32 payloads to fused windows) against its plain
   version, the stock ops, at FRONTEND_B in both frame types, then its
   `device_ms` and `time_ms` at FRONTEND_B with the L2 flushed beside its
   bound and the stock ops';
3. golden replay: the checked-in model, NAP stats and fixture windows,
   scored through both kernels, against the frozen `nap_score` column;
   then, on these degenerate stats, each bf16 NAP variant must sit
   LO_MARGIN times closer to its plain version than to the same arithmetic
   without the lo half of the centred rows (`lo_half_check`);
4. canonical-width serving: a seeded full-width model (Config() defaults),
   NAP fitted on 4096 windows, fp32 and bf16 bundles answering BASE, SAP and
   NAP requests; every request must launch the FC kernel, every NAP request
   the NAP kernel;
5. train and score from fused windows: `novelty_detection.run` at the
   Config() defaults (3 epochs, verbose 0: the fused epoch programs) on
   seeded windows with a planted anomaly, from the initial weights and
   epoch order JAX draws for the seed; the validation passes (the first
   epoch's eager, the others replays of the validation graph, counted by
   the programs) and the test passes must launch the FC kernel and the NAP
   scores the NAP kernel; then the NAP kernel against its plain version on
   the stats `run` fitted and the valid and test diffs it scored, and the
   lo-half check on those stats;
6. times on the card: each kernel beside its plain version, the product
   alone (`matmul_ms`) and its bound, with its TFLOP/s, at the serving
   shapes and at the train-and-score NAP shape; every kernel's registers
   (ptxas) and shared memory; end-to-end request latency;
7. frontend and CLIs, this slice's main path, with no JAX, pandas or PIL:
   (a) the golden fixture from `caltime_test.csv` itself, read by the
   native CSV reader, fused on the card and scored through both kernels by
   `full_test.run_full_test`, against the committed windows and the golden
   column; (b) the train CLI, `novelty_detection.main` at Config()
   defaults (3 epochs, verbose 2: the per-epoch programs, with the
   CLI's progress lines), on 11,200 windows of synthetic data_sum shards
   written here in the full schema (963 LiDAR columns, 24 x 32 PNGs): the
   native reader, the loader's split sizes, both kernels, finite reports,
   the result CSV; then, on the CLI's own inputs, the FC kernel against its
   plain version at every layer input of the train, valid and test diff
   extractions (B = 5880, 1960, 3360) and the NAP kernel on the stats the
   CLI fitted and the valid and test diffs it scored; then a second run
   that must hit the feature cache with bit-equal windows; (c) the
   frontend's times beside the card, both kernels' times at the CLI's
   shapes (the `kernels` line's), and the NAP fit at the CLI's 5880 rows
   and at the default split's 29,400, on the CLI's diffs (tiled to 29,400)
   and on random ones; the build's frames unfiltered three ways side by
   side (one byte at a time in Python, as before the batched decoder; the
   numpy plain version; the C unfilter), and a 640 x 480 frame written by
   the port's encoder, resized to 32 x 24 as PIL resizes it (the committed
   array) and timed;
8. the realtime path at Config() defaults (sensor All, 5 layers, bottleneck
   100, batch 10 per tick): (a) the MFCC on the card, both realtime
   variants on an aligned and an unaligned 44.1 kHz ring and
   `mfcc_from_wave` at 22,050 Hz (odd n_fft), against a float64 numpy
   evaluation of the same pipeline; (b) a detector trained on the card
   (`novelty_detection.run`) on 500 normal windows of `SimulatedSensors`,
   its checkpoint and NAP stats under build/chip_smoke/realtime/; (c) the
   users' command, `realtime_tester.main`, four times (fp32 BASE, fp32
   NAP, bf16 NAP behind the deploy guard, fp32 NAP pipelined), 60 ticks
   each with the drop from tick 30: finite (60, 10) traces, the mean score
   after the drop more than twice the mean before it (fp32 BASE and NAP),
   the pipelined trace equal to the sequential one bit for bit, the guard's
   error within its tolerance, and the FC kernel launched on every tick
   and the NAP kernel on every NAP tick, by count (a tick is two CUDA
   graph replays, whose launches the programs count); every run's trace
   equal bit for bit to the eager tick's (`score_rings_eager`) on the same
   ring snapshots, or the stage that differs named with its error; p50
   and p95 tick latency; (d) both kernels against their plain versions on
   one tick's own inputs (B = 10), in fp32 and bf16, and their times there
   (variant 0 and the small-batch variants); each stage of a tick timed
   alone, and whole ticks, captured and eager, under torch.profiler,
   where a captured tick must be 2 graph launches and no kernel launch
   from the host, and an fp32 one run 2 (BASE) or 3 (NAP) whole-module FC
   launches and one NAP launch and nothing of the per-layer variants;
9. the ETL: raw episodes in the full schema (963 LiDAR values, 24 x 32
   PNGs, 44.1 kHz stereo wav), cut to 24 episodes of 6 s for time, through
   `concatdata_maker.main` on the card: the shards read back by the native
   reader, the rows and labels of each episode as its grid gives them, the
   MFCC columns against a float64 numpy MFCC of each resampled wav, a rerun
   that writes nothing, and `TabularDataset` at sensor mic on the shards;
   seconds per episode and the MFCC's ms;
10. training variants: the PRNG replay on the card against the numpy one
   and its times, then `novelty_detection.run` at Config() widths on phase
   5's windows, 3 epochs, four times: VIB (distribution normal, k 2), bf16
   training, bf16 params, the Gram NAP fit; each run's launches by count,
   the FC kernel against its plain version at every layer input of its
   diff extraction (and of the bf16 validation), the NAP kernel on its
   fitted stats, finite reports; then the Gram fit beside the SVD fit on
   the train CLI's diffs (7b), timed, with both NAP AUROCs;
11. int8 NAP, export and the score server, on phase 4's canonical fit and
   phase 8b's detector: (a) the int8 GEMM's int32 sums bit-equal to the
   exact float64 product and the int8 scores to their plain version at
   B = 10 and 4096 on both fits, each fit's bf16 + int8 guard, then
   `realtime_tester.main --nap --compute_dtype bfloat16 --nap_quant int8
   --guard_tol 0.1`, 60 ticks with the drop from tick 30 (after/before > 2,
   15 FC launches and one int8 GEMM per tick, no NAP-kernel launch but the
   guard's fp32 side); (b) `export.main` on the detector, every op, in
   fp32, bf16 and fp32 + int8, each artifact verified against the live
   bundle, the fp32 ones against the live kernel path at rtol 1e-4, one
   loaded and run by a process that imports torch alone; (c) `serve.main`
   on loopback in fp32, bf16 and bf16 + int8 (both guarded): ragged
   requests of 1, 10, 33, 1000 and 1024 rows of every op against the
   in-process bundle, sensor ops, `native/score_client.cpp` built with g++;
   every request a CUDA graph replay per chunk
   (`ops/serving.ServingPrograms`): each (op, bucket) that the requests,
   the warm-up and the sensor request reached, captured against the eager
   server (`_score_eager`, `_score_sensor_op_eager`) bit for bit; one graph
   launch per chunk and no kernel launch from the host (torch.profiler);
   the programs' device and pinned memory and the warm-up's seconds
   captured and eager; (d) raw episodes in the legacy schema through
   `concatdata_maker.main --variant legacy` and `--variant frames`, read
   back with the rows the CSVs give; (e) the int8 whitening's device time
   beside the fp32 and bf16 NAP kernels' at K = 5482, J = 4096;
12. the sharded path at Config() widths on phase 5's windows: the single
   process trains 2 epochs, then, one group after the other, two gloo
   ranks sharing the card, one nccl rank (a world of its own) and, where
   the machine has several cards, one nccl rank on each of up to 4,
   spawned, each run the first step's gradients and `NoveltyDetecter` on
   its mesh, 2 epochs and `test()`; each tensor of the first step's
   gradients as close to float64 as the single step's same tensor
   (GRAD_RATIO, GRAD_FLOOR), the per-epoch losses within HISTORY_RTOL,
   each rank's launches by count, each kernel against its plain version on
   that rank's shards, and the single process's `test()` on the gloo run's
   weights against the sharded scores at rtol 1e-5 / atol 1e-6 (the gloo
   ranks train in the eager loop; the nccl ranks and the single process
   on the epoch programs).  Then each nccl rank (`meshed_programs`): the
   meshed epoch programs, per-epoch and fused (no host sync from the
   first replay to the fetch), fp32 and VIB (k 2), 3 epochs, each
   bit-identical to the meshed eager loop (weights, BN buffers, Adam
   state, histories; fused: their fp32 quotients), the FC kernel's
   launches by count and against its plain version on the validation
   program's shard; captured epochs under torch.profiler (2 graph launches
   an epoch, no kernel launch from the host);
13. the trainer's epoch programs (`train.EpochPrograms`) at Config()
   widths on phase 5's windows, 3 epochs, in fp32, bf16 training, bf16
   params and VIB (k 2): the eager loop (`train_all_epochs_eager`), the
   per-epoch programs and the fused programs from the seeded model, each
   program run's weights, BN buffers and Adam state bit-identical to the
   eager loop's, its histories too (fused: their fp32 quotients), fused
   against per-epoch valid histories within MODES_RTOL, the fused loop
   under `torch.cuda.set_sync_debug_mode("error")` from the end of its
   capture to its fetch, a run checkpointed after epoch 1 and resumed to
   3 bit-exact with the per-epoch run, the FC kernel's launches by count
   (the first epoch eager, then replays) and against its plain version on
   the validation pass's inputs; captured epochs and eager ones under
   torch.profiler (a captured epoch 2 graph launches and no kernel launch
   from the host, the FC kernel inside the validation graph).

The counts of both kernels are set to 0 just before phases 3, 4, 5, 7a and
7b, each run of 8c and 10, 11a's realtime run, 11b's exports, 11c's
servers, each rank of 12 and each of its program runs, and each run of 13
drive their path, and read
just after (`reset_counts`, `read_counts`).  A path's FC check counts the
layers that ran on the kernel, a launch per layer or a module per launch
(`fc_layers`), so it still proves that every layer of every pass ran on a
kernel; where the batch is small it also counts the module launches.  A
captured program's replays add what its capture counted.  The next-to-last
line is {"kernels": [...]}, the two per-call kernels and the two
small-batch variants, whose main path is the streaming tick; the last is
{"ok": true, "device": {...}}.  Every fp32 NAP variant sums K in two
levels (32-deep stages, stage totals in stage order); on random and
golden stats it is held to its plain version (`nap_score_plain`, one
product over K), and on a trained detector's near-degenerate whitening
stats (phases 5, 7b, 8, 10, 11b, 11c, 12), which amplify the rounding of
a sum over K, to the plain version in its own order of sums
(`nap_score_staged`), at the same tolerance, with the one-product form's
error beside it (phases 5, 7b, 10 also against float64).  Any failed check
raises, so the script exits non-zero and prints no "ok" line; so does a
host without CUDA.  It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "datasets", "golden")
#: where phase 5 writes its checkpoint, NAP stats and result CSV
RUN_DIR = os.path.join(ROOT, "build", "chip_smoke")

#: published H100 SXM dense peaks (NVIDIA data sheet): fp32 on the CUDA
#: cores, bf16 on the tensor cores, and HBM3 bandwidth
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
CANON_K, CANON_J = 5482, 4096
CANON_B = (1, 10, 256, 4096)
MLP_B = (10, 4096, 7000)
#: phase 2's batches: both sides of every dispatch threshold, the train
#: CLI's 1960 / 3360 / 5880, train-and-score's 2048 / 4096 / 7000 and the
#: streaming 1 / 10
CHECK_B = (1, 10, 64, 256, 1960, 2048, 3360, 4096, 5880, 7000)
#: the NAP shape of the train CLI and of train-and-score (J = min(train
#: rows, K)) and their batches
RUN_NAP_K = RUN_NAP_J = 5482
RUN_NAP_B = (1960, 2048, 3360, 4096)
TIMED_RUNS = 25
KERNEL_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-5),
              torch.bfloat16: dict(rtol=5e-3, atol=1e-5)}
#: the FC layer's tolerance; `atol` holds on the accumulator, so a BN
#: layer's scales by its gain |bn_weight| / sqrt(running_var + eps) (at
#: least 1), which multiplies any summation order's rounding: a trained
#: detector's gain reaches ~300, where the plain version itself sits 2e-5
#: from float64
MLP_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=1e-3, atol=1e-4)}
#: the FC check where a path's inputs lie off the training distribution:
#: 11b's and 11c's random windows push the detector's pre-activations to
#: ~1e3 (~1 on a tick), past what MLP_TOL's absolute atol allows any fp32
#: summation order, the plain version's included.  There each output is
#: held in units of its arithmetic's error scale, 2^-24 * (gain *
#: (|x| @ |W|^T + |b| + |bn_mean|) + |out|), the accumulation's terms and
#: the BN affine's: the kernel within MLP_UNITS_F64 of float64 and
#: within MLP_UNITS_PLAIN of its plain version (phase 11 on the H100 80GB
#: HBM3 at 700 W read fp32 <= 1.8 and <= 4.3 units, bf16 <= 9.7 and
#: <= 11.0)
MLP_UNITS_F64, MLP_UNITS_PLAIN = 16.0, 32.0
#: whole-module mean relative error, kernel against plain: summation order
#: may flip a bf16 rounding of a next-layer input
MODULE_MEAN_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: bf16 NAP on degenerate stats: how many times closer to its plain
#: version the kernel must sit than to the plain version without lo
LO_MARGIN = 10.0
#: phase 5: train / valid / test rows (one full batch of 7000 and a tail)
TRAIN_ROWS, VALID_ROWS, TEST_ROWS = 8192, 2048, 4096
#: phase 7: the train CLI's synthetic shards, 11,200 windows (cut from the
#: default slicing_size of 56,000 for the phase's time), and the splits the
#: loader must report: 0.6 / 0.2 / 0.2 of the 9,800 normal windows, the
#: 1,400 drop windows (5 per episode) in test
CLI_EPISODES, CLI_STEPS, CLI_SHARDS = 280, 40, 2
CLI_SPLIT = {"train": 5880, "valid": 1960, "test": 3360,
             "test_anomalous": 1400}
#: the NAP fit's input at the default slicing_size of 56,000: 0.6 of the
#: 49,000 normal windows, by the K = 5482 concat of a Config() model's diffs
DEFAULT_FIT_ROWS = 29400
#: the fused golden windows from the CSV against the committed ones
WINDOW_TOL = dict(rtol=1e-5, atol=1e-6)
#: phase 8: the card's MFCC against float64, JAX's own tolerance between
#: its two realtime variants (tests/test_fusion_pipeline.py:243)
MFCC_TOL = dict(rtol=1e-4, atol=1e-4)
#: phase 8: the detector's training windows (ticks of 10 windows: 400 train,
#: 100 valid), its epochs, and the realtime runs: 60 ticks, the drop from
#: tick 30, the post-drop mean read once the ring has turned over
STREAM_FIT_TICKS, STREAM_EPOCHS, STREAM_LR = 50, 40, 1e-3
STREAM_TICKS, STREAM_ANOMALY_AFTER = 60, 30
STREAM_RUNS = {
    "fp32_base": [],
    "fp32_nap": ["--nap"],
    "bf16_nap_guarded": ["--nap", "--compute_dtype", "bfloat16",
                         "--guard_tol", "0.1"],
    "fp32_nap_pipelined": ["--nap", "--pipelined"],
}
#: phase 9: the ETL's raw episodes, cut for time to 24 of 6 s (the
#: reference shards 120 episodes per file), in shards of 12
ETL_EPISODES, ETL_SECONDS, ETL_PER_SHARD = 24, 6.0, 12
#: where phases 8 and 9 run; the card
DEV = "cuda"
#: phase 7c: the frames unfiltered three ways, side by side
PNG_SAMPLE = 1000
#: phase 10: the training variants, each through `novelty_detection.run`
#: on phase 5's seeded windows at Config() widths, 3 epochs
VARIANT_RUNS = {
    "vib_k2": dict(distribution="normal", k=2),
    "bf16_train": dict(train_dtype="bfloat16"),
    "bf16_params": dict(param_dtype="bfloat16"),
    "gram_fit": dict(nap_fit_method="gram"),
}
#: phase 11: the int8 whitening's batches, the int8 realtime run, the
#: export and server runs, the server's ragged requests, the ETL variants'
#: episodes
INT8_B = (10, 4096)
INT8_PEAK_OPS = 1979e12
INT8_GUARD_TOL = 0.05
INT8_STREAM_RUN = {"int8_nap_guarded": [
    "--nap", "--compute_dtype", "bfloat16", "--nap_quant", "int8",
    "--guard_tol", "0.1"]}
EXPORT_OPS = "base,nap_windows,nap,base_sensor,nap_sensor"
EXPORT_B = 64
EXPORT_RUNS = {"float32": [],
               "bfloat16": ["--compute_dtype", "bfloat16", "--guard_tol",
                            "0.1"],
               "int8": ["--nap_quant", "int8", "--guard_tol", "0.1"]}
SERVER_RUNS = {"float32": [],
               "bfloat16": ["--compute_dtype", "bfloat16", "--guard_tol",
                            "0.1"],
               "int8": ["--compute_dtype", "bfloat16", "--nap_quant", "int8",
                        "--guard_tol", "0.1"]}
#: phase 11b: the fp32 NAP artifacts and the kernels, each against
#: float64, on the detector's un-floored stats (read 6.9e-4 and 8.0e-4 on
#: the H100 80GB HBM3 at 700 W)
F64_NAP_MAX_REL = 2e-3
SERVER_ROWS = (1, 10, 33, 1000, 1024)
#: the server's in-process tolerances (tests/test_score_server.py:60-84)
SERVER_TOL = {"score_base": 1e-5, "score_sap": 1e-5, "score_nap": 1e-3}
LEGACY_EPISODES, LEGACY_SECONDS, LEGACY_MIC = 3, 5.0, 8
#: phase 7c: a camera-sized frame, and PIL's resize of it to the dataset's
#: 32 x 24 (tests/test_torch_png_resize.py regenerates it with PIL)
PNG_PROBE_SIZE = (640, 480)
PNG_PROBE_EXPECTED = os.path.join(ROOT, "datasets", "png_resize",
                                  "probe_640x480_to_32x24.npy")


#: phase 2b: the batches and NAP widths of the small-batch variants' check
#: (the tick's 10, the score server's buckets 1, 16 and 32, both sides of
#: SMALL_MAX_B and the kernels' largest, 64)
SMALL_B = (1, 10, 16, 32, 33, 64)
#: phase 2c's batches: the robot's tick and a large batch
FRONTEND_B = (10, 8192)
#: the fusion's tolerance (tests/test_torch_fusion.py)
FRONTEND_TOL = dict(rtol=1e-5, atol=1e-6)
SMALL_NAP_J = (400, 4096)
#: the depth of one stage of the fp32 kernels' sums over K
#: (`nap_score_staged`)
NAP_STAGE = 32

#: phase 1's ptxas table, by library, for phase 6
PTXAS: dict = {}
#: the host clock when this module was loaded, for the profiles' ages
STARTED = time.perf_counter()


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def reset_counts() -> None:
    """Every kernel's count to 0, just before a path is driven."""
    from icra2021_multimodal_ad_tpu_torch.ops.frontend_kernel import (
        frontend_fuse,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
        fused_mlp_module,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score
    from icra2021_multimodal_ad_tpu_torch.ops.serving import int8_product

    nap_score.launches = nap_score.small_launches = 0
    fused_mlp_layer.launches = fused_mlp_module.launches = 0
    fused_mlp_module.layers_run = int8_product.launches = 0
    frontend_fuse.launches = 0


def read_counts() -> dict:
    """The counts since `reset_counts`: the FC kernel's per-layer launches
    (fused_mlp, variants 0-3) and whole-module launches (fused_mlp_module,
    variant 4), the FC layers that ran on the kernel either way
    (fc_layers), the NAP kernel's launches of every variant (nap_score)
    and of the one-launch variant (nap_score_small), the int8 GEMMs and
    the tick's front end (frontend_fuse)."""
    from icra2021_multimodal_ad_tpu_torch.ops.frontend_kernel import (
        frontend_fuse,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
        fused_mlp_module,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score
    from icra2021_multimodal_ad_tpu_torch.ops.serving import int8_product

    return {"nap_score": nap_score.launches,
            "nap_score_small": nap_score.small_launches,
            "fused_mlp": fused_mlp_layer.launches,
            "fused_mlp_module": fused_mlp_module.launches,
            "fc_layers": fused_mlp_layer.launches
            + fused_mlp_module.layers_run,
            "int8_product": int8_product.launches,
            "frontend_fuse": frontend_fuse.launches}


def pearson(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(np.corrcoef(a.double().cpu().numpy(),
                             b.double().cpu().numpy())[0, 1])


def max_rel(a: torch.Tensor, b) -> float:
    a = a.double().cpu().numpy()
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def mean_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (b.abs() + 1e-3)).mean())


def png_probe_frame() -> np.ndarray:
    """The 640 x 480 RGB frame of phase 7c's size check: gradients and a
    diagonal under seeded noise, so a resize sees every filter tap."""
    w, h = PNG_PROBE_SIZE
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255.0 / (w - 1), yy * 255.0 / (h - 1),
                     (xx + 2 * yy) % 256.0], axis=-1)
    noise = np.random.default_rng(640).normal(0, 12, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def canonical_config():
    from icra2021_multimodal_ad_tpu_torch.config import Config, get_input_size

    cfg = Config()
    return cfg.replace(input_size=get_input_size(cfg))


def random_stats(k: int, j: int, seed: int, floored: bool = False):
    """Well-conditioned random whitening stats: a kernel check, not a fit."""
    from icra2021_multimodal_ad_tpu_torch.ops.normalize import (
        RotaterStats,
        StandardizerStats,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import NapStats

    rng = np.random.default_rng(seed)
    var = rng.uniform(0.5, 2.0, j).astype(np.float32)
    if floored:
        var[::7] = np.inf
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return NapStats(
        RotaterStats(f32(rng.normal(size=k)),
                     f32(rng.normal(size=(k, j)) / np.sqrt(k))),
        StandardizerStats(f32(rng.normal(size=j)), torch.from_numpy(var)),
    ).to("cuda")


def random_bn_model(seed: int):
    """The canonical model with seeded random BN affine and running stats,
    so the kernel's BN epilogue sees more than the identity."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model

    model = get_model(canonical_config())
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in (model.encoder, model.decoder):
            for fc in module.net:
                if fc.bn is None:
                    continue
                n = fc.bn.weight.shape[0]
                u = lambda lo, hi: (lo + (hi - lo) * torch.rand(  # noqa: E731
                    n, generator=g)).cuda()
                fc.bn.weight.copy_(u(0.5, 1.5))
                fc.bn.bias.copy_(u(-0.1, 0.1))
                fc.bn.running_mean.copy_(u(-0.1, 0.1))
                fc.bn.running_var.copy_(u(0.5, 2.0))
    return model


def time_ms(fn, flush: torch.Tensor) -> float:
    """Median of TIMED_RUNS single-call CUDA-event times after warm-up; the
    50 MB L2 is overwritten before each call, so every call finds it cold
    as a request does after the work before it."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def wall_ms(fn) -> float:
    """Median host-clock request latency, each ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: float, ops: float, dtype: torch.dtype):
    """(least ms, what sets it): the bytes at HBM rate against the
    operations at the type's peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nap_bound(b: int, k: int, j: int, dtype: torch.dtype):
    """The NAP score: x, V, the fp32 vectors and the scores moved once,
    against 2BKJ product operations plus the centering (BK) and the
    epilogue (4BJ)."""
    size = torch.tensor([], dtype=dtype).element_size()
    return bound((b * k + k * j) * size + 4 * (k + 2 * j + b),
                 2 * b * k * j + b * k + 4 * b * j, dtype)


def mlp_bound(layer, x: torch.Tensor):
    """One FC layer: x, W, the fp32 vectors and the fp32 output moved once,
    against 2BKN product operations plus the epilogue (bias; 1 for the
    activation; 4 for the BN) per output."""
    b, k = x.shape
    n = layer.w.shape[0]
    n_vec = 1 + (4 if layer.bn_mean is not None else 0)
    epi = 1 + int(layer.leaky) + (4 if layer.bn_mean is not None else 0)
    return bound(b * k * x.element_size() + k * n * layer.w.element_size()
                 + 4 * (n_vec * n + b * n),
                 2 * b * k * n + epi * b * n, layer.w.dtype)


def layer_inputs(model):
    """(name, module pack side, layer index) of every canonical layer, in
    the order of one AE forward."""
    return [(f"{side}.{i}", side, i)
            for side in ("encoder", "decoder")
            for i in range(len(getattr(model, side).net))]


def ptxas_table(log: str) -> dict:
    """{kernel: {"registers", "static_smem", "spill_bytes"}} from nvcc's
    -Xptxas -v output; a kernel is named by its function and its tile's
    template integers (e.g. "fc_simt_kernel<8,8,4,1,1,4,2>")."""
    import re

    table, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+([a-z_]+kernel)", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled) or (
                ["bf16"] if "bfloat16" in mangled else
                ["float"] if "IfE" in mangled else [])
            name = ((base.group(1) if base else mangled)
                    + (f"<{','.join(args)}>" if args else ""))
            table[name] = {"spill_bytes": 0}
        elif name and "spill stores" in ln:
            table[name]["spill_bytes"] = int(re.search(
                r"(\d+) bytes spill stores", ln).group(1))
        elif name and "Used" in ln and "registers" in ln:
            table[name]["registers"] = int(re.search(
                r"Used (\d+) registers", ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            table[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return table


def phase_device_and_build() -> str:
    from icra2021_multimodal_ad_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = _build.build(["nap_score", "fused_mlp", "frontend_fuse"])
    for name in ("nap_score", "fused_mlp", "frontend_fuse"):
        _build.load(name)
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_table(info["log"]) for name, info in built.items()}
    PTXAS.update(ptxas)
    flags = {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
    }
    require(not any(flags.values()), f"reduced-precision flags on: {flags}")
    emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=build_s,
         built=sorted(built), ptxas=ptxas, flags=flags)
    return smi


def variants_of(module, dtype, b: int = 0):
    """The variant ids of a kernel module that take a b-row batch of
    `dtype`: (narrow, wide), and for fp32 at most KERNEL_MAX_B rows the
    small-batch variant after them."""
    out = tuple(module.VARIANTS[(dtype, wide)] for wide in (False, True))
    if dtype == torch.float32 and 1 <= b <= module.KERNEL_MAX_B:
        out += (module.SMALL_VARIANT,)
    return out


def nap_vs_plain(seen: set) -> float:
    from icra2021_multimodal_ad_tpu_torch.ops import nap_kernel
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_pack,
        nap_score,
        nap_score_plain,
    )

    shapes = [("ragged", 70, 70, False, (33,)),
              ("floored", 70, 70, True, (33, 1300)),
              ("canonical", CANON_K, CANON_J, False, CHECK_B),
              ("canonical floored", CANON_K, CANON_J, True, (256, 4096)),
              ("train_and_score shape", RUN_NAP_K, RUN_NAP_J, False,
               RUN_NAP_B)]
    worst = 0.0
    for name, k, j, floored, batches in shapes:
        stats = random_stats(k, j, seed=k + j + floored, floored=floored)
        packs = {dtype: nap_pack(stats, dtype) for dtype in KERNEL_TOL}
        for b in batches:
            x = torch.tensor(np.random.default_rng(b).normal(size=(b, k)),
                             dtype=torch.float32, device="cuda")
            for dtype, tol in KERNEL_TOL.items():
                pack = packs[dtype]
                ref = nap_score_plain(pack, x)
                outs = {}
                for variant in variants_of(nap_kernel, dtype, b):
                    got = outs[variant] = nap_score(pack, x, variant)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    ok = bool(torch.allclose(got, ref, **tol))
                    # the small-batch variant gives variant 0's bits
                    if variant == nap_kernel.SMALL_VARIANT:
                        ok = ok and bool(torch.equal(got, outs[0]))
                    emit(phase="kernel_vs_plain", kernel="nap_score",
                         case=name, b=b, k=k, j=j, floored=floored,
                         dtype=str(dtype), variant=variant,
                         dispatched=variant == nap_kernel.variant_for(dtype,
                                                                      b),
                         max_abs_err=err, tol=tol, ok=ok)
                    require(ok, f"nap_score {name} {dtype} variant "
                                f"{variant} B={b} disagrees with its plain "
                                f"version (max abs err {err})")
                    seen.add(("nap_score", variant))
                    worst = max(worst, err)
    return worst


def nap_plain_hi_only(pack, x: torch.Tensor) -> torch.Tensor:
    """`nap_score_plain` of a bf16 pack with the lo half left out: the
    centred rows rounded once to bf16, hi alone against V."""
    bf16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    rot = bf16(bf16(x.float()) - pack.mu) @ pack.v.float()
    t = (rot - pack.std_mu) * pack.inv_std
    return (t * t).sum(dim=-1) / pack.j


def lo_half_check(case: str, stats, x: torch.Tensor) -> None:
    """Both bf16 NAP variants on whitening stats that amplify rounding
    (smallest variance ~1e-13), where leaving out the lo half of the
    centred rows moves the scores far more than summation order does: each
    must sit LO_MARGIN times closer, in max relative error, to its plain
    version (hi + lo) than to the hi-only arithmetic."""
    from icra2021_multimodal_ad_tpu_torch.ops import nap_kernel
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_pack,
        nap_score,
        nap_score_plain,
    )

    pack = nap_pack(stats, torch.bfloat16)
    hi_lo, hi = nap_score_plain(pack, x), nap_plain_hi_only(pack, x)
    rel = lambda a, b: float(((a - b).abs() / b.abs()).max())  # noqa: E731
    for variant in variants_of(nap_kernel, torch.bfloat16):
        got = nap_score(pack, x, variant)
        to_hi_lo, to_hi = rel(got, hi_lo), rel(got, hi)
        emit(phase="lo_half", case=case, b=int(x.shape[0]), k=pack.k,
             j=pack.j, variant=variant,
             min_var=float(stats.standardizer.var.min()),
             kernel_vs_hi_lo_max_rel=to_hi_lo,
             kernel_vs_hi_only_max_rel=to_hi, margin=LO_MARGIN)
        require(to_hi > 0 and to_hi_lo * LO_MARGIN < to_hi,
                f"bf16 nap_score variant {variant} on {case}: max rel "
                f"{to_hi_lo} from hi + lo, {to_hi} from hi alone; the lo "
                f"half is not seen")


def _check_layer(name, layer, x, tol, seen: set,
                 scaled: bool = False) -> float:
    """Both variants of the FC kernel against its plain version on one
    layer input: at `tol` (MLP_TOL), or with `scaled` in units of the
    accumulation's error scale against the plain version and float64
    (MLP_UNITS_PLAIN, MLP_UNITS_F64)."""
    from icra2021_multimodal_ad_tpu_torch.ops import mlp_kernel
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        LayerPack,
        fused_mlp_layer_pair,
        fused_mlp_layer_plain,
    )

    dtype, b = layer.w.dtype, x.shape[0]
    ref = fused_mlp_layer_plain(layer, x)
    gain = (torch.ones_like(layer.b) if layer.bn_mean is None else
            (layer.bn_weight.abs() / layer.bn_std).clamp_min(1.0))
    if scaled:
        l64 = LayerPack(*(t.double() if isinstance(t, torch.Tensor) else t
                          for t in layer))
        x64 = x.to(dtype).double()
        ref64 = fused_mlp_layer_plain(l64, x64)
        # the accumulation's terms and the BN affine's operands and result
        mean = 0.0 if l64.bn_mean is None else l64.bn_mean.abs()
        unit = 2.0 ** -24 * (gain.double() * (x64.abs() @ l64.w.abs().t()
                                              + l64.b.abs() + mean)
                             + ref64.abs())
        plain_units = float(((ref - ref64).abs() / unit).max())
    worst, outs = 0.0, {}
    for variant in variants_of(mlp_kernel, dtype, b):
        got, got16 = fused_mlp_layer_pair(layer, x, variant)
        outs[variant] = got
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if scaled:
            units = {"vs_plain": float(((got - ref).abs() / unit).max()),
                     "vs_f64": float(((got - ref64).abs() / unit).max()),
                     "plain_vs_f64": plain_units}
            ok = (units["vs_plain"] <= MLP_UNITS_PLAIN
                  and units["vs_f64"] <= MLP_UNITS_F64)
        else:
            units = None
            ok = bool(((got - ref).abs() <= tol["atol"] * gain
                       + tol["rtol"] * ref.abs()).all())
        # the bf16 copy the next layer reads is the fp32 output rounded;
        # the whole-module variant gives variant 0's bits
        ok16 = got16 is None or bool(torch.equal(got16, got.to(dtype)))
        if variant == mlp_kernel.SMALL_VARIANT:
            ok = ok and bool(torch.equal(got, outs[0]))
        emit(phase="kernel_vs_plain", kernel="fused_mlp", case=name, b=b,
             k=x.shape[1], n=layer.w.shape[0], dtype=str(dtype),
             x_dtype=str(x.dtype), leaky=layer.leaky,
             bn=layer.bn_mean is not None, variant=variant,
             dispatched=variant == mlp_kernel.variant_for(dtype, b),
             max_abs_err=err,
             tol=(dict(units_vs_plain=MLP_UNITS_PLAIN,
                       units_vs_f64=MLP_UNITS_F64) if scaled else tol),
             error_units=units, bn_gain_max=float(gain.max()), ok=ok,
             bf16_copy_ok=ok16)
        require(ok and ok16, f"fused_mlp {name} {dtype} variant {variant} "
                             f"B={b} disagrees with its plain version (max "
                             f"abs err {err}, bf16 copy ok {ok16})")
        seen.add(("fused_mlp", variant))
        worst = max(worst, err)
    return worst


def mlp_vs_plain(seen: set) -> float:
    from icra2021_multimodal_ad_tpu_torch.ops import _build
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        LayerPack,
        fused_mlp_layer_plain,
        mlp_pack,
        module_forward_taps,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.serving import cast_floats

    g = torch.Generator(device="cuda").manual_seed(7)
    rand = lambda *s: torch.rand(*s, generator=g,  # noqa: E731
                                 device="cuda")
    x_of = lambda b, k: torch.randn(b, k, generator=g,  # noqa: E731
                                    device="cuda")
    worst = 0.0
    for dtype, tol in MLP_TOL.items():
        # ragged 33 x 70 -> 45, every (activation, BN) combination
        for leaky in (True, False):
            for bn in (True, False):
                vec = (lambda lo, hi: lo + (hi - lo) * rand(45))
                layer = LayerPack(
                    w=_build.operand((rand(45, 70) * 2 - 1) / 70 ** 0.5,
                                     dtype),
                    b=(rand(45) * 2 - 1) / 70 ** 0.5, leaky=leaky,
                    bn_mean=vec(-0.1, 0.1) if bn else None,
                    bn_std=vec(0.7, 1.4) if bn else None,
                    bn_weight=vec(0.5, 1.5) if bn else None,
                    bn_beta=vec(-0.1, 0.1) if bn else None)
                worst = max(worst, _check_layer("ragged", layer,
                                                x_of(33, 70), tol, seen))
        # every canonical layer at every phase-2 batch; a bf16 layer reads
        # the request in bf16 (first encoder layer) or the previous
        # layer's fp32 output
        model = random_bn_model(seed=11)
        if dtype == torch.bfloat16:
            model = cast_floats(model, dtype)
        packs = {side: mlp_pack(getattr(model, side), dtype)
                 for side in ("encoder", "decoder")}
        for name, side, i in layer_inputs(model):
            layer = packs[side].layers[i]
            for b in CHECK_B:
                x = x_of(b, layer.w.shape[1])
                if dtype == torch.bfloat16 and name == "encoder.0":
                    x = x.to(dtype)
                worst = max(worst, _check_layer(f"canonical {name}", layer,
                                                x, tol, seen))
        # whole modules, kernel against a plain layer loop
        for side, pack in packs.items():
            x = x_of(4096, pack.layers[0].w.shape[1])
            got = module_forward_taps(pack, x)[1]
            ref = x
            for layer in pack.layers:
                ref = fused_mlp_layer_plain(layer, ref)
            rel = mean_rel(got, ref.to(pack.dtype))
            emit(phase="kernel_vs_plain", kernel="fused_mlp",
                 case=f"whole {side}", b=4096, dtype=str(dtype),
                 mean_rel_err=rel, limit=MODULE_MEAN_REL[dtype])
            require(rel < MODULE_MEAN_REL[dtype],
                    f"whole {side} {dtype}: mean rel err {rel}")
    return worst


def phase_small_batches(smi: str) -> dict:
    """2b: the small-batch variants (variant 4 of each kernel) against
    variant 0 bit for bit and against their plain versions: every tap of a
    whole-module launch at SMALL_B on `random_bn_model`'s canonical encoder
    and decoder, and the one-launch NAP score at SMALL_B on random stats
    (K = 5482, J in SMALL_NAP_J, floored and not) and on the golden stats
    and windows (K = 3487, J = 150); then both against variant 0 in time
    (`device_ms` and `time_ms`) with their bounds, their registers and
    spills, and whether each beats its plain version (NAP) or a
    `torch.mm` per layer (the module); then the large-batch NAP score at
    the train CLI's shape.  Returns the time rows."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import load_model
    from icra2021_multimodal_ad_tpu_torch.ops import mlp_kernel, nap_kernel
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer_pair,
        fused_mlp_layer_plain_pair,
        fused_mlp_module,
        mlp_pack,
        module_forward_taps,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_pack,
        nap_score,
        nap_score_plain,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import load_nap_stats
    from icra2021_multimodal_ad_tpu_torch.ops.serving import make_serving

    g = torch.Generator(device="cuda").manual_seed(13)
    model = random_bn_model(seed=11)
    checks = []
    for side in ("encoder", "decoder"):
        pack = mlp_pack(getattr(model, side))
        for b in SMALL_B:
            x = torch.randn(b, pack.layers[0].w.shape[1], generator=g,
                            device="cuda")
            got = fused_mlp_module(pack, x)
            ref = module_forward_taps(pack, x, lambda layer, h:
                                      fused_mlp_layer_pair(layer, h, 0))[0]
            plain = module_forward_taps(pack, x, fused_mlp_layer_plain_pair)[0]
            torch.cuda.synchronize()
            checks.append(dict(
                kernel="fused_mlp_module", case=side, b=b,
                equal_to_variant_0=all(torch.equal(a, r)
                                       for a, r in zip(got, ref)),
                mean_rel_vs_plain=mean_rel(got[-1], plain[-1]),
                limit=MODULE_MEAN_REL[torch.float32],
                ok_vs_plain=mean_rel(got[-1], plain[-1])
                < MODULE_MEAN_REL[torch.float32]))
    cases = [(f"J = {j}{' floored' if floored else ''}",
              random_stats(CANON_K, j, seed=j + floored, floored=floored),
              lambda b: torch.randn(b, CANON_K, generator=g, device="cuda"))
             for j in SMALL_NAP_J for floored in (False, True)]
    cfg, gmodel = load_model(os.path.join(GOLDEN, "model"))
    golden = make_serving(cfg, gmodel, nap_stats=load_nap_stats(
        os.path.join(GOLDEN, "nap_stats.npz")))
    gcat = golden.nap_diffs(torch.from_numpy(np.load(os.path.join(
        GOLDEN, "fixture_windows.npz"))["x"]).cuda())
    cases.append(("golden", golden.nap_stats,
                  lambda b: gcat[torch.arange(b) % gcat.shape[0]]))
    for name, stats, rows in cases:
        pack = nap_pack(stats, torch.float32)
        for b in SMALL_B:
            x = rows(b)
            got, ref = nap_score(pack, x, 4), nap_score(pack, x, 0)
            plain = nap_score_plain(pack, x)
            torch.cuda.synchronize()
            checks.append(dict(
                kernel="nap_score_small", case=name, b=b, k=pack.k, j=pack.j,
                equal_to_variant_0=bool(torch.equal(got, ref)),
                max_abs_err=float((got - plain).abs().max()),
                ok_vs_plain=bool(torch.allclose(got, plain,
                                                **KERNEL_TOL[torch.float32])),
                tol=KERNEL_TOL[torch.float32]))
    for row in checks:
        emit(phase="small_batches", **row)

    flush, times = l2_flush(), {}
    for side in ("encoder", "decoder"):
        pack = mlp_pack(getattr(model, side))
        for b in SMALL_B:
            x = torch.randn(b, pack.layers[0].w.shape[1], generator=g,
                            device="cuda")
            times[("fused_mlp_module", side, b)] = dict(
                layer=side, **module_times(pack, x, flush))
    for j in SMALL_NAP_J:
        pack = nap_pack(random_stats(CANON_K, j, seed=j), torch.float32)
        for b in SMALL_B:
            x = torch.randn(b, CANON_K, generator=g, device="cuda")
            old = nap_times(pack, x, flush, 0)
            times[("nap_score_small", j, b)] = dict(
                variant0_ms=old["ms"], variant0_device_ms=old["device_ms"],
                plain_device_ms=device_ms(lambda: nap_score_plain(pack, x),
                                          flush),
                **nap_times(pack, x, flush, 4))
    resources = {name: {k: v for k, v in (PTXAS.get(lib) or {}).items()
                        if k.startswith(kern)}
                 for name, lib, kern in (
                     ("fused_mlp_module", "fused_mlp", "fc_module_kernel"),
                     ("nap_score_small", "nap_score", "nap_small_kernel"))}
    faster, faster_plain, faster_mm = {}, {}, {}
    for (name, shape, b), row in times.items():
        row.update(dtype="float32", path="small batches")
        small_max = (mlp_kernel if name == "fused_mlp_module"
                     else nap_kernel).SMALL_MAX_B
        key = f"{name} {shape} B={b}"
        if b <= small_max:
            faster[key] = row["device_ms"] < row["variant0_device_ms"]
        if name == "nap_score_small":
            faster_plain[key] = row["device_ms"] < row["plain_device_ms"]
        else:
            faster_mm[key] = row["device_ms"] < row["matmul_device_ms"]
        emit(phase="times", kernel=name, shape=shape, card=smi, **row)
    # the train CLI's test scores (phase 7b): variant 1, two-level sums
    cli_b, cli_k = CLI_SPLIT["test"], RUN_NAP_K
    pack = nap_pack(random_stats(cli_k, RUN_NAP_J, seed=5), torch.float32)
    x = torch.randn(cli_b, cli_k, generator=g, device="cuda")
    emit(phase="times", kernel="nap_score", card=smi, dtype="float32",
         path="small batches: the train CLI's shape",
         **nap_times(pack, x, flush))
    emit(phase="small_batches", ptxas=resources, faster_than_variant_0=faster,
         faster_than_plain=faster_plain, faster_than_matmul=faster_mm,
         small_max_b={"fused_mlp_module": mlp_kernel.SMALL_MAX_B,
                      "nap_score_small": nap_kernel.SMALL_MAX_B}, card=smi)
    for row in checks:
        require(row["equal_to_variant_0"],
                f"{row['kernel']} {row['case']} B={row['b']}: not bit-equal "
                f"to variant 0")
        require(row["ok_vs_plain"],
                f"{row['kernel']} {row['case']} B={row['b']} disagrees with "
                f"its plain version: {row}")
    for name, table in resources.items():
        require(table and all(r["spill_bytes"] == 0 for r in table.values()),
                f"{name}: no ptxas entry or spills: {table}")
    require(all(faster.values()), f"a small-batch variant is not faster than "
                                  f"variant 0 at B <= SMALL_MAX_B: {faster}")
    return times


def frontend_bound(b: int, frames: torch.dtype):
    """The front end at B rows: (bytes, operations).  The payloads, the
    fusion weights and the (B, 1728) fp32 windows moved once, against the
    convs' 2 x MACs, bias and ReLU (2 an output) and the normalization (4
    an input value).  A MAC counts where it reads the input: a padded 3 x 3
    conv over 16 x 16 reads (16 * 3 - 2)^2 of its 16 * 16 * 9 taps a
    channel pair, and lid1's two outputs 9 and 13 of their 18."""
    taps = (16 * 3 - 2) ** 2
    convs = [  # (outputs, MACs) of a window's eight convs
        (16 * 16 * 16, 16 * 16 * 16 * 3 * 4), (16 * 16 * 16, 16 * 16 * taps),
        (16 * 8 * 8, 16 * 8 * 8 * 16 * 4), (8 * 16 * 16, 8 * 16 * 16 * 4),
        (8 * 16 * 16, 8 * 8 * taps), (8 * 8 * 8, 8 * 8 * 8 * 8 * 4),
        (8 * 2, 8 * (9 + 13)), (16 * 1, 16 * 8 * 2)]
    # the convs' weights (OIHW) and biases
    weights = (16 * 3 * 4 + 16 * 16 * 9 + 16 * 16 * 4 + 8 * 1 * 4 + 8 * 8 * 9
               + 8 * 8 * 4 + 8 * 1 * 18 + 16 * 8 * 2
               + 16 * 3 + 8 * 3 + 8 + 16)
    size = torch.tensor([], dtype=frames).element_size()
    nbytes = (b * 4096 * size + 4 * (b * 14 + weights) + 4 * b * 1728)
    ops = b * (sum(2 * macs + 2 * o for o, macs in convs)
               + 4 * (4096 + 1 + 13))
    return nbytes, ops


def frontend_times(params, mods, flush) -> dict:
    """The front end's `device_ms` and `time_ms` on payloads `mods` with
    the L2 flushed, the kernel's and the stock ops', beside the kernel's
    bound, with the `kernels` line's keys."""
    from icra2021_multimodal_ad_tpu_torch.ops.frontend_kernel import (
        frontend_fuse,
        frontend_fuse_plain,
    )

    b, frames = mods[0].shape[0], mods[0].dtype
    nbytes, ops = frontend_bound(b, frames)
    least, by = bound(nbytes, ops, torch.float32)
    row = dict(
        b=b, frames=str(frames),
        device_ms=device_ms(lambda: frontend_fuse(params, *mods), flush),
        time_ms=time_ms(lambda: frontend_fuse(params, *mods), flush),
        plain_device_ms=device_ms(lambda: frontend_fuse_plain(params, *mods),
                                  flush),
        plain_time_ms=time_ms(lambda: frontend_fuse_plain(params, *mods),
                              flush),
        bound_ms=least, bound_by=by, matmul_ms=None, variant=None)
    row.update(ms=row["time_ms"], plain_ms=row["plain_time_ms"],
               tflops=ops / (row["device_ms"] * 1e9))
    return row


def phase_frontend_kernel(smi: str) -> dict:
    """2c: the tick's front end in one launch against the stock ops at
    FRONTEND_B, in uint8 and fp32 frames (and a constant mic batch, whose
    columns both make NaN), then both timed with the L2 flushed beside
    the kernel's bound.  Returns ({B: time row} of the uint8 frames, the
    tick's, worst abs err against the stock ops)."""
    from icra2021_multimodal_ad_tpu_torch.ops.frontend_kernel import (
        frontend_fuse,
        frontend_fuse_plain,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.fusion import fusion_init

    params = fusion_init(17, "cuda")
    g = torch.Generator(device="cuda").manual_seed(29)

    def payloads(b, frames):
        r = torch.randint(0, 256, (b, 32, 32, 3), generator=g, device="cuda")
        d = torch.randint(0, 256, (b, 1, 32, 32), generator=g, device="cuda")
        if frames == torch.float32:  # fractional pixels
            r = r + torch.rand(r.shape, generator=g, device="cuda") / 2
            d = d + torch.rand(d.shape, generator=g, device="cuda") / 2
        t = torch.rand(b, 1, generator=g, device="cuda") * 400
        m = torch.randn(b, 1, 13, generator=g, device="cuda") * 100 - 300
        return r.to(frames), d.to(frames), t, m

    rows, times, flush = [], {}, l2_flush()
    for b in FRONTEND_B:
        for frames in (torch.uint8, torch.float32):
            mods = payloads(b, frames)
            before = frontend_fuse.launches
            got = frontend_fuse(params, *mods)
            want = frontend_fuse_plain(params, *mods)
            again = frontend_fuse(params, *mods)
            torch.cuda.synchronize()
            rows.append(dict(
                b=b, frames=str(frames), launches=frontend_fuse.launches
                - before, max_abs_err=float((got - want).abs().max()),
                equal_cols=int((got == want).all(0).sum()),
                same_bits_again=bool(torch.equal(got, again)),
                ok=bool(torch.allclose(got, want, **FRONTEND_TOL))))
            if frames != torch.uint8:
                continue
            times[b] = frontend_times(params, mods, flush)
    r, d, t, m = payloads(10, torch.uint8)
    m = torch.full_like(m, -42.0)
    got = frontend_fuse(params, r, d, t, m)
    want = frontend_fuse_plain(params, r, d, t, m)
    nan_ok = bool(got[:, 1600:].isnan().all() and want[:, 1600:].isnan().all()
                  and torch.isfinite(got[:, :1600]).all()
                  and torch.allclose(got, want, equal_nan=True,
                                     **FRONTEND_TOL))
    resources = {k: v for k, v in (PTXAS.get("frontend_fuse") or {}).items()
                 if k.startswith("frontend_fuse_kernel")}
    for row in rows:
        emit(phase="frontend_kernel", card=smi, tol=FRONTEND_TOL, **row)
    for b, row in times.items():
        emit(phase="times", kernel="frontend_fuse", card=smi, **row)
    emit(phase="frontend_kernel", card=smi, constant_mic_nan_ok=nan_ok,
         ptxas=resources)
    for row in rows:
        require(row["ok"] and row["launches"] == 2 and row["same_bits_again"],
                f"frontend_fuse against the stock ops: {row}")
    require(nan_ok, "frontend_fuse: a constant mic batch is not NaN in its "
                    "columns alone, as the stock ops' are")
    require(resources and all(v["spill_bytes"] == 0
                              for v in resources.values()),
            f"frontend_fuse_kernel: no ptxas entry or spills: {resources}")
    return times, max(row["max_abs_err"] for row in rows)


def path_mlp_vs_plain(path: str, model, windows: dict, seen: set,
                      dtype: torch.dtype = torch.float32,
                      scaled: bool = False) -> float:
    """The FC kernel against its plain version at every layer input that a
    path's diff extraction gives it (`rapp.diffs_batch`): the encoder on a
    split's windows, the decoder on their codes, the encoder again on the
    reconstructions, each split one chunk at its own batch.  Each layer
    reads the plain chain's output, so every check sees the path's data.
    The pack is `dtype` (fp32, or bf16 for a serving cast or the validation
    of bf16 training); `scaled` holds windows off the training
    distribution in error-scale units (`_check_layer`)."""
    from icra2021_multimodal_ad_tpu_torch.models.autoencoder import (
        ae_pack,
        vib_mu,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer_plain,
    )

    pack = ae_pack(model, dtype)
    tol = MLP_TOL[pack.encoder.dtype]
    worst = 0.0
    for split, h in windows.items():
        for name, module in (("encoder", pack.encoder),
                             ("decoder", pack.decoder),
                             ("encoder of x_hat", pack.encoder)):
            if name == "decoder":
                h = vib_mu(h, pack.distribution)
            for i, layer in enumerate(module.layers):
                worst = max(worst, _check_layer(f"{path} {split} {name}.{i}",
                                                layer, h, tol, seen, scaled))
                h = fused_mlp_layer_plain(layer, h)
    return worst


def phase_golden() -> float:
    from icra2021_multimodal_ad_tpu_torch.models.builder import load_model
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import load_nap_stats
    from icra2021_multimodal_ad_tpu_torch.ops.serving import make_serving

    cfg, model = load_model(os.path.join(GOLDEN, "model"))
    stats = load_nap_stats(os.path.join(GOLDEN, "nap_stats.npz"))
    x = torch.from_numpy(np.load(os.path.join(
        GOLDEN, "fixture_windows.npz"))["x"]).cuda()
    with open(os.path.join(GOLDEN, "caltime_test.csv"), newline="") as f:
        col = np.array([float(row["nap_score"]) for row in csv.DictReader(f)])
    reset_counts()
    serving = make_serving(cfg, model, nap_stats=stats)
    s32 = serving.score_nap_windows(x)
    s16 = make_serving(cfg.replace(compute_dtype="bfloat16"), model,
                       nap_stats=stats).score_nap_windows(x)
    torch.cuda.synchronize()
    counts = read_counts()
    rel = max_rel(s32, col)
    corr = pearson(s32, s16)
    # the design point of csrc/nap_score.cu: the TPU kernel's folded form,
    # x @ V - (mu @ V + std_mu), in plain fp32 on the same diffs
    st = serving.nap_stats
    v = st.rotater.v
    t = ((serving.nap_diffs(x) @ v - (st.rotater.mu @ v + st.standardizer.mu))
         / torch.sqrt(st.standardizer.var))
    # three module passes per bundle, every layer on the kernel: the fp32
    # bundle's 10 windows in one module launch a pass and one NAP launch,
    # the bf16 bundle's n_layers launches a pass and its NAP launch
    want = {"fc_layers": 2 * 3 * cfg.n_layers, "fused_mlp_module": 3,
            "nap_score": 2, "nap_score_small": 1}
    emit(phase="golden", windows=int(x.shape[0]), k=int(v.shape[0]),
         j=int(v.shape[1]), fp32_max_rel_err=rel, rtol=2e-3,
         folded_plain_fp32_max_rel_err=max_rel((t * t).mean(dim=-1), col),
         bf16_pearson_vs_fp32=corr, launches=counts, want_launches=want)
    require({k: counts[k] for k in want} == want,
            f"golden launches {counts}, want {want}")
    require(np.allclose(s32.cpu().numpy(), col, rtol=2e-3),
            f"golden NAP max rel err {rel} above rtol 2e-3")
    require(bool(torch.isfinite(s16).all()) and corr > 0.99,
            f"bf16 golden Pearson {corr} not above 0.99")
    lo_half_check("golden", stats.to("cuda"), serving.nap_diffs(x))
    return rel


def phase_canonical():
    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score
    from icra2021_multimodal_ad_tpu_torch.ops.rapp import get_diffs
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
        nap_fit,
        nap_score_device,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.serving import (
        NAP_VAR_FLOOR_REL_BF16,
        make_serving,
    )

    cfg = canonical_config()
    model = get_model(cfg)
    rng = np.random.default_rng(cfg.seed)
    fit_x = torch.from_numpy(
        rng.uniform(0, 1, (4096, cfg.input_size)).astype(np.float32)).cuda()
    req_x = torch.from_numpy(
        rng.uniform(0, 1, (4096, cfg.input_size)).astype(np.float32)).cuda()
    t0 = time.perf_counter()
    stats = nap_fit(torch.cat(get_diffs(fit_x, model), dim=-1))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k, j = stats.rotater.v.shape
    require((k, j) == (CANON_K, CANON_J), f"canonical NAP is {k} x {j}")
    bundles = {"float32": make_serving(cfg, model, nap_stats=stats),
               "bfloat16": make_serving(cfg.replace(compute_dtype="bfloat16"),
                                        model, nap_stats=stats)}

    # the serving path: counts start at 0 here and are read right after
    reset_counts()
    out = {}
    for name, serv in bundles.items():
        cat = serv.nap_diffs(req_x[:256])
        r = {}
        for label, fn, kernels in (
                ("score_fused", lambda: serv.score_fused(req_x), "mlp"),
                ("score_sap_windows", lambda: serv.score_sap_windows(req_x),
                 "mlp"),
                ("score_nap_windows_b10",
                 lambda: serv.score_nap_windows(req_x[:10]), "mlp+nap"),
                ("score_nap_windows_b4096",
                 lambda: serv.score_nap_windows(req_x), "mlp+nap"),
                ("score_nap_b256", lambda: serv.score_nap(cat), "nap")):
            before = read_counts()
            r[label] = fn()
            torch.cuda.synchronize()
            after = read_counts()
            if "nap" in kernels:
                require(after["nap_score"] > before["nap_score"],
                        f"{name} {label} did not launch the NAP kernel")
            if "mlp" in kernels:
                require(after["fc_layers"] > before["fc_layers"],
                        f"{name} {label} did not launch the FC kernel")
        out[name] = r
    launches = read_counts()

    for name, r in out.items():
        for label, s in r.items():
            require(bool(torch.isfinite(s).all()),
                    f"{name} {label}: non-finite scores")
    corr = {label: pearson(out["float32"][label], out["bfloat16"][label])
            for label in ("score_fused", "score_sap_windows")}
    # bf16 NAP against fp32 on the same variance floor, as the JAX
    # package's nap_accuracy_guard compares them; the same bundle's scores
    # also face the unfolded plain reference at canonical width
    floored = make_serving(cfg, model, nap_stats=stats,
                           nap_var_floor_rel=NAP_VAR_FLOOR_REL_BF16)
    s_floored = floored.score_nap_windows(req_x)
    corr["score_nap_windows"] = pearson(
        s_floored, out["bfloat16"]["score_nap_windows_b4096"])
    cat = floored.nap_diffs(req_x[:256])
    ref_rel = max_rel(floored.score_nap(cat),
                      nap_score_device(floored.nap_stats, cat).cpu())
    emit(phase="canonical", k=k, j=j, fit_windows=4096,
         fit_seconds=fit_s, launches=launches,
         shapes={f"{n}.{label}": list(s.shape) for n, r in out.items()
                 for label, s in r.items()},
         bf16_pearson_vs_fp32=corr, fp32_floored_vs_unfolded_max_rel=ref_rel)
    for label, c in corr.items():
        require(c > 0.99, f"bf16 {label} Pearson {c} not above 0.99")
    require(ref_rel < 1e-3,
            f"canonical NAP vs unfolded reference rel err {ref_rel}")
    return bundles, req_x, launches


def seeded_windows(n_normal: int, n_anomalous: int, gen: torch.Generator,
                   mix: torch.Tensor) -> torch.Tensor:
    """Fused-window stand-ins made on the card: a sigmoid of 16 latent
    factors through a fixed mix plus 5 % noise, so that normal windows lie
    near a low-dimensional surface in [0, 1]^1728.  The planted anomaly, a
    slip seen by one sensor: the anomalous rows' first 432 features (a
    quarter of the window) move by +0.25."""
    n = n_normal + n_anomalous
    z = torch.randn(n, mix.shape[0], generator=gen, device="cuda")
    noise = torch.randn(n, mix.shape[1], generator=gen, device="cuda")
    x = torch.sigmoid(z @ mix + 0.05 * noise)
    x[n_normal:, :432] += 0.25
    return x


def nap_score_f64(stats, x: torch.Tensor) -> torch.Tensor:
    """The unfolded NAP score of fp32 stats and diffs, computed in float64."""
    f = lambda t: t.double()  # noqa: E731
    t = ((f(x) - f(stats.rotater.mu)) @ f(stats.rotater.v)
         - f(stats.standardizer.mu)) / torch.sqrt(f(stats.standardizer.var))
    return (t * t).mean(dim=-1)


def nap_score_staged(pack, x: torch.Tensor) -> torch.Tensor:
    """`nap_score_plain` with an fp32 pack's K summed in the kernels'
    order: each NAP_STAGE-deep slice of (x - rot_mu) @ V a product of its
    own, added to the running total in slice order (a bf16 pack: the plain
    version itself).  The checks on a trained detector's whitening stats,
    near-degenerate, hold the kernel to this form: they amplify the
    rounding of a sum over K, and one product over all of K rounds in
    another order."""
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_score_plain,
    )

    if pack.vt.dtype != torch.float32:
        return nap_score_plain(pack, x)
    xc, v = x.float() - pack.mu, pack.v.float()
    rot = xc[:, :NAP_STAGE] @ v[:NAP_STAGE]
    for k0 in range(NAP_STAGE, pack.k, NAP_STAGE):
        rot.addmm_(xc[:, k0:k0 + NAP_STAGE], v[k0:k0 + NAP_STAGE])
    t = (rot - pack.std_mu) * pack.inv_std
    return (t * t).sum(dim=-1) / pack.j


def run_nap_vs_plain(cfg, res, valid_x, test_x, path="train_and_score",
                     lo_half: bool = True):
    """The NAP kernel against its plain version in the kernels' order of
    sums (`nap_score_staged`) on the fp32 pack of the stats `run` fitted
    and saved, and on the valid and test concat diffs it scored, on
    `path`; the kernel's test scores must be the report's.  Both, and the
    one-product plain version, also face a float64 transform of the same
    diffs, on whitening stats that a trained model's low-rank diffs make
    near-degenerate: the kernel must be within F64_NAP_MAX_REL of it or no
    farther than the one-product form.  `lo_half` runs the bf16 lo-half
    check on those stats.  Returns (worst abs err, pack, test diffs) for
    the times."""
    from icra2021_multimodal_ad_tpu_torch.models.autoencoder import ae_pack
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_pack,
        nap_score,
        nap_score_plain,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.rapp import get_diffs
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
        concat_diffs,
        load_nap_stats,
    )

    model = res.train.model
    pack = ae_pack(model)
    end = cfg.n_layers + 1 - cfg.end_layer_index
    stats = load_nap_stats(cfg.train_diffs).to("cuda")
    npack = nap_pack(stats, torch.float32)
    tol = KERNEL_TOL[torch.float32]
    worst, checks = 0.0, []
    for name, x in (("valid", valid_x), ("test", test_x)):
        cat = concat_diffs(get_diffs(x, model, batch_size=cfg.batch_size,
                                     pack=pack), cfg.start_layer_index, end)
        got = nap_score(npack, cat)
        torch.cuda.synchronize()
        ref, plain = nap_score_staged(npack, cat), nap_score_plain(npack, cat)
        f64 = nap_score_f64(stats, cat).cpu()
        err = float((got - ref).abs().max())
        row = dict(phase="kernel_vs_plain", kernel="nap_score",
                   case=f"{path} {name}", b=int(cat.shape[0]),
                   k=npack.k, j=npack.j, dtype="torch.float32",
                   min_var=float(stats.standardizer.var.min()),
                   reference="staged", max_abs_err=err,
                   max_rel_err=float(((got - ref).abs() / ref.abs()).max()),
                   one_product_max_rel_err=max_rel(got, plain.cpu()),
                   kernel_vs_f64_max_rel=max_rel(got, f64),
                   staged_vs_f64_max_rel=max_rel(ref, f64),
                   plain_vs_f64_max_rel=max_rel(plain, f64),
                   tol=tol, ok=bool(torch.allclose(got, ref, **tol)))
        if name == "test":
            row["equals_report"] = bool(np.array_equal(got.cpu().numpy(),
                                                       res.nap.score))
        checks.append(row)
        emit(**row)
        worst = max(worst, err)
    for row in checks:
        require(row["ok"], f"nap_score {row['case']} disagrees with its "
                           f"plain version in its order of sums (max abs "
                           f"err {row['max_abs_err']})")
        require(row["kernel_vs_f64_max_rel"] <= max(
            F64_NAP_MAX_REL, row["plain_vs_f64_max_rel"]),
            f"nap_score {row['case']}: max rel "
            f"{row['kernel_vs_f64_max_rel']} from float64, beyond "
            f"{F64_NAP_MAX_REL} and its one-product plain version's "
            f"{row['plain_vs_f64_max_rel']}")
    require(checks[-1]["equals_report"],
            f"{path}: the NAP kernel's test scores differ from the NAP "
            f"report")
    if lo_half:
        lo_half_check(f"{path} test", stats, cat)
    return worst, npack, cat


def phase5_windows(cfg):
    """Phase 5's seeded windows on the card: (train, valid, test, test
    labels), half the test rows anomalous."""
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    mix = torch.randn(16, cfg.input_size, generator=gen, device="cuda")
    train_x = seeded_windows(TRAIN_ROWS, 0, gen, mix)
    valid_x = seeded_windows(VALID_ROWS, 0, gen, mix)
    test_x = seeded_windows(TEST_ROWS // 2, TEST_ROWS // 2, gen, mix)
    test_y = np.r_[np.zeros(TEST_ROWS // 2), np.ones(TEST_ROWS // 2)]
    torch.cuda.synchronize()
    return train_x, valid_x, test_x, test_y


def want_run_launches(cfg) -> int:
    """FC launches of `novelty_detection.run` on phase 5's windows: each
    epoch's validation pass (both modules) and the three diff
    extractions (three module passes each)."""
    chunks = lambda n: -(-n // cfg.batch_size)  # noqa: E731
    return (cfg.n_epochs * chunks(VALID_ROWS) * 2 * cfg.n_layers
            + sum(chunks(n) for n in (TRAIN_ROWS, VALID_ROWS, TEST_ROWS))
            * 3 * cfg.n_layers)


def phase_train_and_score():
    from icra2021_multimodal_ad_tpu_torch.models.autoencoder import ae_pack
    from icra2021_multimodal_ad_tpu_torch.novelty_detection import run
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score
    from icra2021_multimodal_ad_tpu_torch.ops.rapp import get_diffs
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import nap_fit
    from icra2021_multimodal_ad_tpu_torch.train import eval_epoch

    cfg = canonical_config().replace(
        n_epochs=3, verbose=0,
        saved_name=os.path.join(RUN_DIR, "model"),
        train_diffs=os.path.join(RUN_DIR, "nap_stats.npz"),
        data=RUN_DIR, saved_result="train_and_score")
    train_x, valid_x, test_x, test_y = phase5_windows(cfg)

    # the train-and-score path: counts start at 0 here and are read right
    # after
    reset_counts()
    t0 = time.perf_counter()
    res = run(cfg, train_x, valid_x, test_x, test_y)
    wall_s = time.perf_counter() - t0
    launches = read_counts()

    want_fc = want_run_launches(cfg)
    tr, va = res.train.train_history, res.train.valid_history
    best = int(np.argmin(va))
    restored = float(eval_epoch(res.train.model, valid_x,
                                cfg.batch_size)) / VALID_ROWS
    reports = {"base": res.base, "sap": res.sap, "nap": res.nap}
    # the NAP fit alone, on the same train diffs: the largest single cost
    pack = ae_pack(res.train.model)
    train_cat = torch.cat(get_diffs(train_x, res.train.model,
                                    batch_size=cfg.batch_size, pack=pack),
                          dim=-1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = nap_fit(train_cat)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    row = dict(
        phase="train_and_score", rows=[TRAIN_ROWS, VALID_ROWS, TEST_ROWS],
        batch_size=cfg.batch_size, n_epochs=cfg.n_epochs, lr=cfg.lr,
        train_history=tr, valid_history=va, best_epoch=best,
        restored_valid_loss=restored,
        auroc={k: r.auroc for k, r in reports.items()},
        aupr={k: r.aupr for k, r in reports.items()},
        f1={k: r.f1 for k, r in reports.items()},
        train_epoch_ms=res.train.train_ms, eval_ms=res.train.eval_ms,
        test_seconds=res.test_seconds, run_seconds=wall_s,
        nap_fit_seconds=fit_s, nap_k_j=list(stats.rotater.v.shape),
        launches=launches, want_fused_mlp=want_fc,
        csv=os.path.relpath(res.csv_path, ROOT))
    emit(**row)
    require(all(np.isfinite(tr)) and all(np.isfinite(va)),
            "non-finite losses")
    require(tr[-1] < tr[0], f"train loss did not fall: {tr}")
    require(abs(restored - va[best]) <= 1e-5 * abs(va[best]),
            f"returned model's valid loss {restored} is not the minimum "
            f"{va[best]}")
    require(launches["fc_layers"] == want_fc,
            f"{launches['fc_layers']} FC layers on the kernel, not the "
            f"{want_fc} of the validation passes and the test diffs")
    require(launches["nap_score"] == 2, "test NAP skipped the NAP kernel")
    for k, r in reports.items():
        require(np.isfinite(r.score).all() and r.score.shape == (TEST_ROWS,)
                and np.isfinite([r.auroc, r.aupr]).all(),
                f"{k} report is not finite")
    require(os.path.exists(res.csv_path), "no result CSV")
    return (launches, *run_nap_vs_plain(cfg, res, valid_x, test_x))


def frontend_golden(golden_rel: float) -> dict:
    """7a: the golden fixture from its CSV: read by the native reader, fused
    on the card with the checkpoint's seed (7), scored through both kernels
    by the fixture CLI's `run_full_test`; the windows must equal the
    committed ones and the scores the golden column."""
    from icra2021_multimodal_ad_tpu_torch.config import Config
    from icra2021_multimodal_ad_tpu_torch.data.dataset import preprocess
    from icra2021_multimodal_ad_tpu_torch.data.fixture import fixture_inputs
    from icra2021_multimodal_ad_tpu_torch.full_test import run_full_test
    from icra2021_multimodal_ad_tpu_torch.ops.fusion import (
        FusionParams,
        fuse,
        fusion_init,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score

    cfg = Config(saved_name=os.path.join(GOLDEN, "model"),
                 train_diffs=os.path.join(GOLDEN, "nap_stats.npz"))
    # the fixture scorer's path: counts start at 0 here, read right after
    reset_counts()
    res = run_full_test(cfg, os.path.join(GOLDEN, "caltime_test.csv"))
    torch.cuda.synchronize()
    launches = read_counts()
    got = res.windows.cpu().numpy()
    want = np.load(os.path.join(GOLDEN, "fixture_windows.npz"))["x"]
    diff = np.abs(got.astype(np.float64) - want)
    nonzero = want != 0
    col = res.columns["nap_score"]
    rel = max_rel(torch.from_numpy(res.scores), col)
    # both fp32 windows against the same convs in float64 on the same fp32
    # inputs: rounding of a summation order, or a fault of the port
    params = fusion_init(res.config.seed)
    p64 = FusionParams(*({k: v.double() for k, v in p.items()}
                         for p in params))
    inputs = preprocess(**fixture_inputs(res.columns, res.config))
    x64 = fuse(p64, sensor=res.config.sensor,
               **{k: v.double() for k, v in inputs.items()}).cpu().numpy()
    f64_err = {name: float(np.abs(w.astype(np.float64) - x64).max())
               for name, w in (("card", got), ("committed", want))}
    emit(phase="frontend_golden", reader=res.reader, seed=res.config.seed,
         windows=list(got.shape),
         window_max_abs_diff=float(diff.max()),
         window_max_rel_diff=float((diff[nonzero]
                                    / np.abs(want[nonzero])).max()),
         window_max_diff_over_max_abs=float(diff.max() / np.abs(want).max()),
         window_max_abs_err_vs_float64=f64_err, window_tol=WINDOW_TOL,
         fp32_max_rel_err=rel, committed_windows_max_rel_err=golden_rel,
         rtol=2e-3, launches=launches)
    require(res.reader == "native", f"the fixture was read by {res.reader}")
    require(res.config.seed == 7, f"fixture fused with seed {res.config.seed}")
    require(f64_err["card"] <= 4 * f64_err["committed"] + 1e-7,
            f"card windows {f64_err['card']} from float64, JAX's "
            f"{f64_err['committed']}")
    require(np.allclose(got, want, **WINDOW_TOL),
            f"windows from the CSV differ from the committed ones by "
            f"{diff.max()}")
    require(np.allclose(res.scores, col, rtol=2e-3),
            f"golden from the CSV: max rel err {rel} above rtol 2e-3")
    # one diff extraction of 10 windows, every layer on the kernel: three
    # fp32 module launches, and one NAP launch
    want = {"fc_layers": 3 * res.config.n_layers, "fused_mlp_module": 3,
            "nap_score": 1, "nap_score_small": 1}
    require({k: launches[k] for k in want} == want,
            f"the fixture launched {launches}, want {want}")
    return launches


def unfilter_per_byte(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, stride) bytes of one frame's (H, 1 + stride) filtered scanlines,
    rebuilt one byte at a time in Python as data/png.py did before its
    batched C unfilter: phase 7c's yardstick for the decode time."""
    ftypes, px = rows[:, 0], rows[:, 1:]
    h, stride = px.shape
    out = np.empty((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        f, line = int(ftypes[y]), px[y]
        if f == 0:
            cur = line.copy()
        elif f == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:
            cur = line + prev
        else:
            raw, up, rec = line.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = up[i]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                rec[i] = (raw[i] + pred) & 0xFF
            cur = np.asarray(rec, dtype=np.uint8)
        out[y] = cur
        prev = cur
    return out


def png_decode_compare(paths, smi: str) -> dict:
    """7c: the build's first PNG_SAMPLE distinct hand frames, read and
    inflated, then unfiltered three ways: one byte at a time in Python (the
    decoder before the batched one), data/png.py's numpy plain version, and
    its C unfilter on the whole batch.  All three must agree."""
    from icra2021_multimodal_ad_tpu_torch.data import png

    paths = paths[:PNG_SAMPLE]
    t0 = time.perf_counter()
    parsed = [png._parse(png._read(p), p) for p in paths]
    read_s = time.perf_counter() - t0
    ch = parsed[0][2]
    rows = np.stack([r for *_, r in parsed])
    t0 = time.perf_counter()
    per_byte = np.stack([unfilter_per_byte(r, ch) for r in rows])
    per_byte_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = png._unfilter_plain(rows, ch)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = png._unfilter(rows, ch)
    native_s = time.perf_counter() - t0
    filters = np.bincount(rows[:, :, 0].ravel(), minlength=5)
    us = lambda sec: sec / len(paths) * 1e6  # noqa: E731
    row = dict(phase="frontend_png_unfilter", frames=len(paths),
               shape=list(per_byte.shape[1:]),
               rows_by_filter=filters.tolist(),
               read_inflate_us_per_frame=us(read_s),
               per_byte_python_us_per_frame=us(per_byte_s),
               numpy_plain_us_per_frame=us(plain_s),
               native_us_per_frame=us(native_s), route=png.unfilter_route(),
               card=smi)
    emit(**row)
    require(np.array_equal(plain, per_byte) and np.array_equal(native,
                                                               per_byte),
            "the three PNG unfilters disagree")
    return row


def png_probe_check(smi: str) -> dict:
    """7c: a 640 x 480 RGB frame written by the port's encoder, decoded and
    resized to 32 x 24 as PIL resizes it (the committed array), timed."""
    from icra2021_multimodal_ad_tpu_torch.data import png

    path = os.path.join(RUN_DIR, "png_probe.png")
    png.write(path, png_probe_frame())
    want = np.load(PNG_PROBE_EXPECTED)
    got = png.decode_resized(path, (32, 24))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        png.decode_resized(path, (32, 24))
        times.append((time.perf_counter() - t0) * 1e3)
    row = dict(phase="frontend_png_probe", size=list(PNG_PROBE_SIZE),
               to=[32, 24], bytes=os.path.getsize(path),
               equal_to_pil=bool(np.array_equal(got, want)),
               max_abs_diff=int(np.abs(got.astype(int) - want).max()),
               decode_resize_ms=statistics.median(times), card=smi)
    emit(**row)
    require(row["equal_to_pil"], f"the 640 x 480 probe's resize differs "
                                 f"from PIL's by {row['max_abs_diff']}")
    return row


def frontend_cli(smi: str, seen: set):
    """7b: the train CLI at full width on synthetic shards written here:
    `novelty_detection.main` at Config() defaults (3 epochs), cold; both
    kernels against their plain versions on its inputs, and their times
    there; then `main` again on the warm feature cache.  7c: the
    frontend's times, the PNG unfilters side by side and the 640 x 480
    frame.  Returns (launches, worst abs err, time rows) by kernel, and
    the CLI's train and test diffs with the test labels for phase 10."""
    from icra2021_multimodal_ad_tpu_torch.data.dataset import image_paths
    from icra2021_multimodal_ad_tpu_torch.data.synthetic import (
        generate_data_sum_shards,
    )
    from icra2021_multimodal_ad_tpu_torch.models.autoencoder import ae_pack
    from icra2021_multimodal_ad_tpu_torch.novelty_detection import main
    from icra2021_multimodal_ad_tpu_torch.train import binarize_labels
    from icra2021_multimodal_ad_tpu_torch.ops.rapp import get_diffs
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import nap_fit
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score

    root = os.path.join(RUN_DIR, "frontend")
    shutil.rmtree(root, ignore_errors=True)
    shards = os.path.join(root, "dsum")
    t0 = time.perf_counter()
    generate_data_sum_shards(shards, n_episodes=CLI_EPISODES,
                             steps_per_episode=CLI_STEPS,
                             n_shards=CLI_SHARDS, seed=0)
    write_s = time.perf_counter() - t0
    shard_bytes = sum(os.path.getsize(os.path.join(shards, f))
                      for f in os.listdir(shards) if f.endswith(".csv"))
    # the CLI's default verbose (2): the per-epoch mode, with its lines
    cfg = canonical_config().replace(
        n_epochs=3, data_folder_name=shards + "/",
        saved_name=os.path.join(root, "model"),
        train_diffs=os.path.join(root, "nap_stats.npz"),
        saved_result=os.path.join(root, "cli_run"))

    # the train CLI's path: counts start at 0 here and are read right after
    reset_counts()
    t0 = time.perf_counter()
    cold = main(cfg)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_counts()

    # both kernels against their plain versions on the CLI's own inputs,
    # before the second run rewrites the checkpoint and the NAP stats
    res = cold.run
    model = res.train.model
    windows = {split: cold.manager.get_transformed_data(loader)[0]
               for split, loader in zip(("train", "valid", "test"),
                                        cold.loaders)}
    test_label = binarize_labels(cfg, cold.manager.get_transformed_data(
        cold.loaders[2])[1].cpu().numpy())
    worst = {"fused_mlp": path_mlp_vs_plain("frontend_cli", model, windows,
                                            seen)}
    worst["nap_score"], npack, test_cat = run_nap_vs_plain(
        cfg, res, windows["valid"], windows["test"], path="frontend_cli")
    # both kernels' times at the CLI's shapes: NAP on the test diffs, the
    # widest FC layer on the train chunk
    flush = l2_flush()
    rows = {"nap_score": nap_times(npack, test_cat, flush),
            "fused_mlp": dict(layer="encoder.0", **mlp_times(
                ae_pack(model).encoder.layers[0], windows["train"], flush))}
    for name, row in rows.items():
        row.update(dtype="float32", path="frontend_cli")
        emit(phase="times", kernel=name, **row)
    del flush

    t0 = time.perf_counter()
    warm = main(cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ds, ds_warm = cold.manager.train_dataset, warm.manager.train_dataset

    # the NAP fit alone, the bulk of the test time, at the CLI's rows and
    # at the default split's: on the CLI's train diffs, on them tiled to
    # the default rows (the same right singular vectors and conditioning),
    # and on random diffs of both shapes (the spectrum's share)
    train_cat = torch.cat(get_diffs(windows["train"], model,
                                    batch_size=cfg.batch_size,
                                    pack=ae_pack(model)), dim=-1)
    g = torch.Generator(device="cuda").manual_seed(cfg.seed)
    k_cat = train_cat.shape[1]
    fit_inputs = {
        "cli": lambda: train_cat,
        "cli_tiled": lambda: train_cat.repeat(
            DEFAULT_FIT_ROWS // train_cat.shape[0], 1),
        "random": lambda: torch.randn(train_cat.shape[0], k_cat,
                                      generator=g, device="cuda"),
        "random_default": lambda: torch.randn(DEFAULT_FIT_ROWS, k_cat,
                                              generator=g, device="cuda")}
    fit_s = {}
    for name, make in fit_inputs.items():
        x = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nap_fit(x)
        torch.cuda.synchronize()
        fit_s[f"nap_fit_s_{name}_{x.shape[0]}x{x.shape[1]}"] = (
            time.perf_counter() - t0)
        del x
    sizes = cold.split_sizes
    chunks = lambda n: -(-n // cfg.batch_size)  # noqa: E731
    want_fc = (cfg.n_epochs * chunks(sizes["valid"]) * 2 * cfg.n_layers
               + sum(chunks(sizes[k]) for k in ("train", "valid", "test"))
               * 3 * cfg.n_layers)
    reports = {"base": res.base, "sap": res.sap, "nap": res.nap}
    n = len(cold.manager.total_x)
    emit(phase="frontend_cli", rows=n, shards=CLI_SHARDS,
         shard_csv_bytes=shard_bytes, split_sizes=sizes,
         readers=ds.readers, cache_hit=[ds.cache_hit, ds_warm.cache_hit],
         windows_bit_equal_on_cache_hit=bool(torch.equal(
             cold.manager.total_x, warm.manager.total_x)),
         auroc={k: r.auroc for k, r in reports.items()},
         aupr={k: r.aupr for k, r in reports.items()},
         warm_auroc={k: getattr(warm.run, k).auroc for k in reports},
         train_history=res.train.train_history,
         valid_history=res.train.valid_history,
         launches=launches, want_fused_mlp=want_fc,
         csv=os.path.relpath(res.csv_path, ROOT))
    require(ds.readers == ["native"] * CLI_SHARDS,
            f"the shards were read by {ds.readers}, not the native reader")
    require(ds.png_unfilter == "native",
            f"the frames were unfiltered by {ds.png_unfilter}, not the C "
            f"unfilter")
    require(not ds.cache_hit and ds_warm.cache_hit,
            f"feature cache hits {ds.cache_hit}, {ds_warm.cache_hit}: "
            f"want a cold build, then a hit")
    require(torch.equal(cold.manager.total_x, warm.manager.total_x)
            and torch.equal(cold.manager.total_y, warm.manager.total_y),
            "the cached windows differ from the built ones")
    require(sizes == CLI_SPLIT, f"split sizes {sizes}, not {CLI_SPLIT}")
    require(launches["fc_layers"] == want_fc,
            f"{launches['fc_layers']} FC layers on the kernel, not {want_fc}")
    require(launches["nap_score"] == 2, "test NAP skipped the NAP kernel")
    for k, r in reports.items():
        require(np.isfinite([r.auroc, r.aupr]).all()
                and np.isfinite(r.score).all(), f"{k} report is not finite")
    require(os.path.exists(res.csv_path), "no result CSV")

    # 7c: each time on its own line, beside the card
    sec = ds.seconds
    hand = list(dict.fromkeys(image_paths(
        cfg.data_folder_name, ds.columns["data_dir"],
        ds.columns["cur_hand_id"], "hand")))
    depth = set(image_paths(cfg.data_folder_name, ds.columns["data_dir"],
                            ds.columns["cur_depth_id"], "d"))
    unfilter = png_decode_compare(hand, smi)
    png_probe_check(smi)
    frames = len(hand) + len(depth)
    for name, value in (
            ("shard_write_s", write_s), ("csv_read_native_s", sec["read_csv"]),
            ("png_decode_s", sec["decode_png"]),
            ("png_per_s", 2 * n / sec["decode_png"]),
            ("png_distinct_frames", frames),
            ("png_decode_s_per_byte_python_projected",
             frames * (unfilter["read_inflate_us_per_frame"]
                       + unfilter["per_byte_python_us_per_frame"]) / 1e6),
            ("upload_ms", sec["upload"] * 1e3),
            ("fuse_ms", sec["fuse"] * 1e3),
            ("fuse_windows_per_s", n / sec["fuse"]),
            ("train_epoch_ms", res.train.train_ms),
            ("valid_pass_ms", res.train.eval_ms),
            ("test_s", res.test_seconds), *fit_s.items(),
            ("dataset_build_cold_s", sec["total"]),
            ("dataset_build_warm_s", ds_warm.seconds["total"]),
            ("main_cold_s", cold_s), ("main_warm_s", warm_s)):
        emit(phase="frontend_times", metric=name, value=value, card=smi)
    return launches, worst, rows, dict(train_cat=train_cat, test_cat=test_cat,
                                       label=test_label)


def mfcc_f64(y: np.ndarray, sr: int) -> np.ndarray:
    """The MFCC pipeline of ops/mfcc.py in float64 numpy, on the port's
    float32 constants: the yardstick of the card's fp32 MFCC."""
    from icra2021_multimodal_ad_tpu_torch.ops import mfcc

    n_fft = int(round(sr * 0.1))
    y = np.asarray(y, dtype=np.float64)
    pad = n_fft // 2
    yp = np.pad(y, (pad, n_fft - pad), mode="reflect")
    n = 1 + (len(y) + 2 * pad - n_fft) // n_fft
    frames = yp[: n * n_fft].reshape(n, n_fft) * mfcc._hann_periodic(n_fft)
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    S = mfcc.mel_filterbank(sr, n_fft).astype(np.float64) @ power.T
    db = (10 * np.log10(np.maximum(S, 1e-10))
          - 10 * np.log10(max(S.max(), 1e-10)))
    db = np.maximum(db, db.max() - 80.0)
    return (mfcc.dct_matrix(13, S.shape[0]).astype(np.float64) @ db).T


def mfcc_check(case: str, got, want: np.ndarray) -> float:
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float64)
    err = float(np.abs(got - want).max())
    ok = got.shape == want.shape and bool(np.allclose(got, want, **MFCC_TOL))
    emit(phase="streaming_mfcc", case=case, shape=list(got.shape),
         max_abs_err_vs_float64=err,
         max_rel_err_vs_float64=float((np.abs(got - want)
                                       / np.abs(want)).max()),
         tol=MFCC_TOL, ok=ok)
    require(ok, f"MFCC {case} differs from float64 by {err}")
    return err


def ring_snapshot(src):
    return (src.force_q.snapshot(), src.hand_q.snapshot(),
            src.depth_q.snapshot())


def mfcc_captured(chunks, rt):
    """The tick's MFCC as a captured program of one slot: (its frames, a
    call that stages the wave and replays it)."""
    from icra2021_multimodal_ad_tpu_torch.ops.mfcc import (
        floored_wave,
        mfcc_program,
    )

    wave = floored_wave(chunks, rt, 1.0)
    out = torch.empty(rt.batch_size, 13, device=DEV)
    prog = mfcc_program(len(wave), rt.batch_size, out, slots=1)

    def replay():
        prog.staging(0)[0][:] = wave
        prog.launch(0)

    replay()
    prog.wait(0)
    return out, replay


def streaming_mfcc(rt):
    """8a: both realtime MFCC variants on the card, on an aligned ring (12
    windows of 4410 samples) and on the simulator's unaligned one, and
    `mfcc_from_wave` at 22,050 Hz (n_fft 2205, odd), against float64; the
    captured MFCC program bit-equal to the device variant on both rings.
    Returns the tick's MFCC ms on the simulator's ring, eager and
    captured."""
    from icra2021_multimodal_ad_tpu_torch.data.streaming import (
        SimulatedSensors,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.mfcc import (
        mfcc_from_int16_chunks,
        mfcc_from_int16_chunks_device,
        mfcc_from_wave,
    )

    rng = np.random.default_rng(11)
    src = SimulatedSensors(rt.batch_size, seed=11)
    src.fill(12)
    rings = {"aligned": [rng.integers(-3000, 3000, 4410,
                                      dtype=np.int16).tobytes()
                         for _ in range(12)],
             "unaligned": src.mic_q.snapshot()}
    b = rt.batch_size
    for name, chunks in rings.items():
        y = np.frombuffer(b"".join(chunks), np.int16).astype(np.float32)
        yf = y[len(y) - (len(y) // 4410) * 4410:]
        mfcc_check(f"host variant, {name} ring ({len(y)} samples)",
                   mfcc_from_int16_chunks(chunks, rt, 1.0, device=DEV),
                   mfcc_f64(y, 44100)[-b:])
        eager = mfcc_from_int16_chunks_device(chunks, rt, 1.0, device=DEV)
        mfcc_check(f"device variant, {name} ring ({len(yf)} samples kept)",
                   eager, mfcc_f64(yf, 44100)[-b:])
        captured, _ = mfcc_captured(chunks, rt)
        same = bool(torch.equal(captured, eager))
        emit(phase="mfcc_captured", ring=name, samples=len(yf),
             bit_equal_to_eager=same,
             max_rel_err=float(((captured - eager).abs()
                                / eager.abs()).max()))
        require(same, f"the captured MFCC program differs from the eager "
                      f"device variant on the {name} ring")
    y22 = rng.normal(0, 0.05, 132437).astype(np.float32)
    mfcc_check("mfcc_from_wave 22050 Hz", mfcc_from_wave(y22, sr=22050,
                                                         device=DEV),
               mfcc_f64(y22, 22050))
    _, replay = mfcc_captured(rings["unaligned"], rt)
    return {"eager_ms": wall_ms(lambda: mfcc_from_int16_chunks_device(
        rings["unaligned"], rt, 1.0, device=DEV)),
        "captured_ms": wall_ms(replay)}


def streaming_windows(rt, fp, seed: int, n_ticks: int,
                      anomaly: bool = False) -> torch.Tensor:
    """(10 x n_ticks, 1728) windows of the simulator, one batch per tick,
    through `get_realtime_dataloader`; an anomalous run keeps its last
    n_ticks batches, after the drop has filled the rings."""
    from icra2021_multimodal_ad_tpu_torch.data.streaming import (
        SimulatedSensors,
        get_realtime_dataloader,
    )

    src = SimulatedSensors(rt.batch_size, seed=seed)
    src.fill(12)
    out = []
    for _ in range(n_ticks + (rt.batch_size if anomaly else 0)):
        src.tick(anomaly=anomaly)
        out.append(get_realtime_dataloader(rt, fp, *ring_snapshot(src),
                                           src.mic_q.snapshot()))
    return torch.cat(out[-n_ticks:])


def streaming_train(root: str, rt, fp):
    """8b: train a detector on the card from the simulator's normal windows
    with `novelty_detection.run`, its checkpoint and NAP stats under
    `root`; tested on 100 normal and 100 dropping windows."""
    from icra2021_multimodal_ad_tpu_torch.novelty_detection import run

    cfg = canonical_config().replace(
        n_epochs=STREAM_EPOCHS, lr=STREAM_LR, batch_size=64, verbose=0,
        saved_name=os.path.join(root, "model"),
        train_diffs=os.path.join(root, "nap_stats.npz"), data=root,
        saved_result="realtime_train")
    normal = streaming_windows(rt, fp, 7, STREAM_FIT_TICKS)
    n_valid = len(normal) // 5
    test_x = torch.cat([streaming_windows(rt, fp, 8, 10),
                        streaming_windows(rt, fp, 9, 10, anomaly=True)])
    test_y = np.r_[np.zeros(100), np.ones(100)]
    t0 = time.perf_counter()
    res = run(cfg, normal[n_valid:], normal[:n_valid], test_x, test_y,
              device=DEV)
    torch.cuda.synchronize()
    emit(phase="streaming_train", train_rows=len(normal) - n_valid,
         valid_rows=n_valid, test_rows=len(test_x), n_epochs=cfg.n_epochs,
         lr=cfg.lr, batch_size=cfg.batch_size, seconds=time.perf_counter()
         - t0, train_history=res.train.train_history,
         valid_history=res.train.valid_history,
         auroc={k: getattr(res, k).auroc for k in ("base", "sap", "nap")})
    require(all(np.isfinite(res.train.train_history)), "non-finite losses")
    return cfg, res


def captured_vs_eager(name: str, argv: list, trace: np.ndarray) -> dict:
    """A run of `realtime_tester.main` again, from its flags and the same
    simulator seed: each tick's ring snapshots through the eager tick
    (`score_rings_eager`), held bit for bit against the run's captured
    trace.  Where a tick differs, its snapshots go through the captured
    tick again and the MFCC program's frames are held against the eager
    MFCC, to name the program that differs."""
    from icra2021_multimodal_ad_tpu_torch import realtime_tester
    from icra2021_multimodal_ad_tpu_torch.ops.mfcc import (
        mfcc_from_int16_chunks_device,
    )

    args = realtime_tester.parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        rt, det, src = realtime_tester.build(args, device=DEV)
    eager, snaps = [], []
    for i in range(args.ticks):
        src.tick(anomaly=i >= args.anomaly_after)
        snaps.append((*ring_snapshot(src), src.mic_q.snapshot()))
        eager.append(det.score_rings_eager(*snaps[-1], nap=args.nap))
    eager = np.stack(eager)
    bad = np.flatnonzero((eager != trace).any(axis=1))
    row = dict(phase="captured_vs_eager", run=name, ticks=len(eager),
               bit_identical=not bad.size,
               max_rel_err=float(np.max(np.abs(trace - eager)
                                        / np.abs(eager))))
    if bad.size:
        tick = int(bad[0])
        det.score_rings(*snaps[tick], nap=args.nap)
        mic = mfcc_from_int16_chunks_device(snaps[tick][3], rt, 1.0,
                                            device=DEV)
        row.update(first_tick=tick, differs_in=(
            "the tick program (cuDNN convs, cuBLAS, the kernels)"
            if torch.equal(det._mic, mic) else
            "the MFCC program (cuFFT rfft, the mel and DCT cuBLAS GEMMs)"))
    emit(**row)
    require(not bad.size, f"{name}: the captured trace differs from the "
                          f"eager tick's: {row}")
    return row


def streaming_runs(cfg, smi: str, runs: dict = STREAM_RUNS) -> dict:
    """8c (and 11a): `realtime_tester.main` once per run of `runs`; each
    run's counts start at 0 just before it and are read just after; then
    its trace against the eager tick's (`captured_vs_eager`).  Returns
    {run: (trace, launches)}."""
    from icra2021_multimodal_ad_tpu_torch import realtime_tester
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score
    from icra2021_multimodal_ad_tpu_torch.ops.serving import int8_product

    argv = ["--saved_name", cfg.saved_name, "--train_diffs", cfg.train_diffs,
            "--ticks", str(STREAM_TICKS),
            "--anomaly_after", str(STREAM_ANOMALY_AFTER)]
    settled = STREAM_ANOMALY_AFTER + 10
    out = {}
    for name, flags in runs.items():
        nap = "--nap" in flags
        guarded = "--guard_tol" in flags
        int8 = "int8" in flags
        buf = io.StringIO()
        # the streaming path: counts start at 0 here and are read right after
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            trace, stats = realtime_tester.main(argv + flags, device=DEV)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counts()
        log = buf.getvalue()
        # one diff extraction (3 module passes) or one forward (2) per tick,
        # every layer on the kernel: an fp32 tick's 10 windows in one
        # module launch a pass, a bf16 tick's n_layers launches a pass; the
        # guard scores its probe (one tick's windows) once on each of its
        # two bundles, the fp32 one through the one-launch NAP variant; an
        # int8 tick whitens with one int8 GEMM and launches no NAP kernel;
        # every tick's windows and the guard's probe fuse in one front-end
        # launch
        fp32 = "--compute_dtype" not in flags
        passes = STREAM_TICKS * (3 if nap else 2)
        want = {"fused_mlp": (0 if fp32 else passes * cfg.n_layers)
                + (3 * cfg.n_layers if guarded else 0),
                "fused_mlp_module": (passes if fp32 else 0)
                + (3 if guarded else 0),
                "fc_layers": passes * cfg.n_layers
                + (2 * 3 * cfg.n_layers if guarded else 0),
                "nap_score": (STREAM_TICKS if nap and not int8 else 0)
                + (1 if guarded else 0) + (1 if guarded and not int8
                                           else 0),
                "nap_score_small": (STREAM_TICKS if nap and fp32 else 0)
                + (1 if guarded else 0),
                "int8_product": (STREAM_TICKS + guarded) if int8 else 0,
                "frontend_fuse": STREAM_TICKS + guarded}
        guard = re.search(r"rel err ([0-9.]+) <= tol ([0-9.]+)", log)
        pre = float(trace[:STREAM_ANOMALY_AFTER].mean())
        post = float(trace[settled:].mean())
        row = dict(phase="streaming_run", run=name, flags=flags,
                   trace_shape=list(trace.shape), ticks=stats["ticks"],
                   p50_ms=stats["p50_ms"], p95_ms=stats["p95_ms"],
                   mean_ms=stats["mean_ms"], wall_s=wall_s,
                   launches=launches, want_launches=want,
                   fc_launches_per_tick=(3 if nap else 2) * (
                       1 if fp32 else cfg.n_layers),
                   nap_launches_per_tick=int(nap),
                   mean_before=pre, mean_after=post, after_over_before=post
                   / pre, guard_line=guard.group(0) if guard else None,
                   latency_line=next((ln for ln in log.splitlines()
                                      if ln.startswith("latency:")), None),
                   card=smi)
        emit(**row)
        require(trace.shape == (STREAM_TICKS, 10)
                and bool(np.isfinite(trace).all()),
                f"{name}: trace {trace.shape} not finite (60, 10)")
        require(launches == want, f"{name}: launches {launches}, want {want}"
                                  f" (every tick through the kernels)")
        captured_vs_eager(name, argv + flags, trace)
        if name in ("fp32_base", "fp32_nap", "int8_nap_guarded"):
            require(post > 2.0 * pre, f"{name}: after the drop {post}, "
                                      f"before {pre}: not above 2x")
        if guarded:
            require(guard is not None and float(guard.group(1))
                    <= float(guard.group(2)),
                    f"{name}: no guard line within its tolerance: "
                    f"{guard and guard.group(0)}")
        out[name] = (trace, launches)
    if "fp32_nap_pipelined" in out:
        require(np.array_equal(out["fp32_nap_pipelined"][0],
                               out["fp32_nap"][0]),
                "the pipelined trace differs from the sequential one")
        emit(phase="streaming_pipelined", bit_identical=True)
    return out


def streaming_kernels(cfg, rt, fp, seen: set, flush):
    """8d: the kernels against their plain versions on one tick's own
    inputs (B = 10): the FC kernel at every layer input of the tick's diff
    extraction, and the NAP kernel on its concat diffs, in fp32 (un-floored
    stats, as the fp32 tick) and bf16 (floored stats, as the bf16 tick),
    and the front end on the tick's staged payloads; then the kernels'
    times there.  Returns (worst abs err, time rows), by kernel."""
    from icra2021_multimodal_ad_tpu_torch.data.streaming import (
        SimulatedSensors,
        _stack_host_inputs,
        hsr_window_batch,
    )
    from icra2021_multimodal_ad_tpu_torch.models.autoencoder import ae_pack
    from icra2021_multimodal_ad_tpu_torch.models.builder import load_model
    from icra2021_multimodal_ad_tpu_torch.ops.frontend_kernel import (
        frontend_fuse,
        frontend_fuse_plain,
        stage,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.mfcc import (
        mfcc_from_int16_chunks_device,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_score,
        nap_score_plain,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import load_nap_stats
    from icra2021_multimodal_ad_tpu_torch.ops.serving import (
        cast_floats,
        make_serving,
    )

    _, model = load_model(cfg.saved_name, device=DEV)
    stats = load_nap_stats(cfg.train_diffs)
    src = SimulatedSensors(rt.batch_size, seed=21)
    src.fill(12)
    mic = mfcc_from_int16_chunks_device(src.mic_q.snapshot(), rt, 1.0,
                                        device=DEV)
    x = hsr_window_batch(rt, fp, *ring_snapshot(src), mic)
    worst = {"fused_mlp": 0.0, "nap_score": 0.0}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        m = model if dtype == torch.float32 else cast_floats(model, dtype)
        worst["fused_mlp"] = max(worst["fused_mlp"], path_mlp_vs_plain(
            f"streaming {name}", m, {"tick": x.to(dtype)}, seen, dtype))
        serv = make_serving(rt.replace(compute_dtype=name), model,
                            nap_stats=stats, device=DEV)
        cat = serv.nap_diffs(x)
        got = nap_score(serv.nap_pack, cat)
        torch.cuda.synchronize()
        ref = nap_score_staged(serv.nap_pack, cat)
        err = float((got - ref).abs().max())
        ok = bool(torch.allclose(got, ref, **KERNEL_TOL[dtype]))
        emit(phase="kernel_vs_plain", kernel="nap_score",
             case=f"streaming tick {dtype}", b=int(cat.shape[0]),
             k=serv.nap_pack.k, j=serv.nap_pack.j, dtype=str(dtype),
             min_var=float(serv.nap_stats.standardizer.var.min()),
             reference="staged", max_abs_err=err,
             max_rel_err=float(((got - ref).abs() / ref.abs()).max()),
             one_product_max_rel_err=max_rel(
                 got, nap_score_plain(serv.nap_pack, cat).cpu()),
             tol=KERNEL_TOL[dtype], ok=ok)
        require(ok, f"nap_score on the streaming tick {dtype} disagrees "
                    f"with its plain version in its order of sums (max "
                    f"abs err {err})")
        worst["nap_score"] = max(worst["nap_score"], err)
        if dtype == torch.float32:
            pack = ae_pack(model)
            rows = {"nap_score": nap_times(serv.nap_pack, cat, flush, 0),
                    "nap_score_small": nap_times(serv.nap_pack, cat, flush,
                                                 4),
                    "fused_mlp": dict(layer="encoder.0", **mlp_times(
                        pack.encoder.layers[0], x, flush, 0)),
                    "fused_mlp_module": dict(layer="encoder", **module_times(
                        pack.encoder, x, flush))}
    mods = stage(*(torch.as_tensor(v, device=DEV) for v in _stack_host_inputs(
        rt, *ring_snapshot(src), mic)))
    got, ref = frontend_fuse(fp, *mods), frontend_fuse_plain(fp, *mods)
    torch.cuda.synchronize()
    worst["frontend_fuse"] = float((got - ref).abs().max())
    ok = bool(torch.allclose(got, ref, **FRONTEND_TOL))
    emit(phase="kernel_vs_plain", kernel="frontend_fuse",
         case="streaming tick", b=int(got.shape[0]),
         frames=str(mods[0].dtype), max_abs_err=worst["frontend_fuse"],
         tol=FRONTEND_TOL, ok=ok)
    require(ok, f"frontend_fuse on the streaming tick disagrees with the "
                f"stock ops (max abs err {worst['frontend_fuse']})")
    rows["frontend_fuse"] = frontend_times(fp, mods, flush)
    for name, row in rows.items():
        row.update(dtype="float32", path="streaming")
        emit(phase="times", kernel=name, **row)
    tick_breakdown(rt, model, stats, fp, src, x)
    return worst, rows


def busy_us(kernels) -> float:
    """Length of the union of device events' [start, end) intervals."""
    total, end = 0.0, -1.0
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


#: the device kernels of csrc/, as the profiler names them
OUR_KERNELS = ("fc_module_kernel", "fc_simt_kernel", "fc_wgmma_kernel",
               "nap_small_kernel", "nap_simt_kernel", "nap_wgmma_kernel",
               "nap_center_kernel", "nap_reduce_kernel",
               "frontend_fuse_kernel")
#: parts of the names of cuDNN's convolution kernels
CONV_KERNELS = ("fprop", "convolve", "cudnn")


def profile_calls(fn, calls: int = 10) -> dict:
    """Three warm calls, then `calls` counted calls under the port's
    `utils/profiling.trace` (torch.profiler; the Chrome trace lands in
    build/chip_smoke/trace/), each ending in a synchronize, after one call
    in the window that is not counted: the profiler drops device events of
    a window's first launches now and then, even with its pad (PERF.md §6,
    PR 11).  Of the counted calls: host ms per call, device events per
    call (kernels and copies), the graph launches and kernel launches the
    host made per call (CUDA API calls), the host's launches and copies
    the profiler has no device event for (lost) and the calls they belong
    to, the least and the largest time from a launch on the host to its
    first device event (negative where the profiler moved the card's
    clock early), the process's age, the device's busy share (the union of
    the events' intervals over the calls), the device ms of the busiest
    kernels and cuDNN's convolution kernels per call."""
    from collections import defaultdict

    from torch.autograd import DeviceType

    from icra2021_multimodal_ad_tpu_torch.utils.profiling import trace

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with trace(os.path.join(RUN_DIR, "trace"), device=DEV) as prof:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    api = sorted((e for e in prof.events() if e.device_type == DeviceType.CPU
                  and e.name.startswith("cu")),
                 key=lambda e: e.time_range.start)
    launches = [e for e in api if "Launch" in e.name or "Memcpy" in e.name]
    # every call makes the same launches: the first per_call are the
    # uncounted call's, and its device events carry their correlation ids
    per_call = len(launches) // (calls + 1)
    skipped = {e.id for e in launches[:per_call]}
    if per_call:
        api = [e for e in api
               if e.time_range.start >= launches[per_call].time_range.start]
        launches = launches[per_call:]
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.id not in skipped]
    host = [e.name for e in api]
    # a launch or copy's device events carry its correlation id
    first = {}
    for e in events:
        first[e.id] = min(e.time_range.start,
                          first.get(e.id, e.time_range.start))
    lost = sum(e.id not in first for e in launches)
    lead_us = [first[e.id] - e.time_range.start for e in launches
               if e.id in first]
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.end - e.time_range.start
    busy = busy_us(events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    mine = {k: sum(k in e.name for e in events) / calls for k in OUR_KERNELS}
    return {"call_ms": wall_us / calls / 1e3,
            "kernel_launches_per_call": {k: n for k, n in mine.items() if n},
            "conv_kernels_per_call": sum(
                any(c in e.name for c in CONV_KERNELS) for e in events)
            / calls,
            "graph_launches_per_call": sum(
                "GraphLaunch" in n for n in host) / calls,
            "host_kernel_launches_per_call": sum(
                "LaunchKernel" in n or "LaunchCooperativeKernel" in n
                for n in host) / calls,
            "device_events_per_call": len(events) / calls,
            "device_events_lost": lost,
            "device_events_lost_in_calls": sorted(
                {i // max(per_call, 1) for i, e in enumerate(launches)
                 if e.id not in first}),
            "launch_to_device_ms": ([min(lead_us) / 1e3, max(lead_us) / 1e3]
                                    if lead_us else None),
            "process_s": time.perf_counter() - STARTED,
            "device_busy_ms_per_call": busy / calls / 1e3,
            "device_busy_share": busy / wall_us if events else None,
            "top_device_ms_per_call": {n[:80]: t / calls / 1e3
                                       for n, t in top}}


def tick_breakdown(rt, model, stats, fp, src, x) -> None:
    """Where a tick's time goes: the first captured tick of a fresh
    detector (its programs' warm-up and capture in it), then each stage of
    the eager tick timed alone on the host clock, ending in a synchronize
    (MFCC, stacking + upload + normalize + fuse, the score, the copy to the
    host), then whole ticks, eager (`score_rings_eager`) and captured
    (`score_rings`), timed and under torch.profiler, per configuration.
    The profiler must hold a device event for every launch and copy the
    host made.  A captured tick must be 2 graph launches and no kernel
    launch from the host; an fp32 one must show 2 (BASE) or 3 (NAP)
    whole-module FC launches and one NAP launch per NAP tick in the
    profiler's kernels, and none of the per-layer or three-launch
    variants, as the eager one does; every tick, eager or captured, one
    front-end launch and no cuDNN convolution."""
    from icra2021_multimodal_ad_tpu_torch.data.streaming import (
        StreamingDetector,
        hsr_window_batch,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.mfcc import (
        mfcc_from_int16_chunks_device,
    )

    chunks, snaps = src.mic_q.snapshot(), ring_snapshot(src)
    mic = lambda: mfcc_from_int16_chunks_device(  # noqa: E731
        chunks, rt, 1.0, device=DEV)
    for name in ("float32", "bfloat16"):
        det = StreamingDetector(rt.replace(compute_dtype=name), model, fp,
                                nap_stats=stats, device=DEV)
        serv = det._serving()
        frames = mic()
        for nap in (False, True):
            score = (serv.score_nap_windows if nap else serv.score_fused)
            scores = score(x)
            eager = lambda: det.score_rings_eager(  # noqa: E731
                *snaps, chunks, nap=nap)
            captured = lambda: det.score_rings(  # noqa: E731
                *snaps, chunks, nap=nap)
            # the first captured tick captures its programs (the MFCC
            # program with BASE, the tick program each time)
            t0 = time.perf_counter()
            captured()
            first_ms = (time.perf_counter() - t0) * 1e3
            stages = {"first_captured_tick_ms": first_ms,
                      "mfcc_ms": wall_ms(mic),
                      "stack_upload_fuse_ms": wall_ms(
                          lambda: hsr_window_batch(rt, fp, *snaps, frames)),
                      "score_ms": wall_ms(lambda: score(x)),
                      "scores_to_host_ms": wall_ms(lambda: scores.cpu()),
                      "tick_eager_ms": wall_ms(eager),
                      "tick_captured_ms": wall_ms(captured)}
            profiles = {"eager": profile_calls(eager),
                        "captured": profile_calls(captured)}
            emit(phase="tick_breakdown", dtype=name, nap=nap, **stages,
                 profile=profiles)
            for how, prof in profiles.items():
                require(prof["device_events_lost"] == 0,
                        f"{name} {how} tick (nap {nap}): the profiler has "
                        f"no device event for {prof['device_events_lost']}"
                        f" of the host's launches and copies")
            got = profiles["captured"]
            require(got["graph_launches_per_call"] == 2
                    and got["host_kernel_launches_per_call"] == 0,
                    f"{name} captured tick (nap {nap}): "
                    f"{got['graph_launches_per_call']} graph launches and "
                    f"{got['host_kernel_launches_per_call']} kernel launches"
                    f" from the host per tick, want 2 and 0")
            for how, prof in profiles.items():
                front = (prof["kernel_launches_per_call"].get(
                    "frontend_fuse_kernel"), prof["conv_kernels_per_call"])
                require(front == (1, 0),
                        f"{name} {how} tick (nap {nap}): frontend_fuse_kernel"
                        f" and cuDNN convs per tick {front}, want (1, 0)")
            if name == "float32":
                want = {"fc_module_kernel": 3 if nap else 2,
                        "frontend_fuse_kernel": 1}
                if nap:
                    want["nap_small_kernel"] = 1
                for how, prof in profiles.items():
                    ran = prof["kernel_launches_per_call"]
                    require(ran == want, f"fp32 {how} tick (nap {nap}) ran "
                                         f"{ran} kernels per tick, want "
                                         f"{want}")


def phase_streaming(smi: str, seen: set):
    """Phase 8.  Returns (launches, worst abs err, time rows), by kernel."""
    from icra2021_multimodal_ad_tpu_torch.ops.fusion import fusion_init

    root = os.path.join(RUN_DIR, "realtime")
    shutil.rmtree(root, ignore_errors=True)
    rt = canonical_config().replace(batch_size=10)
    fp = fusion_init(rt.seed, DEV)
    mfcc_ms = streaming_mfcc(rt)
    cfg, _ = streaming_train(root, rt, fp)
    runs = streaming_runs(cfg, smi)
    worst, rows = streaming_kernels(cfg, rt, fp, seen, l2_flush())
    launches = {k: sum(r[1][k] for r in runs.values())
                for k in read_counts()}
    emit(phase="streaming", launches=launches, tick_mfcc=mfcc_ms,
         card=smi)
    return launches, worst, rows, (cfg, rt, fp)


def timegaps(path: str) -> np.ndarray:
    """A raw stream's timegap column, its first data row dropped."""
    with open(path, newline="") as f:
        return np.array([float(r["timegap"])
                         for r in csv.DictReader(f)][1:])


def expected_grid(ep_dir: str, legacy: bool = False):
    """(grid, labels) of one raw episode, read from its CSVs alone: the grid
    from round(max of the depth, LiDAR and weight starts, 1) (the legacy
    variant: round(min of the rgb, depth, LiDAR, weight and microphone
    starts + 1, 1)) to drop_start + 0.5 at 10 Hz, each stream's first data
    row dropped, label 1 inside [drop_start, drop_start + 0.5]."""
    def first_timegap(name):
        return np.float64(timegaps(os.path.join(ep_dir, name))[0])

    if legacy:
        start = round(min(first_timegap(n) for n in (
            "rgb.csv", "depth.csv", "LiDAR.csv", "hand_weight.csv",
            "Microphone.csv")) + 1, 1)
    else:
        start = round(max(first_timegap(n) for n in
                          ("depth.csv", "LiDAR.csv", "hand_weight.csv")), 1)
    with open(os.path.join(ep_dir, "drop_time.csv"), newline="") as f:
        drop = float(next(csv.DictReader(f))["drop_start"])
    n = int(np.floor((drop + 0.5 - start) / 0.1 + 1e-9)) + 1
    grid = np.round(start + 0.1 * np.arange(n), 6)
    return grid, ((grid >= drop) & (grid <= drop + 0.5)).astype(np.int64)


def phase_etl(smi: str) -> dict:
    """Phase 9: raw episodes -> `concatdata_maker.main` on the card ->
    shards, checked and timed."""
    from icra2021_multimodal_ad_tpu_torch import concatdata_maker
    from icra2021_multimodal_ad_tpu_torch.config import Config
    from icra2021_multimodal_ad_tpu_torch.data import etl, fast_csv
    from icra2021_multimodal_ad_tpu_torch.data.dataset import TabularDataset
    from icra2021_multimodal_ad_tpu_torch.data.synthetic import (
        MFCC_COLS,
        generate_raw_episodes,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.mfcc import mfcc_from_wave

    root = os.path.join(RUN_DIR, "etl")
    shutil.rmtree(root, ignore_errors=True)
    raw, out = os.path.join(root, "raw"), os.path.join(root, "shards")
    t0 = time.perf_counter()
    names = generate_raw_episodes(raw, n_episodes=ETL_EPISODES,
                                  duration_s=ETL_SECONDS, seed=0)
    generate_s = time.perf_counter() - t0
    argv = ["--data_dir", os.path.join(raw, "data"), "--out_dir", out,
            "--episodes_per_shard", str(ETL_PER_SHARD)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        written = concatdata_maker.main(argv, device=DEV)
    torch.cuda.synchronize()
    etl_s = time.perf_counter() - t0
    require(len(written) == ETL_EPISODES // ETL_PER_SHARD,
            f"wrote {written}")

    frames = [fast_csv.read_light_frame(p, MFCC_COLS + [
        "now_timegap", "data_dir", "label"]) for p in written]
    readers = [f.reader for f in frames]
    cols = {c: np.concatenate([f.columns[c] for f in frames])
            for c in frames[0].columns}
    mfcc = np.stack([cols[c] for c in MFCC_COLS], axis=1)
    rows, worst = 0, 0.0
    for name in names:
        ep_dir = os.path.join(raw, "data", name, "data")
        grid, labels = expected_grid(ep_dir)
        sel = cols["data_dir"] == name
        rows += len(grid)
        require(sel.sum() == len(grid)
                and np.array_equal(cols["now_timegap"][sel], grid)
                and np.array_equal(cols["label"][sel], labels),
                f"{name}: {sel.sum()} rows and labels "
                f"{cols['label'][sel].tolist()}, not its grid's {len(grid)}"
                f" and {labels.tolist()}")
        y = etl.load_wav_mono_22050(os.path.join(ep_dir, "sound",
                                                 "output.wav"))
        want = mfcc_f64(y, 22050)[: len(grid)]
        err = np.abs(mfcc[sel] - want)
        worst = max(worst, float(err.max()))
        require(bool(np.allclose(mfcc[sel], want, **MFCC_TOL)),
                f"{name}: shard MFCC {err.max()} from float64")
    require(readers == ["native"] * len(written),
            f"the shards were read by {readers}")

    before = {p: open(p, "rb").read() for p in written}
    with contextlib.redirect_stdout(io.StringIO()):
        again = concatdata_maker.main(argv, device=DEV)
    require(again == [] and all(open(p, "rb").read() == b
                                for p, b in before.items()),
            f"the rerun wrote {again}")

    dcfg = Config(sensor="mic", data_folder_name=out + "/", feature_cache=0,
                  verbose=0, input_size=128)
    ds = TabularDataset(dcfg, device=DEV)
    require(tuple(ds.data.shape) == (rows, 128)
            and bool(torch.isfinite(ds.data).all())
            and ds.readers == readers,
            f"TabularDataset(mic) read {tuple(ds.data.shape)}")
    y = etl.load_wav_mono_22050(os.path.join(raw, "data", names[0], "data",
                                             "sound", "output.wav"))
    row = dict(phase="etl", episodes=ETL_EPISODES, seconds_each=ETL_SECONDS,
               shards=len(written), rows=rows, readers=readers,
               labelled=int(cols["label"].sum()),
               mfcc_max_abs_err_vs_float64=worst, mfcc_tol=MFCC_TOL,
               rerun_written=again, dataset_mic=list(ds.data.shape),
               generate_s=generate_s, etl_s=etl_s,
               seconds_per_episode=etl_s / ETL_EPISODES,
               mfcc_ms=wall_ms(lambda: mfcc_from_wave(y, sr=22050,
                                                      device=DEV)),
               card=smi)
    emit(**row)
    return row


def gram_vs_svd(cli: dict, smi: str) -> dict:
    """10 (d) on the train CLI's diffs (5880 x 5482): the Gram fit timed
    next to the SVD fit, and the NAP AUROC of the CLI's test windows on
    each, scored through the NAP kernel."""
    from icra2021_multimodal_ad_tpu_torch.ops.metrics import get_auc_roc
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_pack,
        nap_score,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import nap_fit

    row = dict(phase="variants", run="gram_fit", case="train CLI diffs",
               rows=list(cli["train_cat"].shape), card=smi)
    for method in ("svd", "gram"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = nap_fit(cli["train_cat"], method=method)
        torch.cuda.synchronize()
        row[f"{method}_fit_s"] = time.perf_counter() - t0
        scores = nap_score(nap_pack(stats, torch.float32), cli["test_cat"])
        row[f"{method}_nap_auroc"] = get_auc_roc(scores.cpu().numpy(),
                                                 cli["label"])
        row[f"{method}_min_var"] = float(stats.standardizer.var.min())
        row[f"{method}_finite"] = bool(torch.isfinite(scores).all())
    emit(**row)
    require(row["svd_finite"] and row["gram_finite"],
            "non-finite NAP scores on the CLI's diffs")
    return row


def prng_on_card(smi: str) -> dict:
    """10: the PRNG replay on the card against the numpy replay (uniform
    bit-equal in both dtypes at the widest layer's shape; normal within an
    ulp, its log1p being the card's), and its times: `get_model`'s draws at
    Config() widths, one VIB step's noise, and the numpy replay of the
    widest layer on the host."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.utils import jax_prng

    key = jax_prng.prng_key(3)
    shape, bound = (1728, 1402), 1 / 1728 ** 0.5
    row = dict(phase="variants", case="prng on the card", card=smi)
    for dtype in ("float32", "bfloat16"):
        dev = jax_prng.uniform_device(key, shape, -bound, bound, dtype, "cuda")
        host = jax_prng.uniform(key, shape, -bound, bound, dtype)
        row[f"uniform_{dtype}_equal"] = bool(np.array_equal(
            dev.float().cpu().numpy(), host))
    vib = (2, 7000, 100)  # k, batch, bottleneck of run (a)
    dev = jax_prng.normal_device(key, vib, device="cuda").cpu().numpy()
    host = jax_prng.normal(key, vib)
    row["normal_mismatches"] = int((dev != host).sum())
    row["normal_max_ulp"] = float((np.abs(dev - host)
                                   / np.spacing(np.abs(host))).max())
    cfg = canonical_config()
    row["get_model_ms"] = wall_ms(lambda: get_model(cfg))
    row["vib_step_noise_ms"] = wall_ms(lambda: jax_prng.normal_device(
        key, vib, device="cuda"))
    t0 = time.perf_counter()
    jax_prng.uniform(key, shape, -bound, bound)
    row["host_numpy_widest_layer_ms"] = (time.perf_counter() - t0) * 1e3
    emit(**row)
    require(row["uniform_float32_equal"] and row["uniform_bfloat16_equal"],
            "the card's uniform draws differ from the numpy replay")
    require(row["normal_max_ulp"] <= 1.0,
            f"the card's normal draws sit {row['normal_max_ulp']} ulp from "
            f"the numpy replay")
    return row


def phase_variants(smi: str, seen: set, cli: dict):
    """Phase 10: `novelty_detection.run` at Config() widths on phase 5's
    seeded windows, 3 epochs, once per VARIANT_RUNS entry; each run's
    counts start at 0 just before it and are read just after.  Both
    kernels against their plain versions on each run's own inputs.
    Returns (launches, worst abs err), by kernel."""
    from icra2021_multimodal_ad_tpu_torch.novelty_detection import run
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score

    prng_on_card(smi)
    root = os.path.join(RUN_DIR, "variants")
    shutil.rmtree(root, ignore_errors=True)
    base = canonical_config().replace(n_epochs=3, verbose=0, data=root)
    train_x, valid_x, test_x, test_y = phase5_windows(base)
    windows = {"train": train_x, "valid": valid_x, "test": test_x}
    launches = dict.fromkeys(read_counts(), 0)
    worst = {"nap_score": 0.0, "fused_mlp": 0.0}
    for name, options in VARIANT_RUNS.items():
        cfg = base.replace(saved_name=os.path.join(root, name),
                           train_diffs=os.path.join(root, f"{name}.npz"),
                           saved_result=name, **options)
        # this run's path: counts start at 0 here and are read right after
        reset_counts()
        t0 = time.perf_counter()
        res = run(cfg, train_x, valid_x, test_x, test_y)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        got = read_counts()
        want_fc = want_run_launches(cfg)
        model = res.train.model
        err = path_mlp_vs_plain(f"variants {name}", model, windows, seen)
        if cfg.train_dtype == "bfloat16":
            # its validation passes read bf16 windows: the bf16 kernel
            err = max(err, path_mlp_vs_plain(
                f"variants {name} validation", model,
                {"valid": valid_x.to(torch.bfloat16)}, seen, torch.bfloat16))
        nap_err, _, _ = run_nap_vs_plain(cfg, res, valid_x, test_x,
                                         path=f"variants {name}",
                                         lo_half=False)
        reports = {"base": res.base, "sap": res.sap, "nap": res.nap}
        tr, va = res.train.train_history, res.train.valid_history
        emit(phase="variants", run=name, options=options,
             param_dtypes=sorted({str(p.dtype) for p in model.parameters()}),
             train_history=tr, valid_history=va,
             auroc={k: r.auroc for k, r in reports.items()},
             aupr={k: r.aupr for k, r in reports.items()},
             train_epoch_ms=res.train.train_ms, eval_ms=res.train.eval_ms,
             test_seconds=res.test_seconds, run_seconds=wall_s,
             launches=got, want_fused_mlp=want_fc, card=smi)
        require(all(np.isfinite(tr)) and all(np.isfinite(va)),
                f"{name}: non-finite losses")
        require(got["fc_layers"] == want_fc,
                f"{name}: {got['fc_layers']} FC layers on the kernel, not "
                f"{want_fc}")
        require(got["nap_score"] == 2, f"{name}: NAP skipped the NAP kernel")
        for k, r in reports.items():
            require(np.isfinite(r.score).all()
                    and r.score.shape == (TEST_ROWS,)
                    and np.isfinite([r.auroc, r.aupr]).all(),
                    f"{name}: the {k} report is not finite")
        for k in launches:
            launches[k] += got[k]
        worst["fused_mlp"] = max(worst["fused_mlp"], err)
        worst["nap_score"] = max(worst["nap_score"], nap_err)
    gram_vs_svd(cli, smi)
    return launches, worst



# -- phase 11: int8 NAP, export, the score server, the older ETL variants --


def device_ms(fn, flush: torch.Tensor) -> float:
    """Median of TIMED_RUNS single-call CUDA-event times with the host's
    issue kept out: a sleep on the card lets the host queue fn before the
    start event fires (as scripts/torch_kernel_ab.device_ms)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def int8_bound(b: int, pack):
    """The int8 whitening: x (fp32), the int8 block, the bf16 tail and the
    fp32 vectors read once, the scores written once, against the int8
    product's 2 B K J8 operations at the int8 peak plus the tail's 2 B K JT
    at the bf16 peak."""
    jt = 0 if pack.v16 is None else pack.v16.shape[1]
    nbytes = (4 * b * pack.k + pack.vt8.numel() + 2 * pack.k * jt
              + 4 * (pack.k + 3 * pack.vt8.shape[0] + 2 * jt) + 4 * b)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (2 * b * pack.k * (pack.j - jt) / INT8_PEAK_OPS
             + 2 * b * pack.k * jt / PEAK_OPS[torch.bfloat16])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def int8_vs_plain(case: str, pack, x: torch.Tensor, smi: str) -> None:
    """The int8 GEMM's int32 sums on one concat bit-equal to the exact
    plain product, and the whitened scores within rtol 1e-5 of the plain
    version's."""
    from icra2021_multimodal_ad_tpu_torch.ops.serving import (
        _nap_score_int8,
        int8_product,
        int8_product_plain,
        int8_quantize,
        nap_score_int8_plain,
    )

    b = x.shape[0]
    x8, _ = int8_quantize(pack, x)
    acc = int8_product(x8, pack.v8)
    exact = int8_product_plain(x8, pack.v8)
    got, plain = _nap_score_int8(pack, x), nap_score_int8_plain(pack, x)
    torch.cuda.synchronize()
    acc_equal = bool(torch.equal(acc.long(), exact))
    rel = max_rel(got, plain.cpu())
    emit(phase="int8", case=case, b=b, k=pack.k, j=pack.j,
         jt=0 if pack.v16 is None else pack.v16.shape[1],
         padded=dict(rows=max(b, 32), k8=pack.vt8.shape[1],
                     j8=pack.vt8.shape[0]),
         acc_bit_equal=acc_equal, acc_max_abs=int(exact.abs().max()),
         score_max_rel_vs_plain=rel,
         scores_bit_equal=bool(torch.equal(got, plain)),
         finite=bool(torch.isfinite(got).all()), card=smi)
    require(acc_equal, f"int8 GEMM sums of {case} at B = {b} differ from "
                       f"the exact product")
    require(bool(torch.allclose(got, plain, rtol=1e-5, atol=0)),
            f"int8 scores of {case} at B = {b}: max rel {rel} from the "
            f"plain version")


def nap_pack_vs_plain(case: str, pack, cat: torch.Tensor) -> float:
    """The NAP kernel, both variants of the pack's dtype, against its plain
    version in its order of sums (`nap_score_staged`) on one concat at
    KERNEL_TOL; returns the worst abs err."""
    from icra2021_multimodal_ad_tpu_torch.ops import nap_kernel

    dtype, b = pack.vt.dtype, int(cat.shape[0])
    tol = KERNEL_TOL[dtype]
    ref = nap_score_staged(pack, cat)
    plain = nap_kernel.nap_score_plain(pack, cat)
    worst = 0.0
    for variant in variants_of(nap_kernel, dtype):
        got = nap_kernel.nap_score(pack, cat, variant)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.allclose(got, ref, **tol))
        emit(phase="kernel_vs_plain", kernel="nap_score", case=case, b=b,
             k=pack.k, j=pack.j, dtype=str(dtype), variant=variant,
             dispatched=variant == nap_kernel.variant_for(dtype, b),
             reference="staged", max_abs_err=err,
             max_rel_err=float(((got - ref).abs() / ref.abs()).max()),
             one_product_max_rel_err=max_rel(got, plain.cpu()),
             tol=tol, ok=ok)
        require(ok, f"nap_score {case} {dtype} variant {variant} B={b} "
                    f"disagrees with its plain version in its order of sums "
                    f"(max abs err {err})")
        worst = max(worst, err)
    return worst


def int8_on_card(smi: str, bundles, req_x, det, flush) -> dict:
    """11a: on phase 4's canonical fit (K = 5482, J = 4096) and phase 8b's
    detector fit (J = 400), fp32 diffs into int8 whitening: the int8 GEMM's
    int32 sums against the exact plain product and the scores against the
    plain version, at B = 10 and 4096; the guard of each fit's bf16 + int8
    bundle; then (11e) the int8 whitening's device time beside the fp32
    and bf16 NAP kernels' at the canonical shape.  Returns the time rows."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import load_model
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import load_nap_stats
    from icra2021_multimodal_ad_tpu_torch.ops.serving import (
        _bf16_product,
        _nap_score_int8,
        int8_product,
        int8_quantize,
        make_serving,
        nap_accuracy_guard,
        nap_score_int8_plain,
    )

    cfg, rt, fp = det
    _, det_model = load_model(cfg.saved_name, cfg, device=DEV)
    canon = bundles["float32"]
    fits = {"canonical": (canonical_config(), canon.model, canon.nap_stats,
                          req_x[:256], INT8_GUARD_TOL),
            "detector": (cfg, det_model, load_nap_stats(cfg.train_diffs),
                         streaming_windows(rt, fp, 8, 10), 0.1)}
    packs = {}
    for name, (fcfg, model, stats, probe, tol) in fits.items():
        s8 = make_serving(fcfg.replace(nap_quant="int8"), model,
                          nap_stats=stats, device=DEV)
        pack = packs[name] = s8.nap_int8
        cat = s8.nap_diffs(req_x[:max(INT8_B)])
        for b in INT8_B:
            int8_vs_plain(f"{name} fit", pack, cat[:b].contiguous(), smi)
        rel = nap_accuracy_guard(fcfg, model, stats, probe, tol=tol,
                                 nap_quant="int8", device=DEV)
        emit(phase="int8_guard", fit=name, path="bf16 diffs + int8",
             rel_err=rel, tol=tol, probe_rows=int(probe.shape[0]), card=smi)

    pack = packs["canonical"]
    cat = canon.nap_diffs(req_x)
    rows = []
    for b in INT8_B:
        x = cat[:b].contiguous()
        x8, _ = int8_quantize(pack, x)
        bound_ms, bound_by = int8_bound(b, pack)
        row = dict(
            phase="int8_times", b=b, k=pack.k, j=pack.j,
            jt=pack.v16.shape[1],
            ms=device_ms(lambda: _nap_score_int8(pack, x), flush),
            int8_gemm_ms=device_ms(lambda: int8_product(x8, pack.v8), flush),
            bf16_tail_ms=device_ms(lambda: _bf16_product(x, pack.v16), flush),
            plain_ms=device_ms(lambda: nap_score_int8_plain(pack, x), flush),
            nap_fp32_kernel_ms=device_ms(lambda: nap_score(canon.nap_pack, x),
                                         flush),
            nap_bf16_kernel_ms=device_ms(
                lambda: nap_score(bundles["bfloat16"].nap_pack, x), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            tail_route="torch.mm(out_dtype=torch.float32)",
            timer="device_ms", card=smi)
        emit(**row)
        rows.append(row)
    return rows


def nap_windows_f64(serving, x: torch.Tensor) -> torch.Tensor:
    """`score_nap_windows` of an fp32 bundle in float64: the bundle's packs
    cast to float64 whole, through the live traversal (`rapp.diffs_batch`)
    on the layer's plain version, then the whitening in float64."""
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        LayerPack,
        MlpPack,
        fused_mlp_layer_plain_pair,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.rapp import diffs_batch

    def f64(pack):
        return MlpPack(tuple(LayerPack(*(
            t.double() if isinstance(t, torch.Tensor) else t for t in layer))
            for layer in pack.layers), torch.float64)

    ae = serving.ae_pack
    ae64 = ae._replace(encoder=f64(ae.encoder), decoder=f64(ae.decoder))
    d = diffs_batch(serving.model, x.double(), ae64,
                    fused_mlp_layer_plain_pair)
    return nap_score_f64(serving.nap_stats, torch.cat(d, dim=-1))


def _export_argv(cfg) -> list:
    return ["--saved_name", cfg.saved_name, "--train_diffs", cfg.train_diffs,
            "--batch_size", str(EXPORT_B), "--ops", EXPORT_OPS]


def export_on_card(smi: str, det):
    """11b: `export.main` on phase 8b's checkpoint and stats, every op, in
    fp32, bf16 and fp32 + int8, each verified against the live bundle; the
    fp32 artifacts against the live kernel path (BASE at max rel 1e-4, NAP
    at mean rel 1e-4) and the NAP ones and the kernels against float64;
    both kernels against their plain versions on the verify inputs; one
    artifact loaded and run in a process that imports torch alone.
    Returns the path's launches and the kernels' worst abs errs."""
    from icra2021_multimodal_ad_tpu_torch import export
    from icra2021_multimodal_ad_tpu_torch.models.builder import load_model
    from icra2021_multimodal_ad_tpu_torch.ops.fusion import fusion_init
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import load_nap_stats
    from icra2021_multimodal_ad_tpu_torch.ops.serving import (
        int8_product,
        load_scorer,
        make_serving,
    )

    cfg = det[0]
    root = os.path.join(RUN_DIR, "export")
    shutil.rmtree(root, ignore_errors=True)
    manifests = {}
    # the export path: counts start at 0 here and are read right after
    reset_counts()
    for name, flags in EXPORT_RUNS.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            m = export.main(_export_argv(cfg) + [
                "--out_dir", os.path.join(root, name)] + flags, device=DEV)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        arts = m["artifacts"]
        emit(phase="export", run=name, flags=flags, seconds=secs,
             guard_rel_err=m["guard_rel_err"],
             artifacts={op: {k: e[k] for k in (
                 "bytes", "verify_mean_rel_vs_live", "compute_dtype",
                 "nap_quant")} for op, e in arts.items()}, card=smi)
        for op, e in arts.items():
            require(e["verify_mean_rel_vs_live"] <= 1e-2,
                    f"{name} {op} artifact: mean rel "
                    f"{e['verify_mean_rel_vs_live']} from the live bundle")
        manifests[name] = m
    launches = read_counts()

    # the fp32 artifacts against the live kernel path
    cfg32, model = load_model(cfg.saved_name, cfg, device=DEV)
    stats = load_nap_stats(cfg.train_diffs)
    live = make_serving(cfg32, model, nap_stats=stats,
                        fusion_params=fusion_init(cfg32.seed, DEV),
                        device=DEV)
    k = int(stats.rotater.mu.shape[0])
    rels, f64 = {}, {}
    worst = {"fused_mlp": 0.0, "nap_score": 0.0}
    for op, e in manifests["float32"]["artifacts"].items():
        args = export.verify_inputs(op, cfg32.seed, EXPORT_B,
                                    cfg32.input_size, k)
        got = load_scorer(os.path.join(root, "float32", e["path"]))(
            *(torch.from_numpy(a).to(DEV) for a in args))
        want = export.live_scorer(live, op)(*args)
        rels[op] = max_rel(got, want.cpu())
        if op == "nap":
            worst["nap_score"] = max(worst["nap_score"], nap_pack_vs_plain(
                "export nap", live.nap_pack,
                torch.from_numpy(args[0]).to(DEV)))
        if op in ("nap_windows", "nap_sensor"):
            # both fp32 evaluations against float64 on the same fused
            # windows: the un-floored whitening amplifies any summation
            # order, the kernels' as much as the plain ops'.  Both kernels
            # face their plain versions on these windows and their diffs
            x = (torch.from_numpy(args[0]).to(DEV) if op == "nap_windows"
                 else live.fuse_sensor(*args))
            worst["fused_mlp"] = max(worst["fused_mlp"], path_mlp_vs_plain(
                f"export {op}", live.model, {"verify": x}, set(),
                scaled=True))
            worst["nap_score"] = max(worst["nap_score"], nap_pack_vs_plain(
                f"export {op}", live.nap_pack, live.nap_diffs(x)))
            ref = nap_windows_f64(live, x).cpu()
            f64[op] = {"artifact": max_rel(got, ref),
                       "kernels": max_rel(want, ref),
                       "artifact_mean": float(((got.cpu().double() - ref)
                                               .abs() / ref.abs()).mean()),
                       "kernels_mean": float(((want.cpu().double() - ref)
                                              .abs() / ref.abs()).mean())}
    emit(phase="export_fp32_vs_kernels", max_rel=rels, tol=1e-4,
         mean_rel={op: e["verify_mean_rel_vs_live"] for op, e in
                   manifests["float32"]["artifacts"].items()},
         vs_float64=f64, min_var=float(stats.standardizer.var.min()),
         card=smi)
    # BASE at 1e-4 max rel.  NAP whitens by the detector's un-floored
    # stats, where two fp32 summation orders land up to ~1.5e-3 apart:
    # there the artifact is held at 1e-4 mean rel from the kernels, and the
    # artifact and the kernels each within F64_NAP_MAX_REL of float64
    for op, r in rels.items():
        if op.startswith("base"):
            require(r <= 1e-4, f"fp32 {op} artifact: max rel {r} from the "
                               f"kernel path")
        else:
            mean = manifests["float32"]["artifacts"][op][
                "verify_mean_rel_vs_live"]
            require(mean <= 1e-4, f"fp32 {op} artifact: mean rel {mean} "
                                  f"from the kernel path")
    for op, e in f64.items():
        for side in ("artifact", "kernels"):
            require(e[side] <= F64_NAP_MAX_REL,
                    f"fp32 {op} {side}: max rel {e[side]} from float64 "
                    f"(limit {F64_NAP_MAX_REL})")

    # one artifact in a process that imports torch alone
    art = os.path.join(root, "float32",
                       manifests["float32"]["artifacts"]["nap_windows"]
                       ["path"])
    x = export.verify_inputs("nap_windows", cfg32.seed, EXPORT_B,
                             cfg32.input_size)[0]
    xpath, opath = os.path.join(root, "x.npy"), os.path.join(root, "s.npy")
    np.save(xpath, x)
    code = "\n".join([
        "import sys, numpy as np, torch",
        f"m = torch.export.load({art!r}).module()",
        f"s = m(torch.from_numpy(np.load({xpath!r})).to({DEV!r}))",
        "bad = [n for n in sys.modules if n.startswith('icra2021')]",
        "assert not bad, bad",
        f"np.save({opath!r}, s.cpu().numpy())"])
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    require(res.returncode == 0, f"torch-only load failed: "
                                 f"{res.stderr[-1500:]}")
    here = load_scorer(art)(torch.from_numpy(x).to(DEV)).cpu().numpy()
    sub = np.load(opath)
    emit(phase="export_torch_only", artifact=os.path.basename(art),
         seconds=sub_s, max_rel_vs_load_scorer=float(
             np.max(np.abs(sub - here) / np.abs(here))), card=smi)
    require(bool(np.allclose(sub, here, rtol=1e-6, atol=0)),
            "the torch-only process scored otherwise")
    return launches, worst


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_port(port: int, thread, seconds: float = 300.0) -> None:
    import socket

    deadline = time.perf_counter() + seconds
    while True:
        require(thread.is_alive(), "serve.main ended before serving")
        require(time.perf_counter() < deadline, "serve.main never came up")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=5).close()
            return
        except OSError:
            time.sleep(0.05)


def build_native_client() -> str:
    exe = os.path.join(RUN_DIR, "score_client")
    res = subprocess.run(
        ["g++", "-O3", "-std=c++17",
         os.path.join(ROOT, "native", "score_client.cpp"), "-o", exe],
        capture_output=True, text=True, timeout=300)
    require(res.returncode == 0, f"g++ score_client: {res.stderr[-1500:]}")
    return exe


def server_kernels_vs_plain(name: str, server, x: np.ndarray, sensor,
                            smi: str) -> dict:
    """Each kernel of a served bundle against its plain version at the
    inputs the server gave it: every request of SERVER_ROWS padded to its
    bucket with zero rows, the warmup's max_batch bucket of zeros, and the
    sensor windows fused from the request edge-replicated to its bucket
    (the warmup's zero frames fuse to NaN, a min-max over a range of 0,
    which no comparison can hold).  The FC kernel on every layer input of
    the diff extraction, in error-scale units (these random windows lie
    off the detector's training distribution), then on their concat diffs
    the NAP kernel (fp32 and bf16 bundles) or the int8 product (an int8
    bundle).  Returns the worst abs errs."""
    from icra2021_multimodal_ad_tpu_torch.ops.score_server import (
        _next_bucket,
    )

    bundle, cap = server.serving, server.max_batch
    dtype = bundle.compute_dtype
    windows = {}
    for n in SERVER_ROWS:
        b = _next_bucket(n, cap)
        xb = np.zeros((b, x.shape[1]), np.float32)
        xb[:n] = x[:n]
        windows[f"{n} rows, bucket {b}"] = xb
    windows[f"warmup zeros, bucket {cap}"] = np.zeros((cap, x.shape[1]),
                                                      np.float32)
    n, b = sensor[0].shape[0], _next_bucket(sensor[0].shape[0], cap)
    windows[f"sensor {n} rows, bucket {b}"] = bundle.fuse_sensor(*(
        np.concatenate([a, np.broadcast_to(a[:1], (b - n,) + a.shape[1:])])
        for a in sensor))
    windows = {k: torch.as_tensor(v, device=DEV).to(dtype)
               for k, v in windows.items()}
    worst = {"fused_mlp": path_mlp_vs_plain(f"score_server {name}",
                                            bundle.model, windows, set(),
                                            dtype, scaled=True),
             "nap_score": 0.0}
    for case, xb in windows.items():
        cat = bundle.nap_diffs(xb)
        case = f"score_server {name} {case}"
        if bundle.nap_int8 is not None:
            int8_vs_plain(case, bundle.nap_int8, cat, smi)
        else:
            worst["nap_score"] = max(worst["nap_score"], nap_pack_vs_plain(
                case, bundle.nap_pack, cat))
    return worst


@contextlib.contextmanager
def eager_server():
    """Inside the block every ScoreServer scores through its eager path
    (`_score_eager`, `_score_sensor_op_eager`)."""
    from icra2021_multimodal_ad_tpu_torch.ops.score_server import ScoreServer

    captured = ScoreServer._score, ScoreServer._score_sensor_op
    ScoreServer._score = ScoreServer._score_eager
    ScoreServer._score_sensor_op = ScoreServer._score_sensor_op_eager
    try:
        yield
    finally:
        ScoreServer._score, ScoreServer._score_sensor_op = captured


def server_captured_vs_eager(name: str, server, x: np.ndarray, sensor,
                             smi: str) -> None:
    """11c: every (op, bucket) that the run's requests (SERVER_ROWS), its
    warm-up (zero probes at buckets 1 and max_batch) and its sensor
    request reached, through the server's programs against its
    eager path: bit for bit (the zero sensor probes score NaN, compared
    by their bits)."""
    cap = server.max_batch
    probe = np.zeros((cap, x.shape[1]), np.float32)
    zeros = (np.zeros((cap, 3, 32, 32), np.uint8),
             np.zeros((cap, 1, 32, 32), np.uint8),
             np.zeros((cap, 1), np.float32), np.zeros((cap, 1, 13),
                                                       np.float32))
    cases = {}
    for op in SERVER_TOL:
        requests = [(f"{n} rows", x[:n]) for n in SERVER_ROWS]
        for label, rows in requests + [("warm-up 1", probe[:1]),
                                       (f"warm-up {cap}", probe)]:
            cases[f"{op} {label}"] = (server._score(op, rows),
                                      server._score_eager(op, rows))
    for op in server.SENSOR_OPS:
        for label, payload in (("request", sensor),
                               ("warm-up 1", [a[:1] for a in zeros]),
                               (f"warm-up {cap}", zeros)):
            cases[f"{op} {label}"] = (
                server._score_sensor_op(op, *payload),
                server._score_sensor_op_eager(op, *payload))
    differ = [k for k, (a, b) in cases.items() if a.tobytes() != b.tobytes()]
    emit(phase="server_captured_vs_eager", run=name, cases=len(cases),
         bit_identical=not differ, differ=differ, card=smi)
    require(not differ, f"{name} server: the programs' scores differ from "
                        f"the eager server's at {differ}")


def server_launches(name: str, server, x: np.ndarray, sensor,
                    smi: str) -> None:
    """11c: under torch.profiler, a served chunk is one graph launch and no
    kernel launch from the host, with no launch or copy lost: `score_nap`
    at 10 and 1024 rows, `score_nap_sensor` on the sensor request, and
    `score_base` on 1000 rows with max_batch set to 512 (two chunks, two
    replays); the eager request's launches beside them."""
    cases = {"score_nap 10 rows": (lambda: server._score(
                 "score_nap", x[:10]), 1),
             "score_nap 1024 rows": (lambda: server._score(
                 "score_nap", x[:1024]), 1),
             "score_nap_sensor request": (lambda: server._score_sensor_op(
                 "score_nap_sensor", *sensor), 1),
             "score_base 1000 rows, max_batch 512": (lambda: server._score(
                 "score_base", x[:1000]), 2)}
    profiles = {}
    cap = server.max_batch
    for case, (fn, chunks) in cases.items():
        server.max_batch = 512 if "max_batch 512" in case else cap
        try:
            profiles[case] = profile_calls(fn)
        finally:
            server.max_batch = cap
    eager = profile_calls(lambda: server._score_eager("score_nap", x[:10]))
    emit(phase="server_launches", run=name, captured=profiles,
         eager_score_nap_10_rows=eager, card=smi)
    for case, prof in [*profiles.items(), ("eager", eager)]:
        require(prof["device_events_lost"] == 0,
                f"{name} server {case}: the profiler has no device event "
                f"for {prof['device_events_lost']} launches and copies")
    for case, (_, chunks) in cases.items():
        got = profiles[case]
        require(got["graph_launches_per_call"] == chunks
                and got["host_kernel_launches_per_call"] == 0,
                f"{name} server {case}: {got['graph_launches_per_call']} "
                f"graph launches and {got['host_kernel_launches_per_call']}"
                f" kernel launches from the host per request, want {chunks}"
                f" and 0")


def server_programs_held(server) -> dict:
    """11c: what warm-up costs and holds at the run's max_batch: a copy of
    the server with no programs warms up (captures), then another one
    eagerly, each on the host clock; the device memory the captured
    programs hold (reserved, after `empty_cache`, against before) and
    their pinned staging and outputs."""
    from icra2021_multimodal_ad_tpu_torch.ops.serving import ServingPrograms

    def fresh():
        copied = copy.copy(server)
        copied.programs = ServingPrograms(server.serving)
        return copied

    def warm_s(s) -> float:
        t0 = time.perf_counter()
        s.warmup()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    warm = fresh()
    captured_s = warm_s(warm)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - before
    programs = warm.programs.programs.values()
    pinned = sum(t.nbytes for p in programs for t in [
        *(t for slot in p._staging for t in slot),
        *(o for o in p._outputs if o is not None)])
    n_programs = len(programs)
    del warm, programs
    eager = fresh()
    eager._score, eager._score_sensor_op = (eager._score_eager,
                                            eager._score_sensor_op_eager)
    eager_s = warm_s(eager)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_batch": server.max_batch, "programs": n_programs,
            "warmup_captured_s": captured_s, "warmup_eager_s": eager_s,
            "device_reserved_mib": held / 2 ** 20,
            "pinned_host_mib": pinned / 2 ** 20}


def server_on_card(smi: str, det):
    """11c: `serve.main` on loopback in fp32, bf16 behind its guard and
    bf16 + int8 behind its guard: ragged requests of every op against the
    in-process bundle, each kernel against its plain version at the
    server's padded inputs, the native C++ client, sensor ops; then each
    run's programs against its eager path, its launches per request under
    the profiler, memory and warm-up seconds.  Returns the path's launches
    and the kernels' worst abs errs."""
    from icra2021_multimodal_ad_tpu_torch import serve
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score
    from icra2021_multimodal_ad_tpu_torch.ops.score_server import ScoreClient
    from icra2021_multimodal_ad_tpu_torch.ops.serving import int8_product

    cfg = det[0]
    exe = build_native_client()
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (max(SERVER_ROWS),
                           cfg.input_size)).astype(np.float32)
    sensor = (rng.integers(0, 256, (10, 3, 32, 32), dtype=np.uint8),
              rng.integers(0, 256, (10, 1, 32, 32), dtype=np.uint8),
              rng.uniform(0, 400, (10, 1)).astype(np.float32),
              rng.uniform(-30, 30, (10, 1, 13)).astype(np.float32))
    runs = {}
    # the server path: counts start at 0 here and are read right after
    reset_counts()
    for name, flags in SERVER_RUNS.items():
        port, stop, box = free_port(), threading.Event(), {}
        argv = ["--saved_name", cfg.saved_name, "--train_diffs",
                cfg.train_diffs, "--port", str(port)] + flags
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            thread = threading.Thread(target=lambda: box.update(
                server=serve.main(argv, device=DEV, stop=stop)), daemon=True)
            thread.start()
            try:
                wait_for_port(port, thread)
                up_s = time.perf_counter() - t0
                with ScoreClient(("127.0.0.1", port), timeout_s=300) as c:
                    info = c.info()
                    got = {(op, n): c.score(x[:n], op=op)
                           for n in SERVER_ROWS for op in SERVER_TOL}
                    got_sensor = {op: c.score_sensor(*sensor, op=op) for op in
                                  ("score_base_sensor", "score_sap_sensor",
                                   "score_nap_sensor")}
                    native = subprocess.run(
                        [exe, "127.0.0.1", str(port), "score_nap", "33",
                         str(cfg.input_size)], input=x[:33].tobytes(),
                        capture_output=True, timeout=120)
            finally:
                stop.set()
                thread.join(timeout=120)
        require(not thread.is_alive(), f"{name}: serve.main did not stop")
        require(native.returncode == 0, f"{name}: native client "
                                        f"{native.stderr[-500:]}")
        runs[name] = dict(server=box["server"], info=info, got=got,
                          got_sensor=got_sensor, up_s=up_s,
                          native=np.frombuffer(native.stdout, "<f4"),
                          log=log.getvalue())
    launches = read_counts()

    worst = {"fused_mlp": 0.0, "nap_score": 0.0}
    for name, r in runs.items():
        for kernel, err in server_kernels_vs_plain(
                name, r["server"], x, sensor, smi).items():
            worst[kernel] = max(worst[kernel], err)
        bundle = r["server"].serving
        live = {"score_base": bundle.score_fused,
                "score_sap": bundle.score_sap_windows,
                "score_nap": bundle.score_nap_windows}
        rel, bit_equal = {}, {}
        for (op, n), got in r["got"].items():
            want = live[op](torch.from_numpy(x[:n]).to(DEV)).cpu().numpy()
            rel[f"{op}/{n}"] = float(np.max(np.abs(got - want)
                                            / np.abs(want)))
            bit_equal[f"{op}/{n}"] = bool(np.array_equal(got, want))
        sensor_want = {
            "score_base_sensor": bundle.score_sensor(*sensor),
            "score_sap_sensor": bundle.score_sap_windows(
                bundle.fuse_sensor(*sensor)),
            "score_nap_sensor": bundle.score_nap_sensor(*sensor)}
        sensor_rel = {op: float(np.max(np.abs(r["got_sensor"][op]
                                              - w.cpu().numpy())
                                       / np.abs(w.cpu().numpy())))
                      for op, w in sensor_want.items()}
        guard = re.search(r"rel err ([0-9.]+) <= tol ([0-9.]+)", r["log"])
        server = r["server"]
        server_captured_vs_eager(name, server, x, sensor, smi)
        server_launches(name, server, x, sensor, smi)
        emit(phase="server_programs", run=name, startup_s=r["up_s"],
             **server_programs_held(server), card=smi)
        emit(phase="score_server", run=name, flags=SERVER_RUNS[name],
             info={k: r["info"][k] for k in ("compute_dtype", "nap_quant",
                                             "guard_rel_err", "max_batch")},
             startup_s=r["up_s"], max_rel_vs_in_process=rel,
             bit_equal=bit_equal, tol=SERVER_TOL,
             sensor_max_rel=sensor_rel,
             native_equal=bool(np.array_equal(r["native"],
                                              r["got"][("score_nap", 33)])),
             guard_line=guard and guard.group(0),
             card=smi)
        for key, v in rel.items():
            require(v <= SERVER_TOL[key.split("/")[0]],
                    f"{name} server {key}: max rel {v} from the bundle")
        for op, v in sensor_rel.items():
            require(v <= (1e-3 if "nap" in op else 1e-4),
                    f"{name} server {op}: max rel {v} from the bundle")
        require(np.array_equal(r["native"], r["got"][("score_nap", 33)]),
                f"{name}: the native client's scores differ")
        if SERVER_RUNS[name]:
            require(guard is not None and float(guard.group(1))
                    <= float(guard.group(2)), f"{name}: no guard line")
    return launches, worst


def frames_expected(ep_dir: str) -> int:
    """Rows of the frames variant, from the CSVs alone: the windows between
    consecutive RGB frames that hold a depth, a LiDAR and a weight
    sample."""
    t = timegaps(os.path.join(ep_dir, "rgb.csv"))
    streams = [timegaps(os.path.join(ep_dir, n)) for n in
               ("depth.csv", "LiDAR.csv", "hand_weight.csv")]
    return sum(all(bool(((s >= a) & (s <= b)).any()) for s in streams)
               for a, b in zip(t[:-1], t[1:]))


def etl_variants_on_card(smi: str) -> dict:
    """11d: raw episodes in the legacy schema (an RGB stream, microphone
    sample lists) through `concatdata_maker.main --variant legacy` and,
    for one episode, `--variant frames`; read back with the rows, labels
    and columns the CSVs alone give."""
    from icra2021_multimodal_ad_tpu_torch import concatdata_maker
    from icra2021_multimodal_ad_tpu_torch.data.synthetic import (
        _write_frame,
        generate_raw_episodes,
    )

    root = os.path.join(RUN_DIR, "etl_variants")
    shutil.rmtree(root, ignore_errors=True)
    raw = os.path.join(root, "raw")
    names = generate_raw_episodes(raw, n_episodes=LEGACY_EPISODES,
                                  duration_s=LEGACY_SECONDS, seed=5)
    rng = np.random.default_rng(5)
    for name in names:
        ep = os.path.join(raw, "data", name, "data")
        shutil.copy(os.path.join(ep, "hand.csv"), os.path.join(ep, "rgb.csv"))
        with open(os.path.join(ep, "Microphone.csv"), newline="") as f:
            t = np.array([float(r["timegap"]) for r in csv.DictReader(f)])
        _write_frame(os.path.join(ep, "Microphone.csv"), {
            "data": ["[" + ",".join(f"{v:.1f}" for v in rng.normal(
                0, 300, LEGACY_MIC)) + "]" for _ in t],
            "time": t, "timegap": t})

    def run(argv):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            written = concatdata_maker.main(argv, device=DEV)
        return written, time.perf_counter() - t0

    (legacy,), legacy_s = run(["--data_dir", os.path.join(raw, "data"),
                               "--out_dir", os.path.join(root, "legacy"),
                               "--variant", "legacy"])
    with open(legacy, newline="") as f:
        rows = list(csv.DictReader(f))
    mic = [f"Mic{i:04d}" for i in range(LEGACY_MIC)]
    require(all(c in rows[0] for c in mic + ["cur_rgb_id", "LiDAR962"]),
            f"legacy columns {list(rows[0])[:8]}...")
    for name in names:
        grid, labels = expected_grid(os.path.join(raw, "data", name, "data"),
                                     legacy=True)
        got = [r for r in rows if r["data_dir"] == name]
        require(len(got) == len(grid) and [int(r["label"]) for r in got]
                == labels.tolist(), f"legacy {name}: {len(got)} rows, "
                                    f"its grid {len(grid)}")
    ep0 = os.path.join(raw, "data", names[0], "data")
    (frames,), frames_s = run(["--data_dir", ep0, "--out_dir",
                               os.path.join(root, "frames"), "--variant",
                               "frames"])
    with open(frames, newline="") as f:
        frows = list(csv.DictReader(f))
    want = frames_expected(ep0)
    require(len(frows) == want and "next_timegap" in frows[0],
            f"frames: {len(frows)} rows, want {want}")
    row = dict(phase="etl_variants", episodes=LEGACY_EPISODES,
               seconds_each=LEGACY_SECONDS, legacy_rows=len(rows),
               legacy_s=legacy_s, frames_rows=len(frows), frames_s=frames_s,
               card=smi)
    emit(**row)
    return row


def phase_int8_export_server(smi: str, bundles, req_x, det):
    """Phase 11.  Returns the launches of its paths, by path, and the
    kernels' worst abs errs against their plain versions."""
    t0 = time.perf_counter()
    times = int8_on_card(smi, bundles, req_x, det, l2_flush())
    stream = streaming_runs(det[0], smi, INT8_STREAM_RUN)
    export_launches, export_worst = export_on_card(smi, det)
    server_launches, server_worst = server_on_card(smi, det)
    paths = {"streaming_int8": stream["int8_nap_guarded"][1],
             "export": export_launches, "score_server": server_launches}
    worst = {k: max(export_worst[k], server_worst[k]) for k in export_worst}
    etl_variants_on_card(smi)
    emit(phase="int8_export_server", launches=paths, max_abs_err=worst,
         int8_whitening=times, seconds=time.perf_counter() - t0, card=smi)
    return paths, worst

def tflops(ops: float, ms: float) -> float:
    return ops / ms / 1e9


def nap_times(pack, x, flush, variant=None) -> dict:
    """The NAP kernel's row of times at one (B, K, J) shape, in `variant`
    (default: the dispatched one); `tflops` is the product's 2BKJ over the
    kernel's time."""
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_score,
        nap_score_plain,
        variant_for,
    )

    b = int(x.shape[0])
    if variant is None:
        variant = variant_for(pack.v.dtype, b)
    xd = x.to(pack.v.dtype)
    got, ref = nap_score(pack, x, variant), nap_score_plain(pack, x)
    bound_ms, bound_by = nap_bound(b, pack.k, pack.j, pack.v.dtype)
    ms = time_ms(lambda: nap_score(pack, x, variant), flush)
    return dict(b=b, k=pack.k, j=pack.j, variant=variant, ms=ms,
                device_ms=device_ms(lambda: nap_score(pack, x, variant),
                                    flush),
                tflops=tflops(2 * b * pack.k * pack.j, ms),
                plain_ms=time_ms(lambda: nap_score_plain(pack, x), flush),
                matmul_ms=time_ms(lambda: torch.matmul(xd, pack.v), flush),
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=float((got - ref).abs().max()),
                max_rel_err=float(((got - ref).abs() / ref.abs()).max()),
                library_ms=None)


def kernel_resources() -> dict:
    """Per kernel library: ptxas's registers, static shared memory and
    spills of every compiled kernel, and the dynamic shared memory each
    dispatch variant launches with."""
    from icra2021_multimodal_ad_tpu_torch.ops import mlp_kernel, nap_kernel

    smem = {"fused_mlp": mlp_kernel._lib().fused_mlp_smem_bytes,
            "nap_score": nap_kernel._lib().nap_score_smem_bytes}
    out = {name: {"ptxas": PTXAS.get(name),
                  "dynamic_smem_by_variant": {
                      v: smem[name](v) for v in module.VARIANTS.values()}}
           for name, module in (("fused_mlp", mlp_kernel),
                                ("nap_score", nap_kernel))}
    # the small-batch variants size theirs by batch (and the module's depth)
    out["nap_score"]["dynamic_smem_by_variant"][4] = smem["nap_score"](4)
    out["fused_mlp"]["module_launch_smem_by_b"] = {
        b: mlp_kernel._lib().fused_mlp_module_smem_bytes(
            b, -(-canonical_config().input_size // 32))
        for b in SMALL_B}
    return out


def mlp_times(layer, x, flush, variant=None) -> dict:
    """The FC kernel's row of times for one layer on (B, K) inputs x, in
    `variant` (default: the dispatched one)."""
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
        fused_mlp_layer_plain,
        variant_for,
    )

    dtype = layer.w.dtype
    (n, k), b = layer.w.shape, int(x.shape[0])
    if variant is None:
        variant = variant_for(dtype, b)
    xd, wt = x.to(dtype), layer.w.t()
    mm = ((lambda: torch.mm(xd, wt)) if dtype == torch.float32
          else (lambda: torch.mm(xd, wt, out_dtype=torch.float32)))
    bound_ms, bound_by = mlp_bound(layer, x)
    ms = time_ms(lambda: fused_mlp_layer(layer, x, variant), flush)
    return dict(b=b, k=k, n=n, x_dtype=str(x.dtype), variant=variant, ms=ms,
                device_ms=device_ms(lambda: fused_mlp_layer(layer, x,
                                                            variant), flush),
                tflops=tflops(2 * b * k * n, ms),
                plain_ms=time_ms(lambda: fused_mlp_layer_plain(layer, x),
                                 flush),
                matmul_ms=time_ms(mm, flush),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def module_bound(pack, b: int):
    """A whole fp32 module at b rows: the sum of its layers' bounds (each
    bound by its bytes at these batches)."""
    parts = [mlp_bound(layer, torch.empty(b, layer.w.shape[1],
                                          device=layer.w.device))
             for layer in pack.layers]
    return sum(ms for ms, _ in parts), ("bytes" if all(
        by == "bytes" for _, by in parts) else "operations")


def module_times(pack, x, flush) -> dict:
    """The whole-module launch's row (variant 4) on (B, Din) inputs x,
    beside variant 0's launch per layer, the plain layer loop and one
    `torch.mm` per layer (`matmul_ms`: each timed alone, summed;
    `matmul_device_ms`: all in one call under the kernel's `device_ms`
    timer); `tflops` is the module's 2 B sum(K N) over the launch's
    time."""
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer_pair,
        fused_mlp_layer_plain_pair,
        fused_mlp_module,
        module_forward_taps,
    )

    b = int(x.shape[0])
    launch = lambda: fused_mlp_module(pack, x)  # noqa: E731
    per_layer = lambda: module_forward_taps(  # noqa: E731
        pack, x, lambda layer, h: fused_mlp_layer_pair(layer, h, 0))
    got = launch()
    ref = module_forward_taps(pack, x, fused_mlp_layer_plain_pair)[0]
    mm = 0.0
    operands = []
    for layer in pack.layers:
        h, wt = torch.randn(b, layer.w.shape[1], device=x.device), layer.w.t()
        mm += time_ms(lambda: torch.mm(h, wt), flush)
        operands.append((h, wt))
    all_mm = lambda: [torch.mm(h, wt) for h, wt in operands]  # noqa: E731
    bound_ms, bound_by = module_bound(pack, b)
    ms = time_ms(launch, flush)
    return dict(b=b, k=int(pack.layers[0].w.shape[1]),
                layers=len(pack.layers), variant=4, ms=ms,
                device_ms=device_ms(launch, flush),
                variant0_ms=time_ms(per_layer, flush),
                variant0_device_ms=device_ms(per_layer, flush),
                tflops=tflops(2 * b * sum(layer.w.shape[0] * layer.w.shape[1]
                                          for layer in pack.layers), ms),
                plain_ms=time_ms(lambda: module_forward_taps(
                    pack, x, fused_mlp_layer_plain_pair), flush),
                matmul_ms=mm,
                matmul_device_ms=device_ms(all_mm, flush),
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=max(float((a - r).abs().max())
                                for a, r in zip(got, ref)),
                library_ms=None)


def l2_flush() -> torch.Tensor:
    """64 MB to overwrite the 50 MB L2 before each timed call."""
    return torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device="cuda")


def phase_times(bundles, req_x, run_pack, run_cat):
    emit(phase="times", resources=kernel_resources())
    flush = l2_flush()
    # the train-and-score path's NAP: fp32, the test diffs on the fitted
    # stats (J = min(rows, K))
    run_row = dict(dtype="float32", path="train_and_score",
                   **nap_times(run_pack, run_cat, flush))
    emit(phase="times", kernel="nap_score", **run_row)
    cat = bundles["float32"].nap_diffs(req_x)
    nap_rows = []
    for name, serv in bundles.items():
        for b in CANON_B:
            row = dict(dtype=name, path="serving",
                       **nap_times(serv.nap_pack, cat[:b].contiguous(),
                                   flush))
            emit(phase="times", kernel="nap_score", **row)
            nap_rows.append(row)

    mlp_rows = []
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, serv in bundles.items():
        dtype = serv.compute_dtype
        for lname, side, i in layer_inputs(serv.model):
            layer = getattr(serv.ae_pack, side).layers[i]
            for b in MLP_B:
                x = torch.randn(b, layer.w.shape[1], generator=g,
                                device="cuda")
                if dtype == torch.bfloat16 and lname == "encoder.0":
                    x = x.to(dtype)
                row = dict(dtype=name, layer=lname,
                           **mlp_times(layer, x, flush))
                emit(phase="times", kernel="fused_mlp", **row)
                mlp_rows.append(row)
    # one module pass of every canonical layer, summed per (dtype, B)
    for name in bundles:
        for b in MLP_B:
            rows = [r for r in mlp_rows if r["dtype"] == name and r["b"] == b]
            emit(phase="times", kernel="fused_mlp", dtype=name, b=b,
                 layers="encoder+decoder",
                 **{key: sum(r[key] for r in rows)
                    for key in ("ms", "plain_ms", "matmul_ms", "bound_ms")})
    for name, serv in bundles.items():
        for b in (10, 4096):
            emit(phase="times", request="score_nap_windows", dtype=name,
                 b=b, wall_ms=wall_ms(lambda: serv.score_nap_windows(
                     req_x[:b])))
        emit(phase="times", request="score_fused", dtype=name, b=4096,
             wall_ms=wall_ms(lambda: serv.score_fused(req_x)))
    return (run_row, {(r["dtype"], r["b"]): r for r in nap_rows},
            {(r["dtype"], r["layer"], r["b"]): r for r in mlp_rows})


# ---------------------------------------------------------------------------
# phase 12: the sharded path
# ---------------------------------------------------------------------------

#: phase 12's groups of ranks, (backend, world), run one group after the
#: other: two gloo ranks sharing the card (the eager loop: gloo stages its
#: collectives through the host) and one nccl rank (a world of its own:
#: NCCL refuses two ranks on one device); `sharded_groups` adds one nccl
#: rank on each of up to MAX_NCCL_WORLD cards where the machine has several
SHARDED_GROUPS = (("gloo", 2), ("nccl", 1))
MAX_NCCL_WORLD = 4
SHARDED_EPOCHS = 2
#: the wait for all of phase 12's groups together
SHARDED_WAIT_S = 420
#: the meshed epoch programs, on each rank of a capturable mesh: the
#: variants, and each run's epochs (the eager first, then a replay of each
#: staging slot)
MESHED_PROGRAM_RUNS = {"float32": {}, "vib_k2": VARIANT_RUNS["vib_k2"]}
MESHED_EPOCHS = 3
#: sharded against single scores on the same weights: JAX's own tolerance
#: for its mesh (tests/test_end_to_end.py:133-169)
SHARDED_TOL = dict(rtol=1e-5, atol=1e-6)
#: the first step's gradients, each tensor held against the same step in
#: float64: its max abs error over its max abs may be at most GRAD_RATIO
#: times the single process's for that tensor, plus GRAD_FLOOR.  fp32 alone
#: moves some of these gradients by up to ~1e-2 of their max abs when the
#: rows of the batch are summed in another order (BN's backward cancels
#: large terms), others by 1e-7, so the ranks' other order is held to the
#: single step's own distance from exact arithmetic, tensor by tensor.
GRAD_RATIO = 2.0
GRAD_FLOOR = 1e-4
#: a sharded run's per-epoch losses against the single run's: JAX's
#: (tests/test_end_to_end.py:122-130); Adam turns last bits into steps
HISTORY_RTOL = 1e-1


def sharded_config():
    return canonical_config().replace(n_epochs=SHARDED_EPOCHS, verbose=0)


def sharded_groups() -> tuple:
    count = torch.cuda.device_count()
    return SHARDED_GROUPS + ((("nccl", min(count, MAX_NCCL_WORLD)),)
                             if count >= 2 else ())


def emit_to(path: str):
    """An `emit` that appends its line to `path`: a rank's lines, which
    the parent prints in rank order once the group has ended."""
    def emit_line(**kw) -> None:
        with open(path, "a") as f:
            f.write(json.dumps(kw) + "\n")
    return emit_line


def first_step_grads(cfg, train_x, mesh=None) -> dict:
    """The gradients of the first train step of epoch 0 from the seeded
    model: the global batch JAX's epoch order gives, on one device or
    sharded over `mesh`."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.train import (
        epoch_permutation,
        make_optimizer,
        train_step,
    )

    dev = train_x.device
    model = get_model(cfg, device=dev)
    perm = epoch_permutation(cfg.seed, 0, train_x.shape[0]).to(dev)
    train_step(model, make_optimizer(model, cfg.lr),
               train_x[perm[:cfg.batch_size]], None, mesh)
    return {name: p.grad.detach().cpu().numpy()
            for name, p in model.named_parameters()}


def shard_nap_vs_plain(case: str, npack, x: torch.Tensor,
                       report: np.ndarray, seen: set) -> float:
    """Both NAP variants against the plain version in their order of sums
    (`nap_score_staged`) on one rank's shard of the test diffs; the
    variant the shard dispatches must give the report's scores of these
    rows."""
    from icra2021_multimodal_ad_tpu_torch.ops import nap_kernel
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_score,
        nap_score_plain,
    )

    tol = KERNEL_TOL[torch.float32]
    ref = nap_score_staged(npack, x)
    plain = nap_score_plain(npack, x).cpu()
    worst = 0.0
    for variant in variants_of(nap_kernel, torch.float32):
        got = nap_score(npack, x, variant)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.allclose(got, ref, **tol))
        dispatched = variant == nap_kernel.variant_for(torch.float32,
                                                        x.shape[0])
        row = dict(phase="kernel_vs_plain", kernel="nap_score", case=case,
                   b=int(x.shape[0]), k=npack.k, j=npack.j,
                   dtype="torch.float32", variant=variant,
                   dispatched=dispatched, reference="staged",
                   max_abs_err=err,
                   one_product_max_rel_err=max_rel(got, plain), tol=tol,
                   ok=ok)
        if dispatched:
            row["equals_report"] = bool(np.array_equal(
                got.cpu().numpy()[:len(report)], report))
            require(row["equals_report"], f"{case}: the shard's NAP scores "
                                          f"differ from the report's")
        emit(**row)
        require(ok, f"nap_score {case} variant {variant} disagrees with its "
                    f"plain version in its order of sums (max abs err "
                    f"{err})")
        seen.add(("nap_score", variant))
        worst = max(worst, err)
    return worst


def sharded_rank(backend: str, world: int, rank: int, port: int,
                 run_dir: str) -> None:
    """One rank of phase 12, in a process of its own (an nccl rank on card
    `rank`): the first step's gradients, then `NoveltyDetecter` on the
    mesh for SHARDED_EPOCHS epochs and `test()`, the kernels' counts set to
    0 just before and read just after; then each kernel against its plain
    version on this rank's shards of the path's inputs; on a capturable
    mesh, the meshed epoch programs (`meshed_programs`).  Writes its lines
    to a jsonl and its numbers to an npz of `run_dir`."""
    import torch.distributed as dist

    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_pack,
        nap_score,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.rapp import get_diffs
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
        concat_diffs,
        load_nap_stats,
    )
    from icra2021_multimodal_ad_tpu_torch.parallel.distributed import (
        initialize_multihost,
        shutdown,
    )
    from icra2021_multimodal_ad_tpu_torch.parallel.mesh import (
        get_mesh,
        pad_to_multiple,
        shard_batch,
    )
    from icra2021_multimodal_ad_tpu_torch.train import NoveltyDetecter

    global emit
    tag = f"{backend}{world}_rank{rank}"
    emit = emit_to(os.path.join(run_dir, f"{tag}.jsonl"))
    if backend == "nccl":
        os.environ["LOCAL_RANK"] = str(rank)  # get_mesh: one card a rank
    require(initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                 backend=backend, timeout_s=300),
            f"{tag}: no process group")
    mesh = get_mesh(world, device=DEV)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)  # "cuda" is this rank's card
    cfg = sharded_config()
    data = {k: v.to(mesh.device) if isinstance(v, torch.Tensor) else v
            for k, v in torch.load(os.path.join(run_dir, "windows.pt"),
                                   weights_only=False).items()}
    grads = first_step_grads(cfg, data["train_x"], mesh)

    reset_counts()
    det = NoveltyDetecter(cfg, mesh=mesh)
    trained = det.train(get_model(cfg, device=mesh.device), data["train_x"],
                        data["valid_x"])
    stats_path = os.path.join(run_dir, f"nap_stats_{backend}{world}.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reports = det.test(trained.model, data["train_x"], data["valid_x"],
                       data["test_x"], data["test_y"],
                       save_stats_path=stats_path)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    launches = read_counts()

    # every kernel against its plain version on this rank's shards: the
    # FC layers at each split's first chunk, the NAP score on the test rows
    seen: set = set()
    bs = cfg.batch_size
    shards = {split: shard_batch(mesh, pad_to_multiple(
        data[f"{split}_x"][:bs], world)[0]) for split in
        ("train", "valid", "test")}
    mlp_err = path_mlp_vs_plain(f"sharded {tag}", trained.model, shards,
                                seen)
    dist.barrier()  # rank 0 wrote the stats
    npack = nap_pack(load_nap_stats(stats_path).to(mesh.device))
    end = cfg.n_layers + 1 - cfg.end_layer_index
    cat = concat_diffs(get_diffs(data["test_x"], trained.model,
                                 batch_size=bs, mesh=mesh),
                       cfg.start_layer_index, end)
    b = -(-cat.shape[0] // world)
    nap_err = shard_nap_vs_plain(
        f"sharded {tag} test", npack,
        shard_batch(mesh, pad_to_multiple(cat, world)[0]),
        reports[2].score[rank * b:(rank + 1) * b], seen)
    require({k for k, _ in seen} == {"nap_score", "fused_mlp"},
            f"{tag}: checked {sorted(seen)}")
    programs = {"launches": {}, "mlp_err": 0.0}
    if mesh.capturable:
        programs = meshed_programs(mesh, data["train_x"], data["valid_x"],
                                   tag)
    np.savez(os.path.join(run_dir, f"{tag}.npz"),
             **{f"grad/{k}": v for k, v in grads.items()},
             train_history=trained.train_history,
             valid_history=trained.valid_history,
             train_ms=trained.train_ms, eval_ms=trained.eval_ms,
             test_s=test_s, **{f"launches/{k}": n
                               for k, n in launches.items()},
             mlp_err=mlp_err,
             nap_err=nap_err,
             **{f"programs_launches/{k}": n
                for k, n in programs["launches"].items()},
             programs_mlp_err=programs["mlp_err"],
             **{f"score/{n}": r.score for n, r in zip(("base", "sap", "nap"),
                                                      reports)},
             **{f"auroc/{n}": r.auroc for n, r in zip(("base", "sap", "nap"),
                                                      reports)})
    if rank == 0:
        torch.save({k: v.cpu() for k, v in
                    trained.model.state_dict().items()},
                   os.path.join(run_dir, f"{backend}{world}_model.pt"))
    dist.barrier()
    shutdown()


def meshed_programs(mesh, x: torch.Tensor, xv: torch.Tensor,
                    tag: str) -> dict:
    """Phase 12 on a capturable mesh, at Config() widths on phase 5's
    windows: the trainer's epoch programs with the mesh's collectives
    inside, per-epoch and fused (the fused loop under
    `no_sync_from_first_replay_to_fetch`), MESHED_EPOCHS epochs in each
    MESHED_PROGRAM_RUNS variant, and the meshed eager loop, each from the
    seeded model with the counts reset just before and read just after:
    both program runs must leave the eager loop's weights, BN buffers and
    Adam state bit for bit, and its histories (fused: their fp32
    quotients), with the FC kernel's launches by count; the FC kernel
    against its plain version on the validation program's shard.  Then
    the profile (`trainer_profile`: 2 graph launches an epoch, none from
    the host).  Returns the program runs' launches and the FC kernel's
    worst abs err."""
    from icra2021_multimodal_ad_tpu_torch.parallel.mesh import (
        pad_to_multiple,
        shard_batch,
    )
    from icra2021_multimodal_ad_tpu_torch.train import (
        train_all_epochs,
        train_all_epochs_eager,
    )

    base = canonical_config().replace(n_epochs=MESHED_EPOCHS, verbose=0)
    want_fc = (base.n_epochs * -(-VALID_ROWS // base.batch_size) * 2
               * base.n_layers)
    shard = shard_batch(mesh, pad_to_multiple(
        xv[:base.batch_size], mesh.world_size)[0])
    where = [mesh.backend, mesh.world_size, mesh.rank, str(mesh.device)]
    launches = dict.fromkeys(read_counts(), 0)
    seen: set = set()
    worst = 0.0
    for name, options in MESHED_PROGRAM_RUNS.items():
        cfg = base.replace(**options)
        runs = {}
        for mode, loop, kw in (("eager", train_all_epochs_eager, {}),
                               ("per_epoch", train_all_epochs,
                                dict(fused=False)),
                               ("fused", train_all_epochs, dict(fused=True))):
            with (no_sync_from_first_replay_to_fetch() if mode == "fused"
                  else contextlib.nullcontext()):
                res, opt, got, wall_s = train_loop(cfg, loop, x, xv,
                                                   mesh=mesh, **kw)
            runs[mode] = dict(state=run_state(res, opt), launches=got,
                              wall_s=wall_s, train_ms=res.train_ms,
                              eval_ms=res.eval_ms)
            if mode == "fused":
                worst = max(worst, path_mlp_vs_plain(
                    f"sharded programs {tag} {name} validation shard",
                    res.model, {"valid": shard}, seen))
            if mode != "eager":
                for k in launches:
                    launches[k] += got[k]
            del res, opt
        eager = runs["eager"]["state"]
        diffs = {"per_epoch": state_diffs(runs["per_epoch"]["state"], eager),
                 "fused": state_diffs(runs["fused"]["state"], eager,
                                      fp32_history=True)}
        emit(phase="sharded_programs", mesh=where, variant=name,
             options=options, rows=[TRAIN_ROWS, VALID_ROWS],
             shard_rows=int(shard.shape[0]), n_epochs=cfg.n_epochs,
             batch_size=cfg.batch_size,
             histories={m: r["state"]["history"] for m, r in runs.items()},
             differs_from_eager=diffs,
             seconds={m: r["wall_s"] for m, r in runs.items()},
             train_ms={m: r["train_ms"] for m, r in runs.items()},
             eval_ms={m: r["eval_ms"] for m, r in runs.items()},
             launches={m: r["launches"] for m, r in runs.items()},
             want_fused_mlp=want_fc)
        for what, d in diffs.items():
            require(not d, f"sharded programs {tag} {name}: the {what} run "
                           f"differs from the meshed eager loop in {d[:5]}")
        for mode, r in runs.items():
            require(r["launches"]["fc_layers"] == want_fc,
                    f"sharded programs {tag} {name} {mode}: "
                    f"{r['launches']['fc_layers']} FC layers on the kernel, "
                    f"not {want_fc}")
            require(all(np.isfinite(h).all() for h in r["state"]["history"]),
                    f"sharded programs {tag} {name} {mode}: non-finite "
                    f"losses")
        del runs
        gc.collect()
        torch.cuda.empty_cache()
    require({k for k, _ in seen} == {"fused_mlp"},
            f"sharded programs {tag}: checked {sorted(seen)}")
    trainer_profile(mesh=mesh, windows=(x, xv))
    return {"launches": launches, "mlp_err": worst}


@torch.enable_grad()
def f64_first_step_grads(cfg, train_x) -> dict:
    """`first_step_grads` in float64, the autoencoder's train-mode forward
    written out (Linear, LeakyReLU 0.2, batch-statistics BN; the last layer
    of each module Linear alone), from the same seeded weights."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.models.layers import BN_EPS
    from icra2021_multimodal_ad_tpu_torch.train import epoch_permutation

    model = get_model(cfg, device=train_x.device)
    p64 = {n: p.detach().double().requires_grad_()
           for n, p in model.named_parameters()}
    perm = epoch_permutation(cfg.seed, 0, train_x.shape[0]).to(train_x.device)
    x = train_x[perm[:cfg.batch_size]].double()
    h = x
    for side in ("encoder", "decoder"):
        for i, layer in enumerate(getattr(model, side).net):
            pre = f"{side}.net.{i}"
            h = h @ p64[f"{pre}.layer.weight"].t() + p64[f"{pre}.layer.bias"]
            if layer.act is not None:
                h = torch.nn.functional.leaky_relu(h, 0.2)
            if layer.bn is not None:
                mean = h.mean(dim=0)
                var = ((h - mean) ** 2).mean(dim=0)
                h = ((h - mean) / torch.sqrt(var + BN_EPS)
                     * p64[f"{pre}.bn.weight"] + p64[f"{pre}.bn.bias"])
    ((h - x) ** 2).sum().backward()
    return {n: p.grad.cpu().numpy() for n, p in p64.items()}


def grads_err(got: dict, want: dict, prefix: str = "") -> dict:
    """Each tensor's max abs difference over the reference's max abs."""
    return {name: float(np.abs(got[f"{prefix}{name}"] - w).max()
                        / np.abs(w).max()) for name, w in want.items()}


def phase_sharded(smi: str):
    """Phase 12: the data-parallel path, the ranks of each group of
    `sharded_groups` spawned (on the one card, or an nccl rank on each of
    several), held against the single process on phase 5's windows.
    Returns (gloo rank 0's launches, the meshed program runs' launches of
    the first rank that ran them, the kernels' worst abs errs)."""
    import multiprocessing

    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.train import NoveltyDetecter

    t_phase = time.perf_counter()
    cfg = sharded_config()
    train_x, valid_x, test_x, test_y = phase5_windows(cfg)
    run_dir = os.path.join(RUN_DIR, "sharded")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    torch.save({"train_x": train_x.cpu(), "valid_x": valid_x.cpu(),
                "test_x": test_x.cpu(), "test_y": test_y},
               os.path.join(run_dir, "windows.pt"))

    # the single process first, alone on the card, and float64
    grads = first_step_grads(cfg, train_x)
    grads64 = f64_first_step_grads(cfg, train_x)
    single_err = grads_err(grads, grads64)
    single = NoveltyDetecter(cfg, device=DEV).train(
        get_model(cfg, device=DEV), train_x, valid_x)

    ctx = multiprocessing.get_context("spawn")
    groups = sharded_groups()
    deadline = time.perf_counter() + SHARDED_WAIT_S
    ranks_s = {}
    res = {}
    for backend, world in groups:
        port = free_port()
        procs = [ctx.Process(target=sharded_rank,
                             args=(backend, world, rank, port, run_dir))
                 for rank in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(deadline - time.perf_counter(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        ranks_s[f"{backend}{world}"] = time.perf_counter() - t0
        # every rank's lines first, in rank order, then its exit
        for rank in range(world):
            log = os.path.join(run_dir, f"{backend}{world}_rank{rank}.jsonl")
            if os.path.exists(log):
                with open(log) as f:
                    sys.stdout.write(f.read())
        sys.stdout.flush()
        for rank, p in enumerate(procs):
            require(p.exitcode == 0, f"phase 12 {backend} rank {rank} of "
                                     f"{world} exited {p.exitcode}")
        for rank in range(world):
            with np.load(os.path.join(
                    run_dir, f"{backend}{world}_rank{rank}.npz")) as z:
                res[f"{backend}{world}_rank{rank}"] = {k: z[k]
                                                       for k in z.files}

    # the single process's test() on the gloo run's weights: the sharded
    # and single scores of one model
    model = get_model(cfg, device=DEV)
    model.load_state_dict(torch.load(os.path.join(run_dir,
                                                  "gloo2_model.pt")))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reports = NoveltyDetecter(cfg, device=DEV).test(
        model.eval(), train_x, valid_x, test_x, test_y,
        save_stats_path=False)
    torch.cuda.synchronize()
    single_test_s = time.perf_counter() - t1

    want_fc = want_run_launches(cfg)
    g0 = res["gloo2_rank0"]
    # every reading first, in the phase's line; the checks after it, so a
    # failing run still prints what it read
    score_err = {name: max_rel(torch.from_numpy(g0[f"score/{name}"]),
                               r.score)
                 for name, r in zip(("base", "sap", "nap"), reports)}
    grad_err = {key: grads_err(v, grads64, "grad/")
                for key, v in res.items()}
    vs_single = {key: max(grads_err(v, grads, "grad/").values())
                 for key, v in res.items()}
    # each tensor's error over its own bound; above 1 fails
    grad_use = {key: max(e / (GRAD_RATIO * single_err[n] + GRAD_FLOOR)
                         for n, e in err.items())
                for key, err in grad_err.items()}
    hist_err = {}
    for key, v in res.items():
        for k in ("train_history", "valid_history"):
            want = np.asarray(getattr(single, k))
            hist_err[f"{key} {k}"] = float(
                np.max(np.abs(v[k] - want) / np.abs(want)))
    per_rank = {key: {k[len("launches/"):]: int(v[k])
                      for k in v if k.startswith("launches/")}
                for key, v in res.items()}
    programs = {key: {k[len("programs_launches/"):]: int(v[k])
                      for k in v if k.startswith("programs_launches/")}
                for key, v in res.items()}
    programs = {key: n for key, n in programs.items() if n}
    emit(phase="sharded", nvidia_smi=smi, groups=[list(g) for g in groups],
         nccl_world=[w for b, w in groups if b == "nccl"],
         cards=torch.cuda.device_count(),
         epochs=SHARDED_EPOCHS, rows=[TRAIN_ROWS, VALID_ROWS, TEST_ROWS],
         batch_size=cfg.batch_size,
         single_train_epoch_ms=single.train_ms,
         sharded_train_epoch_ms={key: v["train_ms"].tolist()
                                 for key, v in res.items()},
         epoch_ms_clock={"capturable (nccl)": "device, CUDA events around "
                                              "the programs' passes",
                         "gloo on the card": "host, the eager loop"},
         single_test_s=single_test_s,
         sharded_test_s={key: float(v["test_s"]) for key, v in res.items()},
         ranks_wall_s=ranks_s, launches_per_rank=per_rank,
         programs_launches_per_rank=programs,
         want_fused_mlp=want_fc,
         first_step_grad_vs_f64={"single": single_err, **grad_err},
         first_step_grad_vs_single=vs_single, grad_ratio=GRAD_RATIO,
         grad_floor=GRAD_FLOOR, first_step_grad_bound_use=grad_use,
         history_max_rel=hist_err,
         history_rtol=HISTORY_RTOL, score_max_rel=score_err,
         score_tol=SHARDED_TOL,
         auroc={key: {n: float(v[f"auroc/{n}"]) for n in
                      ("base", "sap", "nap")}
                for key, v in res.items()},
         phase_s=time.perf_counter() - t_phase)
    for name, r in zip(("base", "sap", "nap"), reports):
        got = g0[f"score/{name}"]
        require(bool(np.allclose(got, r.score, **SHARDED_TOL)),
                f"phase 12 sharded {name} scores differ from the single "
                f"process's (max rel {score_err[name]})")
        require(np.isfinite(got).all() and got.shape == (TEST_ROWS,),
                f"phase 12 {name} scores are not finite")
    require(all(np.array_equal(res["gloo2_rank1"][f"score/{n}"],
                               g0[f"score/{n}"]) for n in ("base", "sap",
                                                           "nap")),
            "gloo rank 1's reports differ from rank 0's")
    for key, err in grad_err.items():
        over = {n: [e, single_err[n]] for n, e in err.items()
                if e > GRAD_RATIO * single_err[n] + GRAD_FLOOR}
        require(not over, f"phase 12 {key}: first-step gradients [sharded, "
                          f"single] of their max abs from float64: {over}")
    for key, err in hist_err.items():
        require(err <= HISTORY_RTOL, f"phase 12 {key}: max rel {err}")
    for key, n in per_rank.items():
        require(n["nap_score"] == 2 and n["fc_layers"] == want_fc,
                f"phase 12 {key} launched {n}, not 2 NAP and {want_fc} FC "
                f"layers")
    require(bool(programs), "phase 12: no rank ran the meshed epoch "
                            "programs")
    worst = {"nap_score": max(float(v["nap_err"]) for v in res.values()),
             "fused_mlp": max(max(float(v["mlp_err"]),
                                  float(v["programs_mlp_err"]))
                              for v in res.values())}
    return per_rank["gloo2_rank0"], next(iter(programs.values())), worst


# -- phase 13: the trainer's epoch programs --

#: phase 13: the training variants on the epoch programs, at Config()
#: widths on phase 5's windows, 3 epochs each (phase 10's variants but the
#: Gram fit, which trains as fp32 does)
PROGRAM_RUNS = {"float32": {}, **{k: v for k, v in VARIANT_RUNS.items()
                                  if k != "gram_fit"}}
#: the fused mode's histories against the per-epoch mode's (JAX's,
#: tests/test_end_to_end.py:112-119)
MODES_RTOL = 1e-5


@contextlib.contextmanager
def no_sync_from_first_replay_to_fetch():
    """While open, the fused loop of `train.train_all_epochs` runs under
    `torch.cuda.set_sync_debug_mode("error")` from the end of its capture
    (its first replay follows) until its fetch: any host sync in between
    raises."""
    from icra2021_multimodal_ad_tpu_torch.train import EpochPrograms

    capture, fetch = EpochPrograms.capture, EpochPrograms.fetch

    def capture_then_check(self):
        capture(self)
        torch.cuda.set_sync_debug_mode("error")

    def fetch_unchecked(self):
        torch.cuda.set_sync_debug_mode(0)
        return fetch(self)

    EpochPrograms.capture = capture_then_check
    EpochPrograms.fetch = fetch_unchecked
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        EpochPrograms.capture, EpochPrograms.fetch = capture, fetch


def run_state(res, opt=None) -> dict:
    """What a run leaves: its histories, the model's weights and BN
    buffers, and Adam's step and moments (none without `opt`)."""
    return {"history": [list(res.train_history), list(res.valid_history)],
            "model": {k: v.clone() for k, v in
                      res.model.state_dict().items()},
            "adam": [] if opt is None else [
                t.clone() for st in opt.state.values()
                for t in (st["step"], st["exp_avg"], st["exp_avg_sq"])]}


def state_diffs(a: dict, b: dict, fp32_history: bool = False) -> list:
    """What differs between two runs' states, bit for bit; with
    `fp32_history`, b's float64 means rounded to fp32 (a fused run's
    against the eager loop's: the same sums, divided in fp32)."""
    hist = b["history"]
    if fp32_history:
        hist = [[float(np.float32(v)) for v in h] for h in hist]
    out = [] if a["history"] == hist else ["history"]
    out += [k for k in a["model"] if not torch.equal(a["model"][k],
                                                     b["model"][k])]
    if len(a["adam"]) != len(b["adam"]) or any(
            not torch.equal(x, y) for x, y in zip(a["adam"], b["adam"])):
        out.append("adam")
    return out


def train_loop(cfg, loop, x, xv, **kw):
    """One run of `loop` (`train_all_epochs` or `train_all_epochs_eager`)
    from the seeded model: (result, optimizer, launches, seconds)."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.train import make_optimizer

    model = get_model(cfg)
    opt = make_optimizer(model, cfg.lr)
    reset_counts()
    t0 = time.perf_counter()
    res = loop(model, opt, x, xv, cfg.seed, cfg.batch_size, cfg.n_epochs,
               **kw)
    torch.cuda.synchronize()
    return res, opt, read_counts(), time.perf_counter() - t0


def captured_trainer(cfg, x, xv, n_epochs: int, mesh=None):
    """A seeded model's fused epoch programs, on `mesh` if given, with
    epoch 0 run (eagerly, the warm-up) and the programs captured:
    (programs, capture ms, MiB of device memory the capture reserved: the
    graphs' pool)."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.train import (
        EpochPrograms,
        make_optimizer,
    )

    model = get_model(cfg)
    progs = EpochPrograms(model, make_optimizer(model, cfg.lr), x, xv,
                          cfg.seed, cfg.batch_size, n_epochs, fused=True,
                          mesh=mesh)
    progs.stage(0)
    progs.launch(0)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    progs.capture()
    capture_ms = (time.perf_counter() - t0) * 1e3
    held = (torch.cuda.memory_reserved() - before) / 2 ** 20
    progs.stage(1)
    return progs, capture_ms, held


def replay_epochs(progs, first: int, last: int) -> dict:
    """Epochs [first, last) of captured programs as the fused loop runs
    them (launch, then stage the next), timed on the host to a final
    synchronize: ms per epoch, and the host's ms per epoch in the
    launches, waiting for the next epoch's slot (its launch two epochs
    back) and staging (the order and key draws, written to pinned
    memory)."""
    torch.cuda.synchronize()
    spent = dict.fromkeys(("launch", "slot_wait", "stage"), 0.0)
    t0 = time.perf_counter()
    for epoch in range(first, last):
        t1 = time.perf_counter()
        progs.launch(epoch)
        t2 = time.perf_counter()
        progs.train.wait((epoch + 1) % 2)
        t3 = time.perf_counter()
        progs.stage(epoch + 1)
        spent["launch"] += t2 - t1
        spent["slot_wait"] += t3 - t2
        spent["stage"] += time.perf_counter() - t3
    torch.cuda.synchronize()
    n = last - first
    return {"epoch_ms": (time.perf_counter() - t0) * 1e3 / n,
            **{f"host_{k}_ms": v * 1e3 / n for k, v in spent.items()}}


def trainer_profile(smi: str = "", mesh=None, windows=None) -> dict:
    """Captured fused epochs and eager epochs under torch.profiler
    (`profile_calls`, one epoch a call) at phase 5's shape in fp32 (on
    `windows`, (train, valid), if given), on `mesh` if given: a captured
    epoch must be 2 graph launches and no kernel launch from the host, and
    run the FC kernel inside its validation graph; the device's busy ms
    and the host's share of each."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.train import (
        epoch_permutation,
        eval_epoch,
        make_optimizer,
        train_epoch,
        vib_epoch_key,
    )

    cfg = canonical_config()
    train_x, valid_x = windows or phase5_windows(cfg)[:2]
    calls = 5
    progs, _, _ = captured_trainer(cfg, train_x, valid_x, 4 + calls + 2,
                                   mesh)
    epochs = iter(range(1, 4 + calls + 1))

    def captured():
        epoch = next(epochs)
        progs.launch(epoch)
        progs.stage(epoch + 1)

    reset_counts()
    prof = profile_calls(captured, calls)
    counts = read_counts()
    train_ms, eval_ms = progs.times_ms()
    del progs
    model = get_model(cfg)
    opt = make_optimizer(model, cfg.lr)
    n = train_x.shape[0]
    eager_epoch = iter(range(100))

    def eager():
        epoch = next(eager_epoch)
        float(train_epoch(model, opt, train_x,
                          epoch_permutation(cfg.seed, epoch, n),
                          cfg.batch_size, vib_epoch_key(cfg.seed, epoch),
                          mesh))
        float(eval_epoch(model, valid_x, cfg.batch_size, mesh))

    eager_prof = profile_calls(eager, calls)
    t0 = time.perf_counter()
    epoch_permutation(cfg.seed, 0, n)
    draw_ms = (time.perf_counter() - t0) * 1e3
    per_epoch_fc = (-(-VALID_ROWS // cfg.batch_size)) * 2 * cfg.n_layers
    row = dict(phase="trainer_profile",
               mesh=None if mesh is None else [
                   mesh.backend, mesh.world_size, mesh.rank,
                   str(mesh.device)],
               captured=prof, eager=eager_prof,
               fc_layers_per_captured_epoch=counts["fc_layers"] / (4 + calls),
               want_fc_layers_per_epoch=per_epoch_fc,
               captured_device_train_ms=train_ms,
               captured_device_valid_ms=eval_ms,
               host_permutation_draw_ms=draw_ms, card=smi)
    emit(**row)
    require(prof["graph_launches_per_call"] == 2
            and prof["host_kernel_launches_per_call"] == 0,
            f"a captured epoch made {prof['graph_launches_per_call']} graph "
            f"launches and {prof['host_kernel_launches_per_call']} kernel "
            f"launches from the host, not 2 and 0")
    fc = sum(n for k, n in prof["kernel_launches_per_call"].items()
             if k.startswith("fc_"))
    require(fc > 0, "the captured validation pass ran no FC kernel")
    require(counts["fc_layers"] == per_epoch_fc * (4 + calls),
            f"{counts['fc_layers']} FC layers counted over {4 + calls} "
            f"replayed epochs, not {per_epoch_fc} each")
    return row


def phase_trainer_programs(smi: str, seen: set):
    """Phase 13: the trainer's epoch programs at Config() widths on phase
    5's windows, 3 epochs, in every PROGRAM_RUNS variant: the eager loop,
    the per-epoch programs and the fused programs (under
    `no_sync_from_first_replay_to_fetch`), each from the seeded model with
    its counts reset just before and read just after; then a run
    checkpointed after epoch 1 and resumed to 3.  Both program runs must
    leave the eager loop's weights, BN buffers and Adam state bit for bit,
    the per-epoch run its histories and the fused run their fp32
    quotients; fused and per-epoch histories within MODES_RTOL; the resume
    the per-epoch run's histories and weights; the FC kernel against its
    plain version on the validation pass's inputs.  Then the profile
    (`trainer_profile`).  Returns (launches of the program runs, worst abs
    err of the FC kernel)."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.train import (
        NoveltyDetecter,
        train_all_epochs,
        train_all_epochs_eager,
    )

    root = os.path.join(RUN_DIR, "trainer")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    base = canonical_config().replace(n_epochs=3, verbose=0)
    train_x, valid_x, _, _ = phase5_windows(base)
    want_fc = (base.n_epochs * -(-VALID_ROWS // base.batch_size) * 2
               * base.n_layers)
    launches = dict.fromkeys(read_counts(), 0)
    worst = 0.0
    for name, options in PROGRAM_RUNS.items():
        cfg = base.replace(**options)
        dtype = getattr(torch, cfg.train_dtype)
        x, xv = train_x.to(dtype), valid_x.to(dtype)
        runs = {}
        for mode, loop, kw in (("eager", train_all_epochs_eager, {}),
                               ("per_epoch", train_all_epochs,
                                dict(fused=False)),
                               ("fused", train_all_epochs, dict(fused=True))):
            with (no_sync_from_first_replay_to_fetch() if mode == "fused"
                  else contextlib.nullcontext()):
                res, opt, got, wall_s = train_loop(cfg, loop, x, xv, **kw)
            runs[mode] = dict(state=run_state(res, opt), launches=got,
                              wall_s=wall_s, train_ms=res.train_ms,
                              eval_ms=res.eval_ms)
            if mode == "fused":
                worst = max(worst, path_mlp_vs_plain(
                    f"trainer {name} validation", res.model, {"valid": xv},
                    seen, dtype))
            if mode != "eager":
                for k in launches:
                    launches[k] += got[k]
            del res, opt
        ckpt = os.path.join(root, name)
        NoveltyDetecter(cfg.replace(n_epochs=1)).train(
            get_model(cfg), train_x, valid_x, checkpoint_path=ckpt,
            checkpoint_every=1)
        resumed = NoveltyDetecter(cfg).train(
            get_model(cfg.replace(seed=cfg.seed + 1)), train_x, valid_x,
            checkpoint_path=ckpt, resume=True)
        per_epoch, fused = runs["per_epoch"]["state"], runs["fused"]["state"]
        eager = runs["eager"]["state"]
        # the resumed run's weights and histories; the npz checkpoint, in
        # JAX's layout, keeps no BN batch count
        resumed = run_state(resumed)
        for key in [k for k in resumed["model"]
                    if k.endswith("num_batches_tracked")]:
            del resumed["model"][key]
        diffs = {"per_epoch": state_diffs(per_epoch, eager),
                 "fused": state_diffs(fused, eager, fp32_history=True),
                 "resumed": state_diffs(resumed, {**per_epoch, "adam": []})}
        modes_rel = float(np.max(np.abs(
            np.subtract(fused["history"][1], per_epoch["history"][1]))
            / np.abs(per_epoch["history"][1])))
        emit(phase="trainer_programs", variant=name, options=options,
             rows=[TRAIN_ROWS, VALID_ROWS], n_epochs=cfg.n_epochs,
             batch_size=cfg.batch_size,
             histories={m: r["state"]["history"] for m, r in runs.items()},
             differs_from_eager=diffs, fused_vs_per_epoch_max_rel=modes_rel,
             seconds={m: r["wall_s"] for m, r in runs.items()},
             train_ms={m: r["train_ms"] for m, r in runs.items()},
             eval_ms={m: r["eval_ms"] for m, r in runs.items()},
             launches={m: r["launches"] for m, r in runs.items()},
             want_fused_mlp=want_fc, card=smi)
        for what, d in diffs.items():
            require(not d, f"trainer {name}: the {what} run differs from "
                           f"the eager loop in {d[:5]}")
        require(modes_rel <= MODES_RTOL,
                f"trainer {name}: fused and per-epoch valid histories "
                f"{modes_rel} apart")
        for mode, r in runs.items():
            require(r["launches"]["fc_layers"] == want_fc,
                    f"trainer {name} {mode}: {r['launches']['fc_layers']} "
                    f"FC layers on the kernel, not {want_fc}")
            require(all(np.isfinite(h).all() for h in r["state"]["history"]),
                    f"trainer {name} {mode}: non-finite losses")
        del runs, resumed
        gc.collect()
        torch.cuda.empty_cache()
    trainer_profile(smi)
    return launches, worst


TIME_KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "matmul_ms", "tflops", "variant")
#: the small-batch variants' rows also carry variant 0's times (the NAP
#: rows the plain version's device time, the module's rows that of one
#: `torch.mm` per layer)
SMALL_KEYS = ("variant0_ms", "variant0_device_ms", "plain_device_ms",
              "matmul_device_ms")


SHAPE_KEYS = ("b", "k", "j", "n", "layer", "dtype", "path")


def timed(row: dict, path: str) -> dict:
    """A row of times with the shape and the path it was measured at."""
    return {**{k: row[k] for k in TIME_KEYS},
            **{k: row[k] for k in SMALL_KEYS if k in row},
            "shape": {**{k: row[k] for k in SHAPE_KEYS if k in row},
                      "path": path}}


def kernel_entry(name, source, replaces, launches, worst, head, others,
                 path="frontend_cli"):
    """One kernel of the `kernels` line: its launches on its main path (the
    train CLI's, phase 7b, for the per-call variants; the streaming tick's,
    phase 8c, for the small-batch ones) and on every other path, its times
    at the shape that path gives it (`head`, measured on that path's own
    inputs), and under `other_shapes` the rows of the other paths, each
    with its shape and path."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[path],
            "launches_by_path": launches, "max_abs_err": worst,
            **timed(head, path), "library_ms": None,
            "other_shapes": others}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from icra2021_multimodal_ad_tpu_torch.ops import mlp_kernel, nap_kernel

    smi = phase_device_and_build()
    frontend_rows, worst_frontend = phase_frontend_kernel(smi)
    seen: set = set()
    worst = {"nap_score": nap_vs_plain(seen), "fused_mlp": mlp_vs_plain(seen)}
    every = {(name, v) for name, module in (("nap_score", nap_kernel),
                                            ("fused_mlp", mlp_kernel))
             for v in (*module.VARIANTS.values(), module.SMALL_VARIANT)}
    require(seen == every, f"phase 2 checked {sorted(seen)}, not every "
                           f"variant {sorted(every)}")
    small_rows = phase_small_batches(smi)
    golden_rel = phase_golden()
    bundles, req_x, serving_launches = phase_canonical()
    run_launches, run_err, run_pack, run_cat = phase_train_and_score()
    worst["nap_score"] = max(worst["nap_score"], run_err)
    run_nap, nap_rows, mlp_rows = phase_times(bundles, req_x, run_pack,
                                              run_cat)
    fixture_launches = frontend_golden(golden_rel)
    cli_launches, cli_worst, cli_rows, cli = frontend_cli(smi, seen)
    stream_launches, stream_worst, stream_rows, det = phase_streaming(
        smi, seen)
    phase_etl(smi)
    variant_launches, variant_worst = phase_variants(smi, seen, cli)
    del cli
    late, late_worst = phase_int8_export_server(smi, bundles, req_x, det)
    sharded_launches, programs_launches, sharded_worst = phase_sharded(
        smi)
    trainer_launches, trainer_worst = phase_trainer_programs(smi, seen)
    launches = {k: {"serving": serving_launches[k],
                    "train_and_score": run_launches[k],
                    "fixture": fixture_launches[k],
                    "frontend_cli": cli_launches[k],
                    "streaming": stream_launches[k],
                    "variants": variant_launches[k],
                    **{path: n[k] for path, n in late.items()},
                    "sharded": sharded_launches[k],
                    "sharded_programs": programs_launches[k],
                    "trainer_programs": trainer_launches[k]}
                for k in read_counts()}
    # every path ran every FC layer and every NAP score on a kernel (the
    # trainer's programs, meshed or not, run no NAP score); the small-batch
    # variants ran on the streaming tick
    for k in ("fc_layers", "nap_score"):
        require(all(n for path, n in launches[k].items()
                    if k == "fc_layers" or path not in (
                        "trainer_programs", "sharded_programs")),
                f"{k} launched on no path of {launches[k]}")
    for k in ("fused_mlp_module", "nap_score_small", "frontend_fuse"):
        require(launches[k]["streaming"] > 0,
                f"{k} did not launch on the streaming path")
    for k in ("nap_score", "fused_mlp"):
        worst[k] = max(worst[k], cli_worst[k], stream_worst[k],
                       variant_worst[k], late_worst[k], sharded_worst[k])
    worst["fused_mlp"] = max(worst["fused_mlp"], trainer_worst)
    for k in ("fused_mlp_module", "nap_score_small"):
        worst[k] = max(row["max_abs_err"] for row in [
            stream_rows[k], *(r for (name, *_), r in small_rows.items()
                              if name == k)])
    print(json.dumps({"kernels": [
        kernel_entry(
            "nap_score",
            "icra2021_multimodal_ad_tpu_torch/csrc/nap_score.cu",
            "icra2021_multimodal_ad_tpu/ops/pallas_kernels.py:37",
            launches["nap_score"], worst["nap_score"], cli_rows["nap_score"],
            [timed(run_nap, "train_and_score"),
             timed(nap_rows[("float32", 4096)], "serving"),
             timed(stream_rows["nap_score"], "streaming")]),
        kernel_entry(
            "fused_mlp",
            "icra2021_multimodal_ad_tpu_torch/csrc/fused_mlp.cu",
            "icra2021_multimodal_ad_tpu/ops/pallas_kernels.py:262",
            launches["fused_mlp"], worst["fused_mlp"], cli_rows["fused_mlp"],
            [timed(mlp_rows[("float32", "encoder.0", 7000)],
                   "serving layer at train-and-score's batch"),
             timed(stream_rows["fused_mlp"], "streaming")]),
        kernel_entry(
            "fused_mlp_module",
            "icra2021_multimodal_ad_tpu_torch/csrc/fused_mlp.cu",
            "icra2021_multimodal_ad_tpu/ops/pallas_kernels.py:262",
            launches["fused_mlp_module"], worst["fused_mlp_module"],
            stream_rows["fused_mlp_module"],
            [timed(r, f"small batches {shape}") for (name, shape, _), r
             in small_rows.items() if name == "fused_mlp_module"],
            path="streaming"),
        kernel_entry(
            "nap_score_small",
            "icra2021_multimodal_ad_tpu_torch/csrc/nap_score.cu",
            "icra2021_multimodal_ad_tpu/ops/pallas_kernels.py:37",
            launches["nap_score_small"], worst["nap_score_small"],
            stream_rows["nap_score_small"],
            [timed(r, f"small batches J = {shape}") for (name, shape, _), r
             in small_rows.items() if name == "nap_score_small"],
            path="streaming"),
        kernel_entry(
            "frontend_fuse",
            "icra2021_multimodal_ad_tpu_torch/csrc/frontend_fuse.cu", None,
            launches["frontend_fuse"],
            max(worst_frontend, stream_worst["frontend_fuse"]),
            stream_rows["frontend_fuse"],
            [timed(row, "synthetic payloads")
             for row in frontend_rows.values()],
            path="streaming"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
