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
   whole canonical modules;
3. golden replay: the checked-in model, NAP stats and fixture windows,
   scored through both kernels, against the frozen `nap_score` column;
   then, on these degenerate stats, each bf16 NAP variant must sit
   LO_MARGIN times closer to its plain version than to the same arithmetic
   without the lo half of the centred rows (`lo_half_check`);
4. canonical-width serving: a seeded full-width model (Config() defaults),
   NAP fitted on 4096 windows, fp32 and bf16 bundles answering BASE, SAP and
   NAP requests; every request must launch the FC kernel, every NAP request
   the NAP kernel;
5. train and score, this slice's main path: `novelty_detection.run` at the
   Config() defaults (3 epochs) on seeded windows with a planted anomaly;
   the validation and test passes must launch the FC kernel and the NAP
   scores the NAP kernel; then the NAP kernel against its plain version on
   the stats `run` fitted and the valid and test diffs it scored, and the
   lo-half check on those stats;
6. times on the card: each kernel beside its plain version, the product
   alone (`matmul_ms`) and its bound, with its TFLOP/s, at the serving
   shapes and at the train-and-score NAP shape; every kernel's registers
   (ptxas) and shared memory; end-to-end request latency.

The counts of both kernels are set to 0 just before phases 4 and 5 drive
their path and read just after.  The next-to-last line is {"kernels":
[...]}; the last is {"ok": true, "device": {...}}.  Any failed check
raises, so the script exits non-zero and prints no "ok" line; so does a
host without CUDA.  It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import csv
import json
import os
import statistics
import subprocess
import sys
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
#: phase 2's batches: both sides of every dispatch threshold, the main
#: path's 2048 / 4096 / 7000 and the streaming 1 / 10
CHECK_B = (1, 10, 64, 256, 2048, 4096, 7000)
#: the train-and-score NAP shape (J = min(train rows, K)) and its batches
RUN_NAP_K = RUN_NAP_J = 5482
RUN_NAP_B = (2048, 4096)
TIMED_RUNS = 25
KERNEL_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-5),
              torch.bfloat16: dict(rtol=5e-3, atol=1e-5)}
MLP_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=1e-3, atol=1e-4)}
#: whole-module mean relative error, kernel against plain: summation order
#: may flip a bf16 rounding of a next-layer input
MODULE_MEAN_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: bf16 NAP on degenerate stats: how many times closer to its plain
#: version the kernel must sit than to the plain version without lo
LO_MARGIN = 10.0
#: phase 5: train / valid / test rows (one full batch of 7000 and a tail)
TRAIN_ROWS, VALID_ROWS, TEST_ROWS = 8192, 2048, 4096


#: phase 1's ptxas table, by library, for phase 6
PTXAS: dict = {}


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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
    built = _build.build(["nap_score", "fused_mlp"])
    for name in ("nap_score", "fused_mlp"):
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


def variants_of(module, dtype):
    """(narrow, wide) variant ids of a kernel module for one dtype."""
    return tuple(module.VARIANTS[(dtype, wide)] for wide in (False, True))


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
                for variant in variants_of(nap_kernel, dtype):
                    got = nap_score(pack, x, variant)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    ok = bool(torch.allclose(got, ref, **tol))
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


def _check_layer(name, layer, x, tol, seen: set) -> float:
    from icra2021_multimodal_ad_tpu_torch.ops import mlp_kernel
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer_pair,
        fused_mlp_layer_plain,
    )

    dtype, b = layer.w.dtype, x.shape[0]
    ref = fused_mlp_layer_plain(layer, x)
    worst = 0.0
    for variant in variants_of(mlp_kernel, dtype):
        got, got16 = fused_mlp_layer_pair(layer, x, variant)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.allclose(got, ref, **tol))
        # the bf16 copy the next layer reads is the fp32 output rounded
        ok16 = got16 is None or bool(torch.equal(got16, got.to(dtype)))
        emit(phase="kernel_vs_plain", kernel="fused_mlp", case=name, b=b,
             k=x.shape[1], n=layer.w.shape[0], dtype=str(dtype),
             x_dtype=str(x.dtype), leaky=layer.leaky,
             bn=layer.bn_mean is not None, variant=variant,
             dispatched=variant == mlp_kernel.variant_for(dtype, b),
             max_abs_err=err, tol=tol, ok=ok, bf16_copy_ok=ok16)
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


def phase_golden() -> None:
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
    nap_before, mlp_before = nap_score.launches, fused_mlp_layer.launches
    serving = make_serving(cfg, model, nap_stats=stats)
    s32 = serving.score_nap_windows(x)
    s16 = make_serving(cfg.replace(compute_dtype="bfloat16"), model,
                       nap_stats=stats).score_nap_windows(x)
    torch.cuda.synchronize()
    nap_launches = nap_score.launches - nap_before
    mlp_launches = fused_mlp_layer.launches - mlp_before
    rel = max_rel(s32, col)
    corr = pearson(s32, s16)
    # the design point of csrc/nap_score.cu: the TPU kernel's folded form,
    # x @ V - (mu @ V + std_mu), in plain fp32 on the same diffs
    st = serving.nap_stats
    v = st.rotater.v
    t = ((serving.nap_diffs(x) @ v - (st.rotater.mu @ v + st.standardizer.mu))
         / torch.sqrt(st.standardizer.var))
    # three module passes per bundle, n_layers launches each
    want_mlp = 2 * 3 * cfg.n_layers
    emit(phase="golden", windows=int(x.shape[0]), k=int(v.shape[0]),
         j=int(v.shape[1]), fp32_max_rel_err=rel, rtol=2e-3,
         folded_plain_fp32_max_rel_err=max_rel((t * t).mean(dim=-1), col),
         bf16_pearson_vs_fp32=corr, nap_launches=nap_launches,
         mlp_launches=mlp_launches)
    require(nap_launches == 2, "golden NAP skipped the NAP kernel")
    require(mlp_launches == want_mlp,
            f"golden diffs made {mlp_launches} FC launches, not {want_mlp}")
    require(np.allclose(s32.cpu().numpy(), col, rtol=2e-3),
            f"golden NAP max rel err {rel} above rtol 2e-3")
    require(bool(torch.isfinite(s16).all()) and corr > 0.99,
            f"bf16 golden Pearson {corr} not above 0.99")
    lo_half_check("golden", stats.to("cuda"), serving.nap_diffs(x))


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
    model = get_model(cfg, torch.Generator().manual_seed(cfg.seed))
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
    nap_score.launches = fused_mlp_layer.launches = 0
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
            nap0, mlp0 = nap_score.launches, fused_mlp_layer.launches
            r[label] = fn()
            torch.cuda.synchronize()
            if "nap" in kernels:
                require(nap_score.launches > nap0,
                        f"{name} {label} did not launch the NAP kernel")
            if "mlp" in kernels:
                require(fused_mlp_layer.launches > mlp0,
                        f"{name} {label} did not launch the FC kernel")
        out[name] = r
    launches = {"nap_score": nap_score.launches,
                "fused_mlp": fused_mlp_layer.launches}

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


def run_nap_vs_plain(cfg, res, valid_x, test_x):
    """The NAP kernel against its plain version on the fp32 pack of the
    stats `run` fitted and saved, and on the valid and test concat diffs it
    scored; the kernel's test scores must be the report's.  Both also face
    a float64 transform of the same diffs, on whitening stats that a
    trained model's low-rank diffs make near-degenerate.  Returns (worst
    abs err, pack, test diffs) for the times."""
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
        ref = nap_score_plain(npack, cat)
        f64 = nap_score_f64(stats, cat)
        err = float((got - ref).abs().max())
        row = dict(phase="kernel_vs_plain", kernel="nap_score",
                   case=f"train_and_score {name}", b=int(cat.shape[0]),
                   k=npack.k, j=npack.j, dtype="torch.float32",
                   min_var=float(stats.standardizer.var.min()),
                   max_abs_err=err,
                   max_rel_err=float(((got - ref).abs() / ref.abs()).max()),
                   kernel_vs_f64_max_rel=max_rel(got, f64.cpu()),
                   plain_vs_f64_max_rel=max_rel(ref, f64.cpu()),
                   tol=tol, ok=bool(torch.allclose(got, ref, **tol)))
        if name == "test":
            row["equals_report"] = bool(np.array_equal(got.cpu().numpy(),
                                                       res.nap.score))
        checks.append(row)
        emit(**row)
        worst = max(worst, err)
    for row in checks:
        require(row["ok"], f"nap_score {row['case']} disagrees with its "
                           f"plain version (max abs err {row['max_abs_err']})")
    require(checks[-1]["equals_report"],
            "the NAP kernel's test scores differ from run()'s NAP report")
    lo_half_check("train_and_score test", stats, cat)
    return worst, npack, cat


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
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    mix = torch.randn(16, cfg.input_size, generator=gen, device="cuda")
    train_x = seeded_windows(TRAIN_ROWS, 0, gen, mix)
    valid_x = seeded_windows(VALID_ROWS, 0, gen, mix)
    test_x = seeded_windows(TEST_ROWS // 2, TEST_ROWS // 2, gen, mix)
    test_y = np.r_[np.zeros(TEST_ROWS // 2), np.ones(TEST_ROWS // 2)]
    torch.cuda.synchronize()

    # the train-and-score path: counts start at 0 here and are read right
    # after
    nap_score.launches = fused_mlp_layer.launches = 0
    t0 = time.perf_counter()
    res = run(cfg, train_x, valid_x, test_x, test_y)
    wall_s = time.perf_counter() - t0
    launches = {"nap_score": nap_score.launches,
                "fused_mlp": fused_mlp_layer.launches}

    layers = 2 * cfg.n_layers
    chunks = lambda n: -(-n // cfg.batch_size)  # noqa: E731
    want_eval = cfg.n_epochs * chunks(VALID_ROWS) * layers
    want_test = sum(chunks(n) for n in (TRAIN_ROWS, VALID_ROWS, TEST_ROWS)
                    ) * 3 * cfg.n_layers
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
        launches=launches, want_fused_mlp=want_eval + want_test,
        csv=os.path.relpath(res.csv_path, ROOT))
    emit(**row)
    require(all(np.isfinite(tr)) and all(np.isfinite(va)),
            "non-finite losses")
    require(tr[-1] < tr[0], f"train loss did not fall: {tr}")
    require(abs(restored - va[best]) <= 1e-5 * abs(va[best]),
            f"returned model's valid loss {restored} is not the minimum "
            f"{va[best]}")
    require(launches["fused_mlp"] == want_eval + want_test,
            f"{launches['fused_mlp']} FC launches, not the "
            f"{want_eval} of the validation passes and the {want_test} of "
            f"the test diffs")
    require(launches["nap_score"] == 2, "test NAP skipped the NAP kernel")
    for k, r in reports.items():
        require(np.isfinite(r.score).all() and r.score.shape == (TEST_ROWS,)
                and np.isfinite([r.auroc, r.aupr]).all(),
                f"{k} report is not finite")
    require(os.path.exists(res.csv_path), "no result CSV")
    return (launches, *run_nap_vs_plain(cfg, res, valid_x, test_x))


def tflops(ops: float, ms: float) -> float:
    return ops / ms / 1e9


def nap_times(pack, x, flush) -> dict:
    """The NAP kernel's row of times at one (B, K, J) shape; `tflops` is
    the product's 2BKJ over the kernel's time."""
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_score,
        nap_score_plain,
        variant_for,
    )

    b = int(x.shape[0])
    xd = x.to(pack.v.dtype)
    got, ref = nap_score(pack, x), nap_score_plain(pack, x)
    bound_ms, bound_by = nap_bound(b, pack.k, pack.j, pack.v.dtype)
    ms = time_ms(lambda: nap_score(pack, x), flush)
    return dict(b=b, k=pack.k, j=pack.j,
                variant=variant_for(pack.v.dtype, b), ms=ms,
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
    return {name: {"ptxas": PTXAS.get(name),
                   "dynamic_smem_by_variant": {
                       v: smem[name](v) for v in module.VARIANTS.values()}}
            for name, module in (("fused_mlp", mlp_kernel),
                                 ("nap_score", nap_kernel))}


def phase_times(bundles, req_x, run_pack, run_cat):
    from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
        fused_mlp_layer,
        fused_mlp_layer_plain,
        variant_for,
    )
    emit(phase="times", resources=kernel_resources())
    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
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
            n, k = layer.w.shape
            for b in MLP_B:
                x = torch.randn(b, k, generator=g, device="cuda")
                if dtype == torch.bfloat16 and lname == "encoder.0":
                    x = x.to(dtype)
                xd = x.to(dtype)
                wt = layer.w.t()
                mm = ((lambda: torch.mm(xd, wt)) if dtype == torch.float32
                      else (lambda: torch.mm(xd, wt,
                                             out_dtype=torch.float32)))
                bound_ms, bound_by = mlp_bound(layer, x)
                ms = time_ms(lambda: fused_mlp_layer(layer, x), flush)
                row = dict(dtype=name, layer=lname, b=b, k=k, n=n,
                           x_dtype=str(x.dtype),
                           variant=variant_for(dtype, b), ms=ms,
                           tflops=tflops(2 * b * k * n, ms),
                           plain_ms=time_ms(
                               lambda: fused_mlp_layer_plain(layer, x),
                               flush),
                           matmul_ms=time_ms(mm, flush),
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
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


TIME_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "matmul_ms", "tflops",
             "variant")


def kernel_entry(name, source, replaces, launches, worst, head, shape,
                 serving=None):
    """One kernel of the `kernels` line: launches and times on the
    train-and-score path (`head`, at `shape`), and where the serving path
    runs it at another shape, that row beside it."""
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches["train_and_score"],
             "launches_by_path": launches, "max_abs_err": worst,
             **{k: head[k] for k in TIME_KEYS}, "library_ms": None,
             "shape": shape}
    if serving is not None:
        entry["serving"] = serving
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from icra2021_multimodal_ad_tpu_torch.ops import mlp_kernel, nap_kernel

    phase_device_and_build()
    seen: set = set()
    worst = {"nap_score": nap_vs_plain(seen), "fused_mlp": mlp_vs_plain(seen)}
    every = {(name, v) for name, module in (("nap_score", nap_kernel),
                                            ("fused_mlp", mlp_kernel))
             for v in module.VARIANTS.values()}
    require(seen == every, f"phase 2 checked {sorted(seen)}, not every "
                           f"variant {sorted(every)}")
    phase_golden()
    bundles, req_x, serving_launches = phase_canonical()
    run_launches, run_err, run_pack, run_cat = phase_train_and_score()
    worst["nap_score"] = max(worst["nap_score"], run_err)
    run_nap, nap_rows, mlp_rows = phase_times(bundles, req_x, run_pack,
                                              run_cat)
    launches = {k: {"serving": serving_launches[k],
                    "train_and_score": run_launches[k]}
                for k in ("nap_score", "fused_mlp")}
    print(json.dumps({"kernels": [
        kernel_entry(
            "nap_score",
            "icra2021_multimodal_ad_tpu_torch/csrc/nap_score.cu",
            "icra2021_multimodal_ad_tpu/ops/pallas_kernels.py:37",
            launches["nap_score"], worst["nap_score"], run_nap,
            {"b": run_nap["b"], "k": run_nap["k"], "j": run_nap["j"],
             "dtype": "float32", "path": "train_and_score"},
            serving={**{k: nap_rows[("float32", 4096)][k]
                        for k in TIME_KEYS},
                     "shape": {"b": 4096, "k": CANON_K, "j": CANON_J,
                               "dtype": "float32"}}),
        kernel_entry(
            "fused_mlp",
            "icra2021_multimodal_ad_tpu_torch/csrc/fused_mlp.cu",
            "icra2021_multimodal_ad_tpu/ops/pallas_kernels.py:262",
            launches["fused_mlp"], worst["fused_mlp"],
            mlp_rows[("float32", "encoder.0", 7000)],
            {"b": 7000, "k": 1728, "n": 1402, "dtype": "float32",
             "path": "train_and_score"}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
