"""The fp32 NAP kernel's order of sums, held to the golden contract.

Every fp32 route of `csrc/nap_score.cu` sums K in two levels: each 32-deep
stage is its own fmaf chain in k order from 0, and the stage totals are
added to a running total in stage order (the order `csrc/fused_mlp.cu`
has always used).  The golden fixture's whitening divides by variances
down to 2.2e-13, so it amplifies the rounding of the RaPP diffs by ~2e6
and the 2e-3 contract on the frozen `nap_score` column measures that
order.  These tests replay both kernels' arithmetic exactly in numpy, as
scripts/golden_summation_study.py does (the FC kernel's two-level diffs,
then the NAP whitening), on the checked-in model, stats and windows.  On
the CPU they also tie the replay to the port: its whitening reads the
port's own kernel operands (`nap_pack`), and the port's CPU route (one
product over K, `nap_score_plain`) scores the replayed diffs inside the
contract.  The kernels' order itself is held to the replay on the card
(the test marked `cuda`).
"""

from __future__ import annotations

import csv
import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "datasets", "golden")
#: tests/test_golden_fixture.py:109's contract on the `nap_score` column
GOLDEN_RTOL = 2e-3


def _study():
    spec = importlib.util.spec_from_file_location(
        "golden_summation_study",
        os.path.join(ROOT, "scripts", "golden_summation_study.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def golden():
    """(study module, NAP stats, the kernel's two-level diffs, column)."""
    from icra2021_multimodal_ad_tpu_torch.models.autoencoder import ae_pack
    from icra2021_multimodal_ad_tpu_torch.models.builder import load_model
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import load_nap_stats

    study = _study()
    _, model = load_model(os.path.join(GOLDEN, "model"), device="cpu")
    stats = load_nap_stats(os.path.join(GOLDEN, "nap_stats.npz"))
    x = np.load(os.path.join(GOLDEN, "fixture_windows.npz"))["x"]
    with open(os.path.join(GOLDEN, "caltime_test.csv"), newline="") as f:
        col = np.array([float(r["nap_score"]) for r in csv.DictReader(f)])
    return study, stats, study.diffs(ae_pack(model), x, "two_level"), col


def _max_rel(study, stats, d, col, whitening: str) -> float:
    s = study.nap(stats, d, whitening)
    return float(np.max(np.abs(s - col) / col))


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("whitening", ["two_level", "chain"])
def test_golden_column_within_contract(golden, whitening):
    """The kernel's diffs, whitened in two levels (every fp32 NAP route
    now) or in the one chain over K they replaced, stay inside the golden
    contract; two levels land at ~3.6e-4."""
    study, stats, d, col = golden
    err = _max_rel(study, stats, d, col, whitening)
    assert err < GOLDEN_RTOL
    if whitening == "two_level":
        assert err < 5e-4, err


def test_two_levels_no_farther_than_one_chain(golden):
    """Splitting K into 32-deep stages moves the golden figure away from
    its limit: no farther from the column than one chain (1.009e-3)."""
    study, stats, d, col = golden
    assert (_max_rel(study, stats, d, col, "two_level")
            <= _max_rel(study, stats, d, col, "chain"))


def test_stage_sum_is_the_kernels_order():
    """The emulated order: each 32-deep stage its own chain from 0, added
    to the running total in stage order; a single stage is one chain."""
    study = _study()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 70)).astype(np.float32)
    w = rng.normal(size=(5, 70)).astype(np.float32)
    f32 = np.float32
    want = np.zeros((3, 5), f32)
    for lo in range(0, 70, 32):
        part = np.zeros((3, 5), f32)
        for k in range(lo, min(lo + 32, 70)):
            part = (x[:, k, None].astype(np.float64) * w[None, :, k]
                    + part).astype(f32)
        want = (want + part).astype(f32)
    assert np.array_equal(study.fma_sum(x, w, 32), want)
    assert np.array_equal(study.fma_sum(x[:, :32], w[:, :32], 32),
                          study.fma_sum(x[:, :32], w[:, :32]))


def test_replay_whitens_with_the_ports_operands(golden):
    """The replay's whitening operands are the fp32 pack the port's
    kernels read: rotation mean, rotation and standardizer mean, and the
    reciprocal standard deviation in fp32 (the CPU's vectorised square
    root and division may each land one ulp from numpy's)."""
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_pack

    _, stats, _, _ = golden
    pack = nap_pack(stats, torch.float32)
    var = stats.standardizer.var.numpy()
    assert np.array_equal(pack.mu.numpy(), stats.rotater.mu.numpy())
    assert np.array_equal(pack.v.numpy(), stats.rotater.v.numpy())
    assert np.array_equal(pack.std_mu.numpy(), stats.standardizer.mu.numpy())
    np.testing.assert_array_max_ulp(pack.inv_std.numpy(),
                                    (1.0 / np.sqrt(var)).astype(np.float32),
                                    maxulp=2)


def test_port_cpu_route_scores_the_replayed_diffs(golden):
    """The port's `nap_score` on the CPU (one product over K) on the
    replayed two-level diffs: inside the golden contract, and within 1e-3
    of the two-level replay (3.6e-4 apart: the two orders of sums)."""
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_pack,
        nap_score,
    )

    study, stats, d, col = golden
    got = nap_score(nap_pack(stats, torch.float32),
                    torch.from_numpy(d)).numpy()
    assert _rel(got, col) < GOLDEN_RTOL
    assert _rel(got, study.nap(stats, d, "two_level")) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [0, 1, 4])
def test_kernel_sums_in_the_replayed_order(golden, variant):
    """On the card, each fp32 NAP variant on the replayed diffs gives the
    two-level replay's scores up to the last sum's rounding (the replay
    adds the squares in float64), and not the one chain's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the NAP kernel is CUDA code with "
                    "no CPU path")
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_pack,
        nap_score,
    )

    study, stats, d, _ = golden
    got = nap_score(nap_pack(stats.to("cuda"), torch.float32),
                    torch.from_numpy(d).cuda(), variant).cpu().numpy()
    assert _rel(got, study.nap(stats, d, "two_level")) < 1e-5
    assert _rel(got, study.nap(stats, d, "chain")) > 1e-4
