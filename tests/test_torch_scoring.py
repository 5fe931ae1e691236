"""The PyTorch port's NAP fit, whitening and the NAP kernel's plain version
against the JAX package on the CPU.  The JAX Pallas kernel runs in interpret
mode, as tests/test_pallas_kernels.py runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra2021_multimodal_ad_tpu.ops.pallas_kernels import nap_score_pallas
from icra2021_multimodal_ad_tpu.ops.scoring import (
    NapStats as JNapStats,
    concat_diffs as jconcat_diffs,
    load_nap_stats as jload_nap_stats,
    mean_square_rows as jmean_square_rows,
    nap_effective_stats as jnap_effective_stats,
    nap_fit as jnap_fit,
    nap_score_device as jnap_score_device,
    save_nap_stats as jsave_nap_stats,
)
from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
    nap_pack,
    nap_score,
    nap_score_plain,
)
from icra2021_multimodal_ad_tpu_torch.ops.normalize import (
    RotaterStats,
    StandardizerStats,
)
from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
    NapStats,
    concat_diffs,
    load_nap_stats,
    mean_square_rows,
    nap_effective_stats,
    nap_fit,
    nap_score_device,
    nap_score_from_diffs,
    save_nap_stats,
)

NAP_TOL = dict(rtol=1e-3, atol=1e-5)


def _train(n=96, k=70, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k)) * rng.uniform(0.5, 2, k)).astype(
        np.float32)


def _query(k=70, seed=1):
    return np.random.default_rng(seed).normal(size=(33, k)).astype(np.float32)


def _to_port(s: JNapStats) -> NapStats:
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return NapStats(RotaterStats(t(s.rotater.mu), t(s.rotater.v)),
                    StandardizerStats(t(s.standardizer.mu),
                                      t(s.standardizer.var)),
                    None if s.feat_absmax is None else t(s.feat_absmax))


def test_nap_fit_matches_jax_by_scores():
    train, x = _train(), _query()
    ours = nap_fit(torch.from_numpy(train))
    ref = jnap_fit(jnp.asarray(train))
    assert ours.rotater.v.shape == ref.rotater.v.shape == (70, 70)
    np.testing.assert_allclose(ours.feat_absmax.numpy(),
                               np.asarray(ref.feat_absmax), rtol=1e-6)
    np.testing.assert_allclose(ours.standardizer.var.numpy(),
                               np.asarray(ref.standardizer.var), rtol=1e-3)
    # SVD signs and near-tie order differ between LAPACKs: compare scores
    np.testing.assert_allclose(
        nap_score_device(ours, torch.from_numpy(x)).numpy(),
        np.asarray(jnap_score_device(ref, jnp.asarray(x))), **NAP_TOL)
    with pytest.raises(NotImplementedError, match="gram"):
        nap_fit(torch.from_numpy(train), method="gram")


@pytest.mark.parametrize("floor", [None, 0.3])
def test_plain_nap_score_matches_jax_device_and_pallas(floor):
    jfit = jnap_fit(jnp.asarray(_train(seed=2)))
    jstats = jnap_effective_stats(jfit, floor) if floor else jfit
    stats = nap_effective_stats(_to_port(jfit), floor) if floor else (
        _to_port(jfit))
    if floor:
        assert np.isinf(np.asarray(jstats.standardizer.var)).sum() >= 5
        np.testing.assert_array_equal(stats.standardizer.var.numpy(),
                                      np.asarray(jstats.standardizer.var))
    x = _query(seed=3)
    ours = nap_score(nap_pack(stats), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jnap_score_device(jstats, jnp.asarray(x))),
        **NAP_TOL)
    np.testing.assert_allclose(
        ours, np.asarray(nap_score_pallas(jstats, jnp.asarray(x),
                                          tb=16, tj=128)), **NAP_TOL)
    np.testing.assert_allclose(
        ours, nap_score_device(stats, torch.from_numpy(x)).numpy(),
        **NAP_TOL)


def _round_bf16(a: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 -> fp32 with round to nearest even, in numpy."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    bits = (bits + (0x7FFF + ((bits >> 16) & 1))) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_bf16_pack_rounds_operands_and_accumulates_in_fp32(x_dtype):
    """A bf16 pack rounds x to bf16, centres it in fp32 and multiplies both
    bf16 halves of the result (xc to 16 bits) by the bf16 rotation with fp32
    accumulation: the arithmetic of bf16(x) - mu without folding mu @ V."""
    stats = _to_port(jnap_fit(jnp.asarray(_train(seed=4))))
    x = torch.from_numpy(_query(seed=5)).to(x_dtype)
    pack = nap_pack(stats, torch.bfloat16)
    # V^T, K-major, rows padded from 70 to 72 bf16 (16 bytes) with zeros
    assert pack.vt.dtype == torch.bfloat16 and pack.vt.shape == (70, 70)
    assert pack.vt.stride() == (72, 1) and pack.v.shape == (70, 70)
    assert torch.equal(pack.v, stats.rotater.v.to(torch.bfloat16))
    assert pack.inv_std.dtype == torch.float32
    xc = (_round_bf16(x.float().numpy()) - pack.mu.numpy()).astype(np.float32)
    hi = _round_bf16(xc)
    lo = _round_bf16((xc - hi).astype(np.float32))
    rot = (hi.astype(np.float64) + lo) @ pack.v.double().numpy()
    t = (rot - pack.std_mu.double().numpy()) * pack.inv_std.double().numpy()
    np.testing.assert_allclose(nap_score_plain(pack, x).numpy(),
                               (t * t).mean(-1), rtol=1e-5)
    with pytest.raises(ValueError, match="dtype"):
        nap_pack(stats, torch.float16)
    with pytest.raises(ValueError, match=r"\(B, 70\)"):
        nap_score(pack, x[:, :69])


def test_round_bf16_reference_is_torch_rounding():
    a = np.random.default_rng(9).normal(size=4096).astype(np.float32)
    a[:4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0]  # ties
    np.testing.assert_array_equal(
        _round_bf16(a),
        torch.from_numpy(a).to(torch.bfloat16).float().numpy())


def test_nap_stats_npz_round_trip_both_ways(tmp_path):
    jstats = jnap_fit(jnp.asarray(_train()))
    jsave_nap_stats(str(tmp_path / "j.npz"), jstats)
    ours = load_nap_stats(str(tmp_path / "j"))
    save_nap_stats(str(tmp_path / "p.npz"), ours)
    back = jload_nap_stats(str(tmp_path / "p.npz"))
    for a, b in zip((jstats.rotater.mu, jstats.rotater.v,
                     jstats.standardizer.mu, jstats.standardizer.var,
                     jstats.feat_absmax),
                    (back.rotater.mu, back.rotater.v, back.standardizer.mu,
                     back.standardizer.var, back.feat_absmax)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("start,end", [(0, None), (1, 3), (5, None), (2, 1)])
def test_concat_slice_range_and_sap_rows_match_jax(start, end):
    rng = np.random.default_rng(6)
    diffs = [rng.normal(size=(5, d)).astype(np.float32) for d in (7, 4, 3)]
    ours = concat_diffs([torch.from_numpy(d) for d in diffs], start, end)
    ref = jconcat_diffs([jnp.asarray(d) for d in diffs], start, end)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_allclose(mean_square_rows(ours).numpy(),
                               np.asarray(jmean_square_rows(ref)), rtol=1e-6)


def test_effective_stats_is_idempotent_and_scores_from_diffs():
    stats = _to_port(jnap_fit(jnp.asarray(_train(seed=7))))
    once = nap_effective_stats(stats, 0.3)
    twice = nap_effective_stats(once, 0.3)
    assert torch.equal(once.standardizer.var, twice.standardizer.var)
    x = torch.from_numpy(_query(seed=8))
    parts = [x[:, :30], x[:, 30:]]
    np.testing.assert_allclose(nap_score_from_diffs(stats, parts).numpy(),
                               nap_score_device(stats, x).numpy(), rtol=1e-6)
