"""The captured tick on the CPU: `utils/graphs.Program` (launch-count
bookkeeping, slots) and the streaming programs built on it, held against
the port's eager tick and the JAX package's one-program ticks.

On the CPU a program calls its function eagerly on its staging; the CUDA
graphs themselves run only on the card (chip_smoke.py phase 8 holds them
bit for bit against the eager tick there)."""

import numpy as np
import pytest
import torch

from icra2021_multimodal_ad_tpu.data import streaming as jstreaming
from icra2021_multimodal_ad_tpu.ops import mfcc as jmfcc
from icra2021_multimodal_ad_tpu_torch.data import streaming
from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
    fused_mlp_layer,
    fused_mlp_module,
)
from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import nap_score
from icra2021_multimodal_ad_tpu_torch.ops.normalize import (
    RotaterStats,
    StandardizerStats,
)
from icra2021_multimodal_ad_tpu_torch.ops.scoring import NapStats
from icra2021_multimodal_ad_tpu_torch.ops.serving import int8_product
from icra2021_multimodal_ad_tpu_torch.utils import graphs
from test_torch_streaming import (  # noqa: F401  (twins: a fixture)
    _detectors,
    _jcfg,
    _run,
    _snapshot,
    twins,
)


def test_a_replay_adds_what_its_capture_counted():
    def kernel():
        pass

    graphs.counted(kernel, "launches", "layers_run")
    try:
        kernel.launches = 2  # launches before the capture

        def capture():
            kernel.launches += 1
            kernel.layers_run += 1
            return "graph"

        out, delta = graphs.recorded(capture)
        assert out == "graph"
        # a capture launches nothing
        assert (kernel.launches, kernel.layers_run) == (2, 0)
        mine = [graphs.COUNTERS.index((kernel, a))
                for a in ("launches", "layers_run")]
        assert [delta[i] for i in mine] == [1, 1]
        assert sum(delta) == 2
        for n in range(1, 4):
            graphs.add_counts(delta)
            assert (kernel.launches, kernel.layers_run) == (2 + n, n)
    finally:
        for attr in ("launches", "layers_run"):
            graphs.COUNTERS.remove((kernel, attr))
    # every kernel wrapper's counts are replayed
    assert {(fused_mlp_layer, "launches"), (fused_mlp_module, "launches"),
            (fused_mlp_module, "layers_run"), (nap_score, "launches"),
            (nap_score, "small_launches"), (nap_score, "balanced_launches"),
            (int8_product, "launches")} <= set(graphs.COUNTERS)


def test_program_slots_keep_their_own_staging_and_output():
    prog = graphs.Program(lambda w, y: w.float() * 2 + y,
                          [((3,), torch.int16), ((3,), torch.float32)],
                          torch.device("cpu"), slots=2)
    w0, y0 = prog.staging(0)
    w0[:], y0[:] = [1, 2, 3], 0.5
    prog.launch(0)
    w1, y1 = prog.staging(1)
    w1[:], y1[:] = [4, 5, 6], 0.0
    prog.launch(1)
    assert prog.output(0).tolist() == [2.5, 4.5, 6.5]
    assert prog.output(1).tolist() == [8.0, 10.0, 12.0]
    assert w0.dtype == np.int16 and prog.launch_counts is None


def _jax_run(twins, dtype, seed, n_ticks, nap):
    jm, params, state, jstats = twins["jax"]
    jdet = jstreaming.StreamingDetector(_jcfg(compute_dtype=dtype), jm,
                                        params, state, twins["jfp"],
                                        nap_stats=jstats)
    src = jstreaming.SimulatedSensors(batch_size=10, seed=seed)
    src.fill(12)
    return jdet.run(src, n_ticks=n_ticks, nap=nap,
                    tick_hook=lambda i: src.tick())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nap", [False, True])
def test_two_slot_pipelined_run_matches_sequential_and_jax(twins, dtype,
                                                           nap):
    _, det = _detectors(twins, dtype)
    seq, _ = _run(det, 6, 4, nap=nap)
    pipe, seen = _run(det, 6, 4, nap=nap, pipelined=True)
    np.testing.assert_array_equal(pipe, seq)
    assert seen == list(range(4))
    # one MFCC program and one tick program, both slots of each replayed
    (mfcc,) = det._mfcc_programs.values()
    (prog,) = det._bundle_and_programs()[1].values()
    assert prog.slots == mfcc.slots == streaming.SLOTS == 2
    np.testing.assert_array_equal(prog.output(1).numpy(), pipe[-1])
    np.testing.assert_array_equal(prog.output(0).numpy(), pipe[-2])
    want = _jax_run(twins, dtype, 6, 4, nap)
    if dtype == "float32":  # test_score_queues_fp32_matches_jax's
        np.testing.assert_allclose(pipe, want, rtol=2e-4, atol=1e-6)
    else:  # test_score_queues_bf16_tracks_jax_bf16's
        rel = np.mean(np.abs(pipe - want) / (np.abs(want) + 1e-6))
        assert np.isfinite(pipe).all() and rel < 1e-2, rel


def test_a_swap_of_nap_stats_recaptures(twins):
    _, det = _detectors(twins, "float32")
    src = streaming.SimulatedSensors(batch_size=10, seed=4)
    src.fill(12)
    snap = _snapshot(src)
    first = det.score_rings(*snap, nap=True)
    bundle, programs = det._bundle_and_programs()
    (prog,) = programs.values()
    assert det._bundle_and_programs()[0] is bundle  # no swap, no rebuild
    s = twins["stats"]
    det.nap_stats = NapStats(RotaterStats(s.rotater.mu, s.rotater.v),
                             StandardizerStats(s.standardizer.mu,
                                               s.standardizer.var * 4))
    second = det.score_rings(*snap, nap=True)
    bundle2, programs2 = det._bundle_and_programs()
    (prog2,) = programs2.values()
    assert bundle2 is not bundle and prog2 is not prog
    # 4x the variances: a quarter of each score
    np.testing.assert_allclose(second, first / 4, rtol=1e-6)
    np.testing.assert_array_equal(
        second, det.score_rings_eager(*snap, nap=True))


@pytest.mark.parametrize("chunk", [1000, 2048, 4410])
def test_mfcc_program_key_is_one_per_steady_chunk_size(twins, chunk):
    """A publisher of `chunk`-sample mic chunks, after the ring has reached
    its budget: every tick's floored wave has one length, so one MFCC
    program serves them all, as JAX compiles one program for them."""
    _, det = _detectors(twins, "float32")
    rng = np.random.default_rng(chunk)
    src = streaming.SensorSource(batch_size=10)
    budget = src._MIC_WINDOW_SAMPLES * 12

    def publish():
        src.force_q.append(210.0)
        src.hand_q.append(rng.integers(0, 255, (32, 32, 3), np.uint8))
        src.depth_q.append(rng.integers(0, 255, (32, 32), np.uint8))
        for _ in range(-(-4410 // chunk)):
            src.mic_q.append(rng.integers(-3000, 3000, chunk,
                                          np.int16).tobytes())

    while not src.ready() or src.mic_q.sample_count() < budget:
        publish()
    jmfcc._mfcc_wave_one_program.clear_cache()
    for _ in range(5):
        publish()
        snap = _snapshot(src)
        scores = det.score_rings(*snap)
        np.testing.assert_array_equal(scores, det.score_rings_eager(*snap))
        jmfcc.mfcc_from_int16_chunks_device(snap[3], _jcfg(), 1.0)
    assert len(det._mfcc_programs) == 1
    assert jmfcc._mfcc_wave_one_program._cache_size() == 1
    (n,) = det._mfcc_programs
    assert n % 4410 == 0 and n >= 10 * 4410
