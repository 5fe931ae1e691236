"""The plain reference against the port at tiny sizes on the CPU: each
stage the cells compare, as float64 against the port's fp32."""

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.harness.entries.tick import mic_chunks_held
from benchmark.harness.port import port_config, port_fusion, port_model
from benchmark.reference import ae as ref_ae
from benchmark.reference import frontend, nap, prng

CFG = {"sensor": "hand_camera", "input_size": 48, "n_layers": 3,
       "btl_size": 8, "batch_size": 64, "n_epochs": 2, "lr": 1e-3,
       "slicing_size": 56000, "nap_fit_method": "svd", "dtype": "float32"}
PARAMS = {"latent_rank": 8, "signal_scale": 1.0, "bias_scale": 0.1,
          "noise_scale": 0.1, "anomaly_shift": 3.0}


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


def test_epoch_order_is_the_trainers():
    from icra2021_multimodal_ad_tpu_torch.train import epoch_permutation

    for seed, epoch, n in ((0, 0, 10), (2 ** 31 + 7, 3, 29400), (5, 19, 70)):
        assert np.array_equal(prng.epoch_order(seed, epoch, n),
                              epoch_permutation(seed, epoch, n).numpy())


def test_diffs_and_losses_match_the_port():
    from icra2021_multimodal_ad_tpu_torch.ops.rapp import diffs_batch

    weights = inputs.ae_weights(CFG, 3, "cpu", trained=True)
    model = port_model(CFG, weights, "cpu")
    x, _ = inputs.fused_windows(30, 48, 3, "test", "cpu", 0.3,
                                 params=PARAMS)
    ref = ref_ae.Ae(weights, torch.float64, "cpu").diffs(x.double())
    got = diffs_batch(model, x)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert _rel(g, r) < 1e-5


def test_nap_matches_the_port_where_the_fit_is_well_posed():
    from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
        nap_pack,
        nap_score,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import nap_fit

    g = torch.Generator().manual_seed(4)
    mix = torch.randn(20, 20, generator=g, dtype=torch.float64)
    fit = torch.randn(500, 20, generator=g, dtype=torch.float64) @ mix
    test = torch.randn(40, 20, generator=g, dtype=torch.float64) @ mix
    ref = nap.score(nap.fit(fit), test)
    got = nap_score(nap_pack(nap_fit(fit.float())), test.float())
    assert _rel(got, ref) < 1e-4


def _tick(steps, b, held, cursor):
    idx = [cursor - b + i for i in range(b)]
    return {"force": [float(steps.force[i]) for i in idx],
            "hand": [steps.hand[i] for i in idx],
            "depth": [steps.depth[i] for i in idx],
            "chunks": [steps.chunk(c) for c in range(
                cursor * steps.CHUNKS - held, cursor * steps.CHUNKS)]}


def test_mfcc_and_fusion_match_the_port():
    from icra2021_multimodal_ad_tpu_torch.data.streaming import (
        hsr_window_batch,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.mfcc import (
        mfcc_from_int16_chunks_device,
    )

    b = 4
    held = mic_chunks_held(b, inputs.SensorSteps.CHUNK_SAMPLES)
    steps = inputs.SensorSteps(3 * b, 9, "fit", {"share": 0.3,
                                                 "segment_steps": b})
    fusion = inputs.fusion_weights(9, "cpu")
    cfg = port_config({**CFG, "sensor": "All", "input_size": 1728},
                      batch_size=b)
    ticks = [_tick(steps, b, held, (j + 1) * b) for j in range(3)]
    got = torch.cat([hsr_window_batch(
        cfg, port_fusion(fusion), t["force"], t["hand"], t["depth"],
        mfcc_from_int16_chunks_device([c.tobytes() for c in t["chunks"]],
                                      cfg, length=b / 10.0, device="cpu"))
        for t in ticks])
    ref = frontend.tick_windows(fusion, ticks, b, torch.float64, "cpu")
    assert got.shape == ref.shape == (3 * b, 1728)
    assert _rel(got, ref) < 1e-5
    wave = frontend.floored_wave(ticks[0]["chunks"])
    mf = mfcc_from_int16_chunks_device([c.tobytes() for c in
                                        ticks[0]["chunks"]], cfg,
                                       length=b / 10.0, device="cpu")
    ref_mf = frontend.mfcc_last(torch.from_numpy(wave[None]), b)[0]
    assert _rel(mf, ref_mf) < 1e-4
