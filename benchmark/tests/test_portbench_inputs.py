"""The run's inputs repeat by seed, and another seed draws others."""

import numpy as np
import torch

from benchmark.harness import inputs

CFG = {"input_size": 48, "n_layers": 3, "btl_size": 8}
PARAMS = {"latent_rank": 8, "signal_scale": 1.0, "bias_scale": 0.1,
          "noise_scale": 0.1, "anomaly_shift": 3.0}
BIG = 2 ** 31 + 12345


def test_weights_repeat_by_seed():
    a = inputs.ae_weights(CFG, BIG, "cpu", trained=True)
    b = inputs.ae_weights(CFG, BIG, "cpu", trained=True)
    c = inputs.ae_weights(CFG, BIG + 1, "cpu", trained=True)
    # 48 -> 34 -> 21 -> 8 and back: the reference's truncated interpolation
    assert [tuple(l["w"].shape) for l in a] == [
        (34, 48), (21, 34), (8, 21), (21, 8), (34, 21), (48, 34)]
    for x, y in zip(a, b):
        assert torch.equal(x["w"], y["w"]) and torch.equal(x["b"], y["b"])
    assert not torch.equal(a[0]["w"], c[0]["w"])
    assert a[-1]["bn"] is None and not a[-1]["leaky"]
    bound = 1 / 48 ** 0.5
    assert float(a[0]["w"].abs().max()) <= bound
    init = inputs.ae_weights(CFG, BIG, "cpu", trained=False)
    assert torch.equal(init[0]["bn"]["var"], torch.ones(34))


def test_fusion_and_windows_repeat_by_seed():
    f1, f2 = (inputs.fusion_weights(BIG, "cpu") for _ in range(2))
    assert all(torch.equal(f1[k]["w"], f2[k]["w"]) for k in f1)
    assert f1["rgb2"]["w"].shape == (16, 16, 3, 3)
    x1, l1 = inputs.fused_windows(100, 48, BIG, "test", "cpu", 0.3,
                                 params=PARAMS)
    x2, l2 = inputs.fused_windows(100, 48, BIG, "test", "cpu", 0.3,
                                 params=PARAMS)
    x3, _ = inputs.fused_windows(100, 48, BIG + 1, "test", "cpu", 0.3,
                                 params=PARAMS)
    assert torch.equal(x1, x2) and torch.equal(l1, l2)
    assert not torch.equal(x1, x3)
    assert float(x1.min()) >= 0 and 0 < int(l1.sum()) < 100


def test_sensor_steps_repeat_by_seed():
    anomaly = {"share": 0.2, "segment_steps": 5}
    a = inputs.SensorSteps(50, BIG, "ticks", anomaly)
    b = inputs.SensorSteps(50, BIG, "ticks", anomaly)
    c = inputs.SensorSteps(50, BIG + 1, "ticks", anomaly)
    for k in ("force", "hand", "depth", "mic", "drop"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert not np.array_equal(a.mic, c.mic)
    assert a.hand.dtype == np.uint8 and a.mic.dtype == np.int16
    assert a.mic.shape == (50, 5, 2048) and 0 < a.drop.sum() < 50
    assert np.all(a.force[a.drop] < 100) and np.all(a.force[~a.drop] > 150)
    assert np.array_equal(a.chunk(5 * 51 + 2), a.mic[1, 2])
