"""Operations, bytes and parameter counts against hand counts."""

import pytest

from benchmark.harness import counts

ALL = {"input_size": 1728, "n_layers": 5, "btl_size": 100}
HAND = {"input_size": 1024, "n_layers": 5, "btl_size": 100}


def test_widths_parameters_and_diff_width():
    enc = [(1728, 1402), (1402, 1076), (1076, 751), (751, 425), (425, 100)]
    weights = sum(k * n for k, n in enc)
    assert weights == 5_100_959
    assert counts.weight_count(ALL) == 2 * weights
    biases = sum(n for _, n in enc) + sum(k for k, _ in enc)
    bn = 2 * sum(n for _, n in enc[:-1]) + 2 * sum(k for k, _ in enc[1:])
    assert counts.parameter_count(ALL) == 2 * weights + biases + bn
    assert counts.parameter_count(ALL) == 10_225_670
    assert counts.diff_width(ALL) == 5482
    assert counts.diff_width(HAND) == 3370
    assert counts.parameter_count(HAND) == 3_766_928


def test_fc_layer_and_nap_costs():
    ops, nbytes = counts.fc_layer_cost(10, 1728, 1402, True, True)
    assert ops == 2 * 10 * 1728 * 1402 + 6 * 10 * 1402
    assert nbytes == 4 * (10 * 1728 + 1728 * 1402 + 5 * 1402 + 10 * 1402)
    ops, nbytes = counts.fc_layer_cost(7000, 425, 100, False, False)
    assert ops == 2 * 7000 * 425 * 100 + 7000 * 100
    assert nbytes == 4 * (7000 * 425 + 425 * 100 + 100 + 7000 * 100)
    ops, nbytes, least = counts.nap_cost(10, 5482, 5482)
    assert nbytes == 4 * (10 * 5482 + 5482 * 5482 + 5482 + 2 * 5482 + 10)
    # 120 MB of V at 3.35 TB/s: bound by its bytes, ~36 us
    assert least == pytest.approx(nbytes / 3.35e12)
    assert 35e-6 < least < 37e-6


def test_model_flops():
    per_window = counts.score_model_flops(ALL, 1, 5482)
    assert per_window == pytest.approx(30.6e6 + 60.1e6, rel=2e-3)
    assert counts.score_model_flops(HAND, 1, 3370) == pytest.approx(
        11.26e6 + 22.71e6, rel=2e-3)
    job = counts.train_model_flops(ALL, 29400, 9800, 20)
    assert job == 20 * (6 * 10_225_670 * 29400 + 2 * 10_201_918 * 9800)


def test_rapp_pass_is_three_module_passes():
    enc = counts.module_cost(ALL, "encoder", 7000)
    dec = counts.module_cost(ALL, "decoder", 7000)
    got = counts.rapp_fc_cost(ALL, 7000)
    for i in range(3):
        assert got[i] == pytest.approx(2 * enc[i] + dec[i])
    # at B = 7000 every layer is bound by its operations
    assert enc[2] == pytest.approx(enc[0] / 67e12)
