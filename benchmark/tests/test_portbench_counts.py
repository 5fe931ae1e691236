"""Operations, bytes and parameter counts against hand counts."""

import pytest

from benchmark.harness import cli, counts
from benchmark.harness import manifest as mf
from benchmark.harness.trace import Trace
from benchmark.tests.test_portbench_faults import SEED, SIZES

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


def _fc_tick_share(window, ticks=3, fc_s=1e-3):
    """`fc_roofline.tick` of `ticks` ticks whose `fc_` kernels ran `fc_s`."""
    trace = Trace(device_ops=[("fc_module_kernel", 0.0, fc_s)],
                  window_s=fc_s, busy_s=fc_s)
    ctx = cli.Readings(ALL, {}, trace, {"ticks": ticks}, window)
    return mf.reader("fc_roofline.tick")(ctx)


def test_a_base_tick_counts_two_passes_and_a_nap_tick_is_unchanged():
    """BASE: the encoder and the decoder, no NAP product.  NAP: three module
    passes and 2bKJ, the numbers the NAP cell read before BASE had a
    cell, to the last digit."""
    enc = counts.module_cost(ALL, "encoder", 10)[2]
    dec = counts.module_cost(ALL, "decoder", 10)[2]
    assert counts.base_model_flops(ALL, 10) == 2 * 10 * 10_201_918
    assert _fc_tick_share({"batch": 10, "nap": False}) == pytest.approx(
        100.0 * 3 * (enc + dec) / 1e-3, rel=1e-12)
    assert counts.score_model_flops(ALL, 10, 5482) == 907_104_020.0
    nap_least = 1.8667098507462688e-05
    assert counts.rapp_fc_cost(ALL, 10)[2] == nap_least
    nap = {"batch": 10, "nap": True, "k": 5482, "j": 5482}
    assert _fc_tick_share(nap) == 100.0 * 3 * nap_least / 1e-3


@pytest.fixture(scope="module")
def tick_readings():
    """The readings of a short window of each tick cell at tiny sizes."""
    manifest = mf.Manifest(mf.BENCH.rsplit("/", 1)[0])
    out = {}
    for cell in ("all_1728.tick_base", "all_1728.tick_nap"):
        c = manifest.cell(cell)
        config = {**manifest.config(c), **SIZES[cell]["config"]}
        traffic = {**mf.traffic(c["traffic"]), **SIZES[cell]["traffic"]}
        entry = mf.entry(traffic["entry"])(config, traffic, SEED, "cpu")
        entry.window(0.05)
        out[cell] = (config, entry.readings())
    return out


def test_a_tick_entry_counts_the_model_flops_of_its_score(tick_readings):
    config, base = tick_readings["all_1728.tick_base"]
    assert base["nap"] is False and "k" not in base and "j" not in base
    assert base["model_flops"] / base["ticks"] == 2.0 * 10 * (
        counts.weight_count(config))
    _, nap = tick_readings["all_1728.tick_nap"]
    # the NAP cell's readings before BASE had a cell, for this seed
    assert (nap["nap"], nap["k"], nap["j"]) == (True, 2616, 96)
    assert nap["model_flops"] / nap["ticks"] == 96_268_800.0


def test_a_base_set_up_fits_no_whitening(tick_readings):
    base = tick_readings["all_1728.tick_base"][1]["setup_spans_s"]
    nap = tick_readings["all_1728.tick_nap"][1]["setup_spans_s"]
    assert sorted(base) == ["inputs", "warm_up"]
    assert sorted(nap) == ["fit_windows", "inputs", "nap_fit", "warm_up"]
