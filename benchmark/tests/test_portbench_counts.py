"""Operations, bytes and parameter counts against hand counts."""

import pytest
import torch

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


def _old_fc_layer_cost(b, k, n, leaky, bn):
    """`fc_layer_cost` as it stood before the counts took a type."""
    n_vec = 1 + (4 if bn else 0)
    epi = 1 + int(leaky) + (4 if bn else 0)
    return (2.0 * b * k * n + epi * b * n,
            4.0 * (b * k + k * n + n_vec * n + b * n))


def _old_nap_cost(b, k, j):
    ops = 2.0 * b * k * j + b * k + 4.0 * b * j
    nbytes = 4.0 * (b * k + k * j + k + 2 * j + b)
    return ops, nbytes, max(ops / 67e12, nbytes / 3.35e12)


def _old_module_cost(config, module, b):
    ops = nbytes = least = 0.0
    for k, n, act in counts.module_layers(config, module):
        o, m = _old_fc_layer_cost(b, k, n, act, act)
        ops, nbytes = ops + o, nbytes + m
        least += max(o / 67e12, m / 3.35e12)
    return ops, nbytes, least


@pytest.mark.parametrize("config", [ALL, HAND])
@pytest.mark.parametrize("b", [1, 10, 32, 2800, 7000])
def test_every_fp32_cost_is_the_old_formulas_to_the_bit(config, b):
    """The counts the fp32 cells read, with and without the type named."""
    for k, n, act in counts.module_layers(config, "encoder"):
        for dtype in ((), ("float32",)):
            assert counts.fc_layer_cost(b, k, n, act, act, *dtype) == (
                _old_fc_layer_cost(b, k, n, act, act))
    for module in ("encoder", "decoder"):
        assert counts.module_cost(config, module, b) == _old_module_cost(
            config, module, b)
    enc = _old_module_cost(config, "encoder", b)
    dec = _old_module_cost(config, "decoder", b)
    # summed as the old code summed (`sum`, compensated since Python 3.12)
    assert counts.rapp_fc_cost(config, b, "float32") == tuple(
        sum(p[i] for p in (enc, dec, enc)) for i in range(3))
    assert counts.forward_fc_cost(config, b) == tuple(
        sum(p[i] for p in (enc, dec)) for i in range(3))
    k = counts.diff_width(config)
    for j in (96, 400, k):
        assert counts.nap_cost(b, k, j) == _old_nap_cost(b, k, j)
        assert counts.nap_cost(b, k, j, "float32") == _old_nap_cost(b, k, j)


def test_a_bf16_layer_and_score_are_charged_in_their_types():
    """bf16 weights, V^T and FC inputs at 2 bytes; the fp32 vectors, the
    NAP kernel's fp32 diffs and every fp32 output at 4; a bf16 layer's
    bf16 copy of its output at 2 more; operations at 989 TFLOP/s."""
    ops, nbytes = counts.fc_layer_cost(10, 1728, 1402, True, True,
                                       "bfloat16")
    assert ops == 2 * 10 * 1728 * 1402 + 6 * 10 * 1402
    assert nbytes == (2 * (10 * 1728 + 1728 * 1402) + 4 * 5 * 1402
                      + (4 + 2) * 10 * 1402)
    _, nbytes = counts.fc_layer_cost(10, 425, 100, False, False, "bfloat16")
    assert nbytes == 2 * (10 * 425 + 425 * 100) + 4 * 100 + 6 * 10 * 100
    ops, nbytes, least = counts.nap_cost(10, 5482, 5482, "bfloat16")
    assert nbytes == (4 * 10 * 5482 + 2 * 5482 * 5482 + 4 * 5482
                      + 4 * 2 * 5482 + 4 * 10)
    assert least == nbytes / 3.35e12
    # at B = 7000 both are bound by their operations, at the bf16 peak
    ops, nbytes, least = counts.nap_cost(7000, 5482, 5482, "bfloat16")
    assert least == ops / 989e12 > nbytes / 3.35e12
    ops, nbytes = counts.fc_layer_cost(7000, 1728, 1402, True, True,
                                       "bfloat16")
    assert counts.bound_s(ops, nbytes, "bfloat16") == ops / 989e12


def test_the_bf16_tick_bounds_at_all_1728():
    """A tick of 10 rows: the FC kernel's three module passes read 15.3 M
    bf16 weights (30.6 MB, 9.1 us at 3.35 TB/s; with the rows, vectors
    and outputs 9.5 us), the NAP kernel V at K = J = 5482 (60.1 MB, 17.9
    us; 18.0 with the rest): half the fp32 bounds, to within the fp32
    vectors and outputs."""
    weights = 2 * counts.weight_count(ALL) - sum(
        k * n for k, n, _ in counts.module_layers(ALL, "decoder"))
    assert weights == pytest.approx(15.3e6, rel=1e-3)
    fc = counts.rapp_fc_cost(ALL, 10, "bfloat16")[2]
    assert fc == pytest.approx(2 * weights / 3.35e12, rel=0.05)
    assert 9.1e-6 < fc < 9.6e-6
    nap = counts.nap_cost(10, 5482, 5482, "bfloat16")[2]
    assert 17.9e-6 < nap < 18.1e-6
    assert fc / counts.rapp_fc_cost(ALL, 10)[2] == pytest.approx(0.51,
                                                                 abs=0.01)
    assert nap / counts.nap_cost(10, 5482, 5482)[2] == pytest.approx(
        0.5, abs=0.01)


def _tick_ctx(traffic, seconds=1e-3):
    """A traced window of 3 NAP ticks at all_1728 whose `fc_` and `nap_`
    kernels each ran `seconds`, in a cell of `traffic`."""
    trace = Trace(device_ops=[("fc_wgmma_kernel", 0.0, seconds),
                              ("nap_wgmma_kernel", seconds, seconds)],
                  window_s=2 * seconds, busy_s=2 * seconds)
    window = {"batch": 10, "nap": True, "k": 5482, "j": 5482,
              "window_s": 2.0, "model_flops": 989e10}
    return cli.Readings(ALL, traffic, trace, {"ticks": 3}, window)


def test_the_tick_readers_take_the_cells_compute_type():
    bf16 = _tick_ctx({"compute_dtype": "bfloat16"})
    fp32 = _tick_ctx({})
    fc = mf.reader("fc_roofline.tick")
    nap = mf.reader("nap_roofline.tick")
    mfu = mf.reader("mfu.tick")
    assert fc(bf16) == 100.0 * (3 * counts.rapp_fc_cost(
        ALL, 10, "bfloat16")[2]) / 1e-3
    assert nap(bf16) == 100.0 * (3 * counts.nap_cost(
        10, 5482, 5482, "bfloat16")[2]) / 1e-3
    assert fc(fp32) == 100.0 * (3 * counts.rapp_fc_cost(ALL, 10)[2]) / 1e-3
    assert nap(fp32) == 100.0 * (3 * counts.nap_cost(
        10, 5482, 5482)[2]) / 1e-3
    assert mfu(bf16) == pytest.approx(0.5)
    assert mfu(fp32) == pytest.approx(0.5 * 989 / 67)


@pytest.fixture(scope="module")
def tick_readings():
    """The readings of a short window of each tick cell at tiny sizes."""
    manifest = mf.Manifest(mf.BENCH.rsplit("/", 1)[0])
    out = {}
    for cell in ("all_1728.tick_base", "all_1728.tick_nap",
                 "all_1728.tick_nap_bf16"):
        c = manifest.cell(cell)
        config = {**manifest.config(c), **SIZES[cell]["config"]}
        traffic = {**mf.traffic(c["traffic"]), **SIZES[cell]["traffic"]}
        entry = mf.entry(traffic["entry"])(config, traffic, SEED, "cpu")
        entry.window(0.05)
        entry.release()
        out[cell] = (config, entry.readings(), entry.prog_stats)
    return out


def test_a_tick_entry_counts_the_model_flops_of_its_score(tick_readings):
    config, base, _ = tick_readings["all_1728.tick_base"]
    assert base["nap"] is False and "k" not in base and "j" not in base
    assert base["model_flops"] / base["ticks"] == 2.0 * 10 * (
        counts.weight_count(config))
    _, nap, _ = tick_readings["all_1728.tick_nap"]
    # the NAP cell's readings before BASE had a cell, for this seed
    assert (nap["nap"], nap["k"], nap["j"]) == (True, 2616, 96)
    assert nap["model_flops"] / nap["ticks"] == 96_268_800.0


def test_a_base_set_up_fits_no_whitening(tick_readings):
    base = tick_readings["all_1728.tick_base"][1]["setup_spans_s"]
    nap = tick_readings["all_1728.tick_nap"][1]["setup_spans_s"]
    assert sorted(base) == ["inputs", "warm_up"]
    assert sorted(nap) == ["fit_windows", "inputs", "nap_fit", "warm_up"]


def test_the_bf16_tick_fits_the_fp32_whitening_of_the_nap_tick(
        tick_readings):
    """Only the serving bundle takes the traffic's type: the same seed
    fits the same whitening, to the bit, and counts the same FLOPs."""
    _, fp32, fp32_stats = tick_readings["all_1728.tick_nap"]
    _, bf16, bf16_stats = tick_readings["all_1728.tick_nap_bf16"]
    assert (bf16["k"], bf16["j"]) == (fp32["k"], fp32["j"])
    assert (bf16["model_flops"] / bf16["ticks"]
            == fp32["model_flops"] / fp32["ticks"])
    for key, value in fp32_stats.items():
        assert bf16_stats[key].dtype == torch.float32
        assert torch.equal(bf16_stats[key], value), key
