"""On the card: the control, the plain reference one step below the
cell's type put in the program's place (TF32 below fp32; e4m3 operands
below the bf16 tick's), comes out not correct, and the program correct, at
each cell's widths with fewer rows, ticks or epochs than a run takes; in
the BASE tick also the control that lowers the autoencoder alone.  Skips
where there is no card.  On the CPU: a split control lowers only its
part."""

import pytest
import torch

from benchmark.harness import manifest as mf

SEED = 2 ** 31 + 23
SMALLER = {
    "all_1728.tick_nap": ({}, {"check_ticks": 8}),
    "all_1728.tick_base": ({}, {"check_ticks": 8}),
    "all_1728.tick_nap_bf16": ({}, {"check_ticks": 8}),
    "hand_camera_1024.score_offline": ({}, {"test_windows": 2800}),
    "all_1728.score_offline": ({}, {"test_windows": 2800}),
    "all_1728.train": ({"n_epochs": 2}, {"train_windows": 21000,
                                         "valid_windows": 2800}),
}
#: the control of a cell whose type is not fp32
CONTROLS = {"all_1728.tick_nap_bf16": "e4m3"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def _entry(cell, device, config=None, traffic=None, seconds=1.0):
    """The cell's entry after a window of `seconds`, its program state
    released, at SMALLER's sizes or those given."""
    manifest = mf.Manifest(mf.BENCH.rsplit("/", 1)[0])
    entry_cell = manifest.cell(cell)
    small_config, small_traffic = SMALLER[cell]
    config = {**manifest.config(entry_cell),
              **(small_config if config is None else config)}
    traffic = {**mf.traffic(entry_cell["traffic"]),
               **(small_traffic if traffic is None else traffic)}
    entry = mf.entry(traffic["entry"])(config, traffic, SEED, device)
    entry.window(seconds)
    entry.release()
    return entry


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALLER))
def test_the_control_fails_and_the_program_passes(card, cell):
    limits = mf.limits(cell)
    entry = _entry(cell, card)
    assert all(c.ok for c in entry.check(limits))
    control = CONTROLS.get(cell, "tf32")
    assert not all(c.ok for c in entry.control(limits, control))


@pytest.mark.cuda
def test_the_autoencoder_alone_in_tf32_fails_the_base_tick(card):
    """At the cell's own sample of ticks, as a run checks them."""
    cell = "all_1728.tick_base"
    limits = mf.limits(cell)
    entry = _entry(cell, card, {}, {})
    assert all(c.ok for c in entry.check(limits))
    assert not all(c.ok for c in entry.control(limits, "tf32_ae"))


def test_a_split_control_lowers_only_the_autoencoder(monkeypatch):
    """`tf32_ae`: the frontend runs with TF32 off, the autoencoder and its
    score with TF32 on, and the switches are as they were after."""
    from benchmark.harness.entries import tick
    from benchmark.tests.test_portbench_faults import SIZES

    cell = "all_1728.tick_base"
    entry = _entry(cell, "cpu", SIZES[cell]["config"],
                   SIZES[cell]["traffic"], seconds=0.05)
    seen = {}

    def watched(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tick.frontend, "tick_windows",
                        watched("frontend", tick.frontend.tick_windows))
    monkeypatch.setattr(tick.ref_ae, "Ae", watched("ae", tick.ref_ae.Ae))
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    low = entry.reference("tf32_ae")
    assert seen == {"frontend": (False, False), "ae": (True, True)}
    assert low["scores"].dtype == torch.float32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def _rounds_products() -> bool:
    """Whether a product here takes e4m3 operands: 0.01 beside 1.0 rounds
    to 4.5 / 448."""
    got = torch.tensor([[1.0, 0.01]]) @ torch.ones(2, 1)
    return float(got) != pytest.approx(1.01, rel=1e-6)


def test_the_e4m3_control_lowers_only_the_autoencoder_and_the_score(
        monkeypatch):
    """`e4m3` on the bf16 tick: the frontend runs in fp32 with plain
    products, the autoencoder and the NAP score with e4m3 operands, and
    the whitening is the float64 reference's, cast to fp32."""
    from benchmark.harness.entries import tick
    from benchmark.tests.test_portbench_faults import SIZES

    cell = "all_1728.tick_nap_bf16"
    entry = _entry(cell, "cpu", SIZES[cell]["config"],
                   SIZES[cell]["traffic"], seconds=0.05)
    ref = entry.reference()
    seen = {}

    def watched(name, fn):
        def wrapped(*args, **kwargs):
            seen.setdefault(name, set()).add(
                (torch.backends.cuda.matmul.allow_tf32, _rounds_products()))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tick.frontend, "tick_windows",
                        watched("frontend", tick.frontend.tick_windows))
    monkeypatch.setattr(tick.ref_ae, "concat_diffs",
                        watched("ae", tick.ref_ae.concat_diffs))
    monkeypatch.setattr(tick.nap, "score", watched("score", tick.nap.score))
    monkeypatch.setattr(tick.nap, "fit", watched("fit", tick.nap.fit))
    low = entry.reference("e4m3")
    assert seen == {"frontend": {(False, False)}, "ae": {(False, True)},
                    "score": {(False, True)}}
    assert not _rounds_products()
    assert low["scores"].dtype == low["diffs"].dtype == torch.float32
    for key, value in ref["fit"].items():
        assert torch.equal(low["fit"][key], value.float()), key
    assert not torch.equal(low["scores"], ref["scores"].float())
