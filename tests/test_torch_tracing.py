"""The port's program spans (`utils/profiling.span`) on the CPU: with no
profiler running a span is the one shared no-op and `record_function` is
never entered; under `torch.profiler` spans nest, and the streaming tick
(`StreamingDetector.run`, both schedules) and the trainer
(`train_all_epochs`, both modes, and `NoveltyDetecter.train`) record the
spans the benchmark's readers count, as many as they divide by."""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from icra2021_multimodal_ad_tpu_torch.config import Config, get_input_size
from icra2021_multimodal_ad_tpu_torch.data import streaming
from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
from icra2021_multimodal_ad_tpu_torch.ops.fusion import fusion_init
from icra2021_multimodal_ad_tpu_torch.ops.normalize import (
    RotaterStats,
    StandardizerStats,
)
from icra2021_multimodal_ad_tpu_torch.ops.rapp import get_diffs
from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
    NapStats,
    concat_diffs,
)
from icra2021_multimodal_ad_tpu_torch.train import (
    PROGRAMS,
    NoveltyDetecter,
    make_optimizer,
    train_all_epochs,
)
from icra2021_multimodal_ad_tpu_torch.utils.profiling import span

PROGRAM = re.compile(r"(tick|run|train)(\..+)?")
TICK_PARTS = ("tick.snapshot", "tick.mfcc_stage", "tick.launch",
              "tick.stage")
#: 56 train rows at batch 16: three full batches and a tail of 8
TRAIN = dict(input_size=12, btl_size=3, n_layers=2, batch_size=16, lr=1e-2,
             verbose=0, seed=1)


def _rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 12)).astype(
        np.float32)


X, XV = _rows(56, 1), _rows(24, 2)


def _spans(prof):
    """(name, start, end) of every program span the profiler recorded, in
    order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if PROGRAM.fullmatch(e.name)),
                  key=lambda s: (s[1], -s[2]))


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.fixture(autouse=True)
def _fresh_program_cache():
    """Each test starts with no kept epoch programs (`train.PROGRAMS`): a
    worker runs many test files in one process, and a kept entry would
    turn a job that these tests count as a miss into a hit."""
    PROGRAMS.clear()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.fixture(scope="module")
def detector():
    """A small detector on the CPU with well-conditioned whitening stats
    (random rotation, variances in [0.5, 2])."""
    cfg = Config(sensor="All", batch_size=10, n_layers=2, btl_size=6,
                 seed=0, verbose=0)
    cfg = cfg.replace(input_size=get_input_size(cfg))
    model = get_model(cfg, device="cpu").eval()
    k = concat_diffs(get_diffs(torch.zeros(2, cfg.input_size),
                               model)).shape[1]
    j = 24
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    stats = NapStats(
        RotaterStats(t(rng.normal(0, 0.1, k)),
                     t(rng.normal(size=(k, j)) / np.sqrt(k))),
        StandardizerStats(t(rng.normal(0, 0.1, j)),
                          t(rng.uniform(0.5, 2.0, j))))
    return streaming.StreamingDetector(cfg, model, fusion_init(0, "cpu"),
                                       nap_stats=stats, device="cpu")


def _run(det, pipelined, n_ticks=4):
    """`n_ticks` NAP ticks from cold rings; (hook calls, the trace)."""
    src = streaming.SimulatedSensors(batch_size=10, seed=9)
    hooks = []

    def hook(i):
        hooks.append(i)
        src.tick()

    trace = det.run(src, n_ticks=n_ticks, nap=True, tick_hook=hook,
                    connection_timeout_s=2.0, pipelined=pipelined)
    return hooks, trace


def _job(fused, n_epochs=3):
    cfg = Config(**TRAIN, n_epochs=n_epochs)
    model = get_model(cfg, device="cpu")
    return train_all_epochs(model, make_optimizer(model, cfg.lr),
                            torch.from_numpy(X), torch.from_numpy(XV),
                            cfg.seed, cfg.batch_size, cfg.n_epochs,
                            verbose=0, fused=fused)


def test_a_span_is_the_shared_no_op_without_a_profiler():
    assert span("tick") is span("train.job")
    with span("tick"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("tick") is not span("tick")


def test_spans_nest_under_a_profiler():
    def nested():
        with span("tick"):
            with span("tick.launch"):
                with span("tick.stage"):
                    torch.ones(8, 8).sum()
            with span("tick.collect"):
                pass

    _, spans = _traced(nested)
    assert [s[0] for s in spans] == ["tick", "tick.launch", "tick.stage",
                                     "tick.collect"]
    tick, launch, stage, collect = spans
    assert _inside(launch, tick) and _inside(stage, launch)
    assert _inside(collect, tick) and not _inside(collect, launch)
    assert launch[2] <= collect[1]


@pytest.mark.parametrize("what", ["sequential", "pipelined", "per_epoch",
                                  "fused"])
def test_no_span_enters_record_function_without_a_profiler(
        monkeypatch, detector, what):
    """With no profiler recording, the tick and the trainer never enter
    `record_function`: a span there costs only the check."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if what in ("sequential", "pipelined"):
        _, trace = _run(detector, what == "pipelined", n_ticks=2)
        assert trace.shape == (2, 10) and np.isfinite(trace).all()
    else:
        res = _job(what == "fused")
        assert len(res.valid_history) == 3


@pytest.mark.parametrize("pipelined", [False, True])
def test_run_records_one_tick_span_per_scored_tick(detector, pipelined):
    """One `tick` per scored tick, each holding one snapshot, MFCC staging
    and launch (the tick's staging inside the launch), and one
    `run.hook` per hook call, cold-start calls included.  The sequential
    tick holds its own collect and wait; the pipelined tick i holds tick
    i-1's, and the last collect follows the loop."""
    n = 4
    (hooks, trace), spans = _traced(lambda: _run(detector, pipelined, n))
    assert trace.shape == (n, 10)
    assert len(hooks) > n  # the rings filled over the first calls
    assert len(_named(spans, "run.hook")) == len(hooks)
    ticks = _named(spans, "tick")
    assert len(ticks) == n
    for name in TICK_PARTS + ("tick.collect", "tick.wait"):
        assert len(_named(spans, name)) == n, name
    for tick in ticks:
        held = [s for s in spans if s is not tick and _inside(s, tick)]
        for name in TICK_PARTS:
            assert len(_named(held, name)) == 1, name
        launch, = _named(held, "tick.launch")
        stage, = _named(held, "tick.stage")
        assert _inside(stage, launch)
        assert not any(_inside(tick, h) for h in _named(spans, "run.hook"))
    collects = _named(spans, "tick.collect")
    for collect in collects:
        wait = [s for s in _named(spans, "tick.wait") if _inside(s, collect)]
        assert len(wait) == 1
    owners = [[t for t in ticks if _inside(c, t)] for c in collects]
    if pipelined:
        assert owners == [[t] for t in ticks[1:]] + [[]]
    else:
        assert owners == [[t] for t in ticks]


@pytest.mark.parametrize("n_epochs", [1, 3])
@pytest.mark.parametrize("fused", [False, True])
def test_train_all_epochs_records_its_epoch_spans(fused, n_epochs):
    """One eager epoch, one capture where a replay follows it, a launch per
    replayed epoch and a stage per epoch; per-epoch mode's wait and host
    work once an epoch, the fused mode's never."""
    res, spans = _traced(lambda: _job(fused, n_epochs))
    assert len(res.train_history) == n_epochs
    count = {name: len(_named(spans, name)) for name in (
        "train.setup", "train.stage", "train.eager_epoch", "train.capture",
        "train.launch", "train.sums", "train.end_epoch", "train.finish")}
    per_epoch = 0 if fused else n_epochs
    assert count == {"train.setup": 1, "train.stage": n_epochs,
                     "train.eager_epoch": 1,
                     "train.capture": int(n_epochs > 1),
                     "train.launch": n_epochs - 1, "train.sums": per_epoch,
                     "train.end_epoch": per_epoch, "train.finish": 1}
    eager, = _named(spans, "train.eager_epoch")
    assert all(eager[2] <= s[1] for s in _named(spans, "train.launch")
               + _named(spans, "train.capture"))


def test_a_job_is_one_span_holding_its_two_setups():
    """`NoveltyDetecter.train` is one `train.job`; its windows, optimizer
    and restore and the programs' buffers are two `train.setup` spans, and
    every trainer span lies inside the job."""
    cfg = Config(**TRAIN, n_epochs=2)
    model = get_model(cfg, device="cpu")
    res, spans = _traced(lambda: NoveltyDetecter(cfg, device="cpu").train(
        model, X, XV, fused=False))
    assert len(res.valid_history) == 2
    job, = _named(spans, "train.job")
    assert len(_named(spans, "train.setup")) == 2
    assert all(_inside(s, job) for s in spans)
    assert not any(s[0].startswith(("tick", "run")) for s in spans)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("hit", [True, False], ids=["hit", "miss"])
def test_a_hit_records_a_rebind_and_a_miss_a_capture(hit, fused):
    """A job that finds the programs of its shapes kept records one
    `train.rebind` and replays every epoch: no eager epoch, no capture.
    A job on an empty cache records the reverse.  Their counts in a trace
    are the cache's hits and misses."""
    if hit:
        _job(fused)
    hits, misses = PROGRAMS.hits, PROGRAMS.misses
    res, spans = _traced(lambda: _job(fused))
    assert len(res.train_history) == 3
    count = {name: len(_named(spans, name)) for name in (
        "train.rebind", "train.eager_epoch", "train.capture",
        "train.launch")}
    assert count == {"train.rebind": int(hit),
                     "train.eager_epoch": int(not hit),
                     "train.capture": int(not hit),
                     "train.launch": 3 - (not hit)}
    assert (PROGRAMS.hits - hits, PROGRAMS.misses - misses) == (
        int(hit), int(not hit))
    setup, = _named(spans, "train.setup")
    assert all(setup[2] <= s[1] for s in _named(spans, "train.rebind"))
