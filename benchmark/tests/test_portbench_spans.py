"""The readers of the program's spans (`benchmark/metrics/_spans.py`): self
time and idle time on a hand-built trace, and the span metrics of a whole
traced run of each cell at tiny sizes on the CPU."""

import pytest

from benchmark.harness import cli
from benchmark.harness import manifest as mf
from benchmark.harness.trace import Trace
from benchmark.metrics import _spans
from benchmark.tests.test_portbench_faults import _run

MS = 1e-3


def _trace(host, gaps=(), busy_s=1.0):
    """A trace of host ops (name, start ms, end ms) and idle gaps (start
    ms, end ms) in a 20 ms window."""
    return Trace(host_ops=[(n, s * MS, (e - s) * MS) for n, s, e in host],
                 idle_gaps=[(s * MS, (e - s) * MS) for s, e in gaps],
                 window_s=20 * MS, busy_s=busy_s)


#: one tick: a launch holding the staging, a collect holding the wait, an
#: aten op inside the staging and a hook before the tick
TICK = [("run.hook", 0, 1), ("tick", 1, 11), ("tick.launch", 2, 6),
        ("tick.stage", 3, 5), ("aten::copy_", 3.5, 4),
        ("tick.collect", 7, 10), ("tick.wait", 8, 9)]


def _ctx(trace):
    return cli.Readings({}, {}, trace, {}, {})


def _in_ms(stats):
    return {k: (c, pytest.approx(s / MS), pytest.approx(i / MS))
            for k, (c, s, i) in stats.items()}


def test_self_time_leaves_out_child_spans_only():
    got = _in_ms(_spans.stats(_trace(TICK)))
    assert got == {"run.hook": (1, 1, 0), "tick": (1, 3, 0),
                   "tick.launch": (1, 2, 0), "tick.stage": (1, 2, 0),
                   "tick.collect": (1, 2, 0), "tick.wait": (1, 1, 0)}
    read = {m: mf.reader(m)(_ctx(_trace(TICK))) for m in (
        "tick_stage_ms", "tick_launch_ms", "tick_collect_ms")}
    assert read == {"tick_stage_ms": pytest.approx(2.0),
                    "tick_launch_ms": pytest.approx(2.0),
                    "tick_collect_ms": pytest.approx(2.0)}


def test_a_gap_is_split_across_the_spans_over_it():
    """A gap from 4.5 to 7.5 ms lies under the staging, the launch, the
    tick and the collect in turn; one from 8.5 to 11.5 under the wait, the
    collect, the tick and no span; one from 0.5 to 1.5 under the hook and
    the tick."""
    trace = _trace(TICK, gaps=[(0.5, 1.5), (4.5, 7.5), (8.5, 11.5)])
    idle = {k: v[2] / MS for k, v in _spans.stats(trace).items()}
    assert idle == {"run.hook": pytest.approx(0.5),
                    "tick": pytest.approx(2.5),
                    "tick.launch": pytest.approx(1.0),
                    "tick.stage": pytest.approx(0.5),
                    "tick.collect": pytest.approx(1.5),
                    "tick.wait": pytest.approx(0.5)}
    # the tick's host work, without the wait, the hook or the 0.5 ms under
    # no span
    assert mf.reader("idle_host_ms.tick")(_ctx(trace)) == pytest.approx(5.5)


def test_a_gap_under_no_span_is_given_to_none():
    trace = _trace(TICK, gaps=[(12, 15)])
    assert all(v[2] == 0 for v in _spans.stats(trace).values())
    assert mf.reader("idle_host_ms.tick")(_ctx(trace)) == 0


def test_the_training_readers_divide_by_the_jobs():
    host = [("train.job", 0, 13), ("train.setup", 0.5, 1.5),
            ("train.setup", 2, 3), ("train.eager_epoch", 3, 6),
            ("train.capture", 6, 8), ("train.launch", 8, 9),
            ("train.sums", 9, 12), ("train.end_epoch", 12, 13),
            ("train.job", 13.5, 14)]
    trace = _trace(host, gaps=[(5, 7), (10, 14)])
    ctx = _ctx(trace)
    read = {m: mf.reader(m)(ctx) for m in (
        "train_setup_ms", "train_end_epoch_ms", "idle_host_ms.train")}
    # two jobs; of the idle, the part under the sums (10-12) and under no
    # span (13-13.5) left out
    assert read == {"train_setup_ms": pytest.approx(1.0),
                    "train_end_epoch_ms": pytest.approx(0.5),
                    "idle_host_ms.train": pytest.approx(1.75)}


@pytest.mark.parametrize("metric", [
    "tick_stage_ms", "tick_launch_ms", "tick_collect_ms", "idle_host_ms.tick",
    "train_setup_ms", "train_end_epoch_ms", "idle_host_ms.train"])
def test_a_reader_that_finds_no_span_returns_none(metric):
    """The parent's program records no span: every reader returns None,
    never 0; the idle readers also where the card ran nothing."""
    ctx = _ctx(_trace([("aten::mm", 1, 2)], gaps=[(0, 5)]))
    assert mf.reader(metric)(ctx) is None
    if metric.startswith("idle_"):
        host = TICK + [("train.job", 12, 13)]
        assert mf.reader(metric)(_ctx(_trace(host, busy_s=0.0))) is None


@pytest.mark.parametrize("cell, metrics", [
    ("all_1728.tick_nap", ["tick_stage_ms", "tick_launch_ms",
                           "tick_collect_ms"]),
    ("all_1728.train", ["train_setup_ms", "train_end_epoch_ms",
                        "train_rebind_ms"]),
    ("all_1728.tick_base", ["tick_stage_ms", "tick_launch_ms",
                            "tick_collect_ms"])])
def test_a_traced_run_reports_its_span_metrics(cell, metrics):
    """A whole traced run at tiny sizes on the CPU reports each span metric
    of its cell, above 0; the idle readers, with no card, report none."""
    result = _run(cell, trace=True)
    assert result["correct"], result["checks"]
    for m in metrics:
        assert result["metrics"][m]["value"] > 0, m
        assert result["metrics"][m]["unit"] == "ms"
    assert not any(m.startswith("idle_host_ms") for m in result["metrics"])
