"""The reader of the trainer's rebind span (`train_rebind_ms`) on
hand-built traces: its self time per job, and nothing where no job
rebound, as on a program that keeps no epoch programs."""

import pytest

from benchmark.harness import cli
from benchmark.harness import manifest as mf
from benchmark.harness.trace import Trace

MS = 1e-3


def _read(host):
    trace = Trace(host_ops=[(n, s * MS, (e - s) * MS) for n, s, e in host],
                  idle_gaps=[], window_s=20 * MS, busy_s=1.0)
    return mf.reader("train_rebind_ms")(cli.Readings({}, {}, trace, {}, {}))


def test_the_rebind_is_read_per_job():
    """Two jobs, each rebinding once; the copy under the second rebind is
    no span and counts in it."""
    host = [("train.job", 0, 6), ("train.setup", 0.5, 1),
            ("train.rebind", 1, 1.5), ("train.launch", 2, 5),
            ("train.job", 7, 12), ("train.rebind", 7.5, 8.5),
            ("aten::copy_", 7.6, 8.4)]
    assert _read(host) == pytest.approx(0.75)


@pytest.mark.parametrize("host", [
    [("train.job", 0, 5), ("train.eager_epoch", 1, 2),
     ("train.capture", 2, 3)],
    [("train.rebind", 0, 1)],
    [("aten::mm", 1, 2)]], ids=["captured", "no_job", "no_span"])
def test_no_rebind_reads_none(host):
    assert _read(host) is None
