"""The port's timing and tracing (utils/profiling.py) on the CPU, the cases
of tests/test_config_profiling.py: the warm-up keeps a slow first call
out, the paired loop estimator returns positive samples within their
spread and raises rather than clamp, and the trace is a Chrome trace.
A CUDA device on a host without CUDA raises: no timing falls back to the
CPU."""

import json
import os
import time

import pytest
import torch

from icra2021_multimodal_ad_tpu_torch.utils import profiling
from icra2021_multimodal_ad_tpu_torch.utils.profiling import (
    retry,
    timed,
    timed_loop,
    timed_loop_stats,
    trace,
)


def test_timed_excludes_the_first_call():
    calls = {"n": 0}

    def fn(x):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.3)  # a first call's build
        return x + 1

    dt = timed(fn, torch.ones(8), warmup=1, iters=5, device="cpu")
    assert dt < 0.05, dt
    assert calls["n"] == 6


def _make_body():
    def body(i, acc):
        x = torch.full((64, 64), float(acc) + i)
        return acc + (x @ x).sum() * 1e-20
    return body


def test_timed_loop_stats_median_within_spread():
    st = timed_loop_stats(_make_body, n_iters=4, repeats=3, device="cpu")
    assert st["samples"] == 3
    assert 0 < st["min_s"] <= st["median_s"] <= st["max_s"]
    for _ in range(10):
        t = timed_loop(_make_body, n_iters=4, device="cpu")
        if t > 1e-8:
            break
    assert t > 1e-8, "timed_loop returned only clamped samples in 10 tries"
    assert st["median_s"] < 50 * t and t < 50 * st["median_s"]


def test_timed_loop_stats_raises_on_pure_noise(monkeypatch):
    """Every pair non-positive: no fabricated number, an error."""
    def harness(make_body, device):
        return None, lambda n: 1.0 if n == 1 else 0.5

    monkeypatch.setattr(profiling, "_loop_harness", harness)
    with pytest.raises(RuntimeError, match="not resolvable"):
        timed_loop_stats(_make_body, n_iters=4, repeats=2, device="cpu")


def test_timed_loop_stats_remeasures_invalid_pairs(monkeypatch):
    """Invalid pairs are discarded and measured again, not clamped."""
    seq = iter([1.0, 2.0] + [1.0, 0.5] + [1.0, 2.0] * 2 + [1.0, 2.0] * 9)

    def harness(make_body, device):
        return None, lambda n: next(seq)

    monkeypatch.setattr(profiling, "_loop_harness", harness)
    st = timed_loop_stats(_make_body, n_iters=4, repeats=2, device="cpu")
    assert st["samples"] == 2 and st["min_s"] == pytest.approx(0.25)


def test_retry_reraises_the_last_error():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry(flaky, attempts=3, wait_s=0) == "ok"
    with pytest.raises(ValueError, match="always"):
        retry(lambda: (_ for _ in ()).throw(ValueError("always")),
              attempts=2, wait_s=0)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir, device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_trace_pads_only_the_card(tmp_path, monkeypatch):
    """The quiet around the block keeps the card's events inside the
    profiler's window; the host's clock needs none."""
    assert profiling.DEVICE_PAD_S > 0
    slept = []
    monkeypatch.setattr(profiling.time, "sleep", slept.append)
    with trace(str(tmp_path / "trace"), device="cpu", pad_s=10.0):
        pass
    assert not any(slept)


@pytest.mark.parametrize("fn", ["timed", "timed_loop", "trace"])
def test_the_card_is_the_default_and_never_falls_back(fn):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    calls = {
        "timed": lambda: timed(lambda: None),
        "timed_loop": lambda: timed_loop(_make_body, n_iters=2),
        "trace": lambda: trace().__enter__(),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[fn]()
