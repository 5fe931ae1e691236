"""The score server's captured programs (ops/serving.ServingPrograms) on
the CPU, where a program calls its scorer eagerly on its own staging: the
server's scores through the programs against its eager path bit for bit,
for every op, in fp32, bf16 and bf16 + int8 bundles, at buckets 1 to 64
from ragged row counts; against the JAX package's server in process; pad
rows rewritten on every request; warm-up; a meshed bundle refused.

The model is small (sensor All, n_layers 2, btl 6) and every server is
built once per module, so each test costs at most a few JAX compiles."""

import jax  # noqa: F401 -- JAX on the CPU beside torch, as the other tests
import numpy as np
import pytest
import torch

from icra2021_multimodal_ad_tpu.config import Config as JConfig
from icra2021_multimodal_ad_tpu.config import get_input_size
from icra2021_multimodal_ad_tpu.ops import score_server as jscore_server
from icra2021_multimodal_ad_tpu.ops.rapp import get_diffs
from icra2021_multimodal_ad_tpu.ops.scoring import (
    concat_diffs,
    nap_effective_stats,
    nap_fit,
)
from icra2021_multimodal_ad_tpu_torch.ops.score_server import ScoreServer
from icra2021_multimodal_ad_tpu_torch.ops.serving import (
    SERVED_OPS,
    ServingPrograms,
    make_serving,
)
from icra2021_multimodal_ad_tpu_torch.parallel.mesh import Mesh
from tests.test_torch_int8_nap import port_config, port_stats
from tests.test_torch_score_server import _jax_stats, _sensor_batch, get_twin

MAX_BATCH = 64
#: request rows: buckets 1, 8, 16 and 64, and one above max_batch (two
#: chunks for fused windows, refused for sensor payloads)
ROWS = (1, 7, 13, 33, 97)
FUSED_OPS = ("score_base", "score_sap", "score_nap")
SENSOR_OPS = ("score_base_sensor", "score_sap_sensor", "score_nap_sensor")
#: the bundles the serve CLI builds: fp32, bf16, bf16 + int8 NAP
PRECISIONS = {"float32": {},
              "bfloat16": {"compute_dtype": "bfloat16"},
              "int8": {"compute_dtype": "bfloat16", "nap_quant": "int8"}}
#: the port's server against JAX's (tests/test_score_server.py:60-84 and
#: tests/test_torch_score_server.py): whitening amplifies the packages'
#: different summation orders, the fusion convs theirs
JAX_TOL = {"score_base": 1e-5, "score_sap": 1e-5, "score_nap": 1e-3,
           "score_base_sensor": 1e-4, "score_sap_sensor": 1e-4,
           "score_nap_sensor": 1e-3}


def _cfg():
    cfg = JConfig(sensor="All", n_layers=2, btl_size=6, verbose=0)
    return cfg.replace(input_size=get_input_size(cfg))


@pytest.fixture(scope="module")
def fitted():
    """The JAX model, its port twin and variance-floored NAP stats fitted
    on JAX's diffs of seeded windows (as tests/test_torch_score_server's
    `served_all`)."""
    cfg = _cfg()
    model, params, state, twin = get_twin(cfg)
    rng = np.random.default_rng(2)
    xfit = rng.normal(0, 1, (96, cfg.input_size)).astype(np.float32)
    stats = nap_effective_stats(
        nap_fit(concat_diffs(get_diffs(xfit, model, params, state))), 1e-6)
    return cfg, twin, port_stats(stats)


@pytest.fixture(scope="module")
def servers(fitted):
    """One port server per precision, on the CPU, not started: the tests
    call its scoring methods in process."""
    cfg, twin, stats = fitted
    return {name: ScoreServer(port_config(cfg, **kw), twin, nap_stats=stats,
                              max_batch=MAX_BATCH, device="cpu")
            for name, kw in PRECISIONS.items()}


def _windows(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, _cfg().input_size)).astype(np.float32)


def _captured_and_eager(server, op, n, seed):
    if op in SENSOR_OPS:
        batch = _sensor_batch(n, seed=seed)
        return (server._score_sensor_op(op, *batch),
                server._score_sensor_op_eager(op, *batch))
    x = _windows(n, seed)
    return server._score(op, x), server._score_eager(op, x)


def _buckets(programs, op):
    return {inputs[0][0][0] for key_op, inputs in programs.programs
            if key_op == op}


@pytest.mark.parametrize("op", FUSED_OPS + SENSOR_OPS)
@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_programs_equal_the_eager_server(servers, precision, op):
    """Every op's programs give the eager server's scores bit for bit, at
    every bucket that ragged requests reach; a sensor request above
    max_batch is refused on both paths."""
    server = servers[precision]
    for n in ROWS:
        if op in SENSOR_OPS and n > MAX_BATCH:
            for score in (server._score_sensor_op,
                          server._score_sensor_op_eager):
                with pytest.raises(ValueError, match="capped at max_batch"):
                    score(op, *_sensor_batch(n, seed=n))
            continue
        got, want = _captured_and_eager(server, op, n, seed=n)
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"{op} n={n}")
    assert {1, 16, 64} <= _buckets(server.programs, op)


@pytest.fixture(scope="module")
def jax_server(fitted, servers):
    """JAX's server on the same weights (its model draw) and stats."""
    cfg = _cfg()
    model, params, state, _ = get_twin(cfg)
    return jscore_server.ScoreServer(
        cfg, model, params, state,
        nap_stats=_jax_stats(servers["float32"]), max_batch=MAX_BATCH)


@pytest.mark.parametrize("op", FUSED_OPS + SENSOR_OPS)
def test_programs_match_the_jax_server(servers, jax_server, op):
    """The fp32 server's programs against JAX's `_score` and
    `_score_sensor_op` on the same inputs, at the existing tolerances."""
    server = servers["float32"]
    for n in (7, 33):
        if op in SENSOR_OPS:
            batch = _sensor_batch(n, seed=n + 100)
            got = server._score_sensor_op(op, *batch)
            want = jax_server._score_sensor_op(op, *batch)
        else:
            x = _windows(n + 64, seed=n + 100)
            got, want = server._score(op, x), jax_server._score(op, x)
        np.testing.assert_allclose(got, want, rtol=JAX_TOL[op], atol=1e-7,
                                   err_msg=f"{op} n={n}")


@pytest.mark.parametrize("op", ["score_nap", "score_nap_sensor"])
def test_pad_rows_are_rewritten_on_every_request(servers, op):
    """A request of 9 rows after one of 13 in the same bucket (16) scores
    as on fresh programs: its pad rows hold zeros (fused windows) or row
    0's payload (sensor), never the last request's rows, which would widen
    the mic's min-max over the request."""
    server = servers["float32"]
    sensor = op in SENSOR_OPS
    big = _sensor_batch(13, seed=5) if sensor else (_windows(13, seed=5),)
    small = _sensor_batch(9, seed=6) if sensor else (_windows(9, seed=6),)
    server.programs.score(op, 16, *big)
    got = server.programs.score(op, 16, *small)
    staged = server.programs.program(op, 16, *small).staging()
    for rows, pad in zip(small, staged):
        want_pad = np.broadcast_to(rows[:1], (7,) + rows.shape[1:]) if sensor \
            else np.zeros((7,) + rows.shape[1:], rows.dtype)
        np.testing.assert_array_equal(pad[9:], want_pad)
    fresh = ServingPrograms(server.serving).score(op, 16, *small)
    np.testing.assert_array_equal(got, fresh)


def test_warmup_captures_every_op_at_the_smallest_and_largest_bucket(
        fitted):
    """warmup() captures each served op at buckets 1 and max_batch, the
    sensor ops on 32 x 32 frames, and returns the ops it warmed."""
    cfg, twin, stats = fitted
    server = ScoreServer(port_config(cfg), twin, nap_stats=stats,
                         max_batch=8, device="cpu")
    ops = server.warmup()
    assert ops == list(FUSED_OPS + SENSOR_OPS)
    for op in ops:
        assert _buckets(server.programs, op) == {1, 8}
    frames = {inputs[0][0][1:] for op, inputs in server.programs.programs
              if op in SENSOR_OPS}
    assert frames == {(3, 32, 32)}
    assert set(SERVED_OPS) == set(ops)


def test_a_meshed_bundle_is_refused(fitted):
    """A bundle sharded over a mesh scores through collectives, which are
    not captured: ServingPrograms refuses it with a clear error."""
    cfg, twin, stats = fitted
    mesh = Mesh(world_size=2, rank=0, device=torch.device("cpu"),
                backend="gloo")
    bundle = make_serving(port_config(cfg), twin, nap_stats=stats,
                          mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        ServingPrograms(bundle)
