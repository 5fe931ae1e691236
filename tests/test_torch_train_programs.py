"""The trainer's epoch programs (train.EpochPrograms) on the CPU, against the
port's eager loop and the JAX package's two training modes.

On the CPU a program calls its function eagerly on its staging, so these
tests hold what the programs compute: the device-key PRNG forms against the
numpy-key ones (bit-equal), each mode against JAX's same mode (rtol 2e-3 in
fp32 and for VIB, 2e-2 for bf16 training and bf16 params, the tolerances of
tests/test_torch_train.py:188-190),
fused against per-epoch (rtol 1e-5, as tests/test_end_to_end.py:112-119
holds JAX's), and the program path against the eager loop, bit for bit.
The CUDA graphs run only on the card (chip_smoke.py, phase 13)."""

import numpy as np
import pytest
import torch

from icra2021_multimodal_ad_tpu.config import Config as JConfig
from icra2021_multimodal_ad_tpu.models.builder import get_model as jget_model
from icra2021_multimodal_ad_tpu.train import NoveltyDetecter as JNoveltyDetecter
from icra2021_multimodal_ad_tpu_torch import train
from icra2021_multimodal_ad_tpu_torch.config import Config
from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
from icra2021_multimodal_ad_tpu_torch.train import (
    NoveltyDetecter,
    eval_epoch,
    make_optimizer,
    train_all_epochs,
    train_all_epochs_eager,
)
from icra2021_multimodal_ad_tpu_torch.utils import graphs, jax_prng

#: 56 train rows at batch 16: three full batches and a tail of 8
FIELDS = dict(input_size=12, btl_size=3, n_layers=2, batch_size=16,
              n_epochs=3, lr=1e-2, verbose=0, seed=1)
VARIANTS = {"float32": {}, "bf16_train": dict(train_dtype="bfloat16"),
            "bf16_params": dict(param_dtype="bfloat16"),
            "vib": dict(distribution="normal", k=2)}
JAX_RTOL = {"float32": 2e-3, "bf16_train": 2e-2, "bf16_params": 2e-2,
            "vib": 2e-3}
#: the keys of tests/test_torch_prng.py and words near 2**32
KEYS = [jax_prng.prng_key(s) for s in (0, 7, 2 ** 32 + 3)] + [
    np.array([2 ** 32 - 1, 2 ** 32 - 2], np.uint32),
    np.array([2 ** 31 + 5, 2 ** 32 - 7], np.uint32)]


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    mix = np.random.default_rng(99).normal(size=(4, 12)) * 0.5
    return (rng.normal(size=(n, 4)) @ mix
            + 0.1 * rng.normal(size=(n, 12))).astype(np.float32)


X, XV = _rows(56, 1), _rows(24, 2)


def _tensor_key(key):
    return torch.from_numpy(key.astype(np.int64))


@pytest.mark.parametrize("shape", [(7,), (3, 50)])
@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]:x}_{k[1]:x}")
def test_device_key_draws_are_bit_equal(key, shape):
    """A (2,) int64 tensor key draws what its numpy words draw: threefry,
    uniform in both dtypes, normal, in the torch ops a card runs (here on
    CPU tensors) and on the CPU's numpy path."""
    tk = _tensor_key(key)
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64)
    assert torch.equal(jax_prng._threefry_torch(tk, idx),
                       jax_prng._threefry_torch(key, idx))
    for dtype in ("float32", "bfloat16"):
        want = jax_prng._uniform_torch(key, shape, -0.3, 0.3, dtype, "cpu")
        got = jax_prng._uniform_torch(tk, shape, -0.3, 0.3, dtype, "cpu")
        assert torch.equal(got, want)
        assert torch.equal(jax_prng.uniform_device(tk, shape, -0.3, 0.3,
                                                   dtype), want)
        assert torch.equal(jax_prng.normal_device(tk, shape, dtype),
                           jax_prng.normal_device(key, shape, dtype))
    # normal as the card draws it: the torch uniform under the tensor key
    u = jax_prng._uniform_torch(tk, shape, jax_prng._NORMAL_LO, 1.0,
                                "float32", "cpu")
    np.testing.assert_array_equal(
        (jax_prng._SQRT2_F32 * jax_prng._erf_inv_torch(u)).numpy(),
        jax_prng.normal(key, shape))


def _cfg(variant, **kw):
    return Config(**{**FIELDS, **VARIANTS[variant], **kw})


def _jax_train(variant, fused):
    jcfg = JConfig(**{**FIELDS, **VARIANTS[variant]})
    jm, params, state = jget_model(jcfg)
    return JNoveltyDetecter(jcfg).train(jm, params, state, X, XV,
                                        fused=fused)


@pytest.mark.parametrize("variant", VARIANTS)
def test_both_modes_agree_and_track_jax(variant):
    """fused and per-epoch give valid histories within rtol 1e-5 of each
    other, and each is within the variant's tolerance of JAX's same mode
    (VIB through the program path with its staged device keys)."""
    cfg = _cfg(variant)
    runs = {fused: NoveltyDetecter(cfg, device="cpu").train(
        get_model(cfg, device="cpu"), X, XV, fused=fused)
        for fused in (True, False)}
    np.testing.assert_allclose(runs[True].valid_history,
                               runs[False].valid_history, rtol=1e-5)
    for fused, res in runs.items():
        ref = _jax_train(variant, fused)
        np.testing.assert_allclose(res.train_history, ref.train_history,
                                   rtol=JAX_RTOL[variant])
        np.testing.assert_allclose(res.valid_history, ref.valid_history,
                                   rtol=JAX_RTOL[variant])
        assert len(res.train_ms) == len(res.eval_ms) == cfg.n_epochs


def _optimizer_state(opt):
    return [t for st in opt.state.values()
            for t in (st["step"], st["exp_avg"], st["exp_avg_sq"])]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("variant", ["float32", "vib"])
def test_program_path_is_bit_equal_to_the_eager_loop(variant, fused):
    """The programs and the eager loop from one seed: the same final
    weights, BN buffers and Adam state, bit for bit, and the same
    histories (fused: the fp32 quotients of the eager loop's sums, which
    rounding the float64 quotient to fp32 gives exactly).  Every Adam
    step is the run's own: the warm-up adds none."""
    cfg = _cfg(variant)
    x, xv = torch.from_numpy(X), torch.from_numpy(XV)
    sides = {}
    for name, loop, kw in (("programs", train_all_epochs, dict(fused=fused)),
                           ("eager", train_all_epochs_eager, {})):
        model = get_model(cfg, device="cpu")
        opt = make_optimizer(model, cfg.lr)
        res = loop(model, opt, x, xv, cfg.seed, cfg.batch_size,
                   cfg.n_epochs, **kw)
        sides[name] = res, opt
    (ours, opt), (ref, ref_opt) = sides["programs"], sides["eager"]
    for (k, a), b in zip(ours.model.state_dict().items(),
                         ref.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(_optimizer_state(opt), _optimizer_state(ref_opt)):
        assert torch.equal(a, b)
    steps = cfg.n_epochs * -(-len(X) // cfg.batch_size)
    assert {float(st["step"]) for st in opt.state.values()} == {steps}
    if fused:
        want = [float(np.float32(v)) for v in ref.valid_history]
        assert ours.valid_history == want
        assert ours.train_history == [float(np.float32(v))
                                      for v in ref.train_history]
    else:
        assert ours.valid_history == ref.valid_history
        assert ours.train_history == ref.train_history
    assert all(p.grad is None for p in ours.model.parameters())


def test_fused_history_is_fp32_and_restores_the_lowest():
    """The fused mode's history is the fp32 quotient of each epoch's sums,
    and the restored model evaluates to its minimum exactly: the best
    snapshot was written on the device and loaded once, at the end."""
    cfg = _cfg("float32", n_epochs=6, lr=3e-2)
    res = NoveltyDetecter(cfg, device="cpu").train(
        get_model(cfg, device="cpu"), X, XV, fused=True)
    assert all(float(np.float32(v)) == v for v in res.valid_history)
    restored = eval_epoch(res.model, torch.from_numpy(XV), cfg.batch_size)
    assert float(restored / len(XV)) == min(res.valid_history)
    assert not res.model.training


@pytest.mark.parametrize("verbose, fused, every, want", [
    (0, None, 0, True), (1, None, 0, False), (0, False, 0, False),
    (2, True, 0, True), (0, None, 2, False), (0, True, 2, False)])
def test_mode_is_chosen_as_jax_chooses_it(monkeypatch, tmp_path, verbose,
                                          fused, every, want):
    """JAX's train.py:403-407: fused by default with verbose < 1 and no
    checkpointing, never with checkpointing."""
    seen = {}

    def spy(*args, **kw):
        seen["fused"] = kw["fused"]
        return train_all_epochs(*args, **kw)

    monkeypatch.setattr(train, "train_all_epochs", spy)
    cfg = _cfg("float32", verbose=verbose, n_epochs=2)
    NoveltyDetecter(cfg, device="cpu").train(
        get_model(cfg, device="cpu"), X, XV, fused=fused,
        checkpoint_path=str(tmp_path / "ckpt") if every else None,
        checkpoint_every=every)
    assert seen["fused"] is want


def test_a_stateful_program_runs_its_function_once_a_launch():
    """A stateful program takes no warm-up passes of its own: each launch,
    before and after `capture`, is one call of its function."""
    calls = torch.zeros((), dtype=torch.int64)

    def step(x):
        calls.add_(1)
        return x * 2

    prog = graphs.Program(step, [((2,), torch.float32)],
                          torch.device("cpu"), slots=2, stateful=True)
    prog.staging(0)[0][:] = [1, 2]
    prog.launch(0)
    prog.capture()
    for slot in (1, 0, 1):
        prog.launch(slot)
    assert int(calls) == 4
    assert prog.output(0).tolist() == [2.0, 4.0]


def test_fused_refuses_a_resumed_start():
    cfg = _cfg("float32")
    model = get_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="epoch 0"):
        train_all_epochs(model, make_optimizer(model, cfg.lr),
                         torch.from_numpy(X), torch.from_numpy(XV), cfg.seed,
                         cfg.batch_size, cfg.n_epochs, start_epoch=1,
                         fused=True)

