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
from icra2021_multimodal_ad_tpu_torch.parallel.mesh import Mesh
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


@pytest.fixture(autouse=True)
def _fresh_program_cache():
    """Each test starts with no kept epoch programs and zero hit and miss
    counts (`train.PROGRAMS`): a worker runs many test files in one
    process, and a job's captured programs serve the process's next job of
    the same shapes."""
    train.PROGRAMS.clear()


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



def _programs_job(cfg, x=X, xv=XV, model=None, fused=False, seed=None,
                  **kw):
    """One job of `train_all_epochs` on the CPU: (result, optimizer)."""
    model = model or get_model(cfg, device="cpu")
    opt = make_optimizer(model, cfg.lr)
    res = train_all_epochs(model, opt, torch.from_numpy(x),
                           torch.from_numpy(xv),
                           cfg.seed if seed is None else seed,
                           cfg.batch_size, cfg.n_epochs, fused=fused, **kw)
    return res, opt


def _state(module_or_opt):
    if isinstance(module_or_opt, torch.optim.Optimizer):
        return [t.clone() for t in _optimizer_state(module_or_opt)]
    return {k: v.clone() for k, v in module_or_opt.state_dict().items()}


def _equal_states(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


class _Built(train.EpochPrograms):
    """EpochPrograms that counts its builds and captures."""
    built = captured = 0

    def __init__(self, *args, **kw):
        type(self).built += 1
        super().__init__(*args, **kw)

    def capture(self):
        type(self).captured += 1
        super().capture()


@pytest.fixture
def built(monkeypatch):
    monkeypatch.setattr(_Built, "built", 0)
    monkeypatch.setattr(_Built, "captured", 0)
    monkeypatch.setattr(train, "EpochPrograms", _Built)
    return _Built


@pytest.mark.parametrize("fused", [False, True], ids=["per_epoch", "fused"])
def test_a_second_job_of_the_same_key_is_a_hit(built, fused):
    """Two jobs of one configuration through `NoveltyDetecter.train`: the
    first builds, runs its first epoch eagerly and captures, the second
    rebinds what the first kept and builds nothing."""
    cfg = _cfg("float32")
    det = NoveltyDetecter(cfg, device="cpu")
    for _ in range(2):
        res = det.train(get_model(cfg, device="cpu"), X, XV, fused=fused)
        assert len(res.valid_history) == cfg.n_epochs
    assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (1, 1)
    assert (built.built, built.captured) == (1, 1)


#: one change to a job's key each: (config fields, windows' width, fused)
KEY_CHANGES = {
    "width": (dict(input_size=10), 10, False),
    "batch": (dict(batch_size=8), 12, False),
    "dtype": (dict(train_dtype="bfloat16"), 12, False),
    "params_dtype": (dict(param_dtype="bfloat16"), 12, False),
    "lr": (dict(lr=2e-2), 12, False),
    "epochs": (dict(n_epochs=4), 12, False),
    "fused": ({}, 12, True),
    "vib": (dict(distribution="normal", k=2), 12, False),
}


@pytest.mark.parametrize("change", KEY_CHANGES)
def test_a_job_of_another_key_is_a_miss(built, change):
    """A job that differs from the kept one in width, batch, dtype, lr,
    epochs, mode or architecture builds and captures its own programs,
    after the kept ones are released, and they become the entry."""
    fields, width, fused = KEY_CHANGES[change]
    det = NoveltyDetecter(_cfg("float32"), device="cpu")
    det.train(get_model(_cfg("float32"), device="cpu"), X, XV, fused=False)
    (_, old), = train.PROGRAMS._entries.values()
    cfg = _cfg("float32", **fields)
    det = NoveltyDetecter(cfg, device="cpu")
    res = det.train(get_model(cfg, device="cpu"), X[:, :width],
                    XV[:, :width], fused=fused)
    assert len(res.valid_history) == cfg.n_epochs
    assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (0, 2)
    assert (built.built, built.captured) == (2, 2)
    assert not vars(old)  # released, not left to the collector
    det.train(get_model(cfg, device="cpu"), X[:, :width], XV[:, :width],
              fused=fused)
    assert (train.PROGRAMS.hits, built.built) == (1, 2)


class _Meshed(Exception):
    pass


def _resumed(cfg, model, opt):
    return dict(start_epoch=1, best={"loss": np.inf,
                                     "state_dict": train._snapshot(model)})


def _checkpointed(cfg, model, opt, tmp_path):
    return dict(checkpoint_path=str(tmp_path / "ckpt"), checkpoint_every=1)


def _loaded(cfg, model, opt):
    train.train_step(model, opt, torch.from_numpy(X[:16]))
    return {}


def _meshed(cfg, model, opt):
    return dict(mesh=Mesh(world_size=2, rank=0,
                          device=torch.device("cpu"), backend="gloo"))


@pytest.mark.parametrize("how", ["resumed", "checkpointed", "loaded",
                                 "meshed"])
def test_resumed_checkpointed_and_meshed_jobs_bypass_the_cache(
        monkeypatch, tmp_path, built, how):
    """A resumed job, one that checkpoints, one whose optimizer has state
    already and a meshed one neither take the kept programs nor replace
    them: they build their own, as before, and the next job of the kept
    key still hits."""
    cfg = _cfg("float32")
    _programs_job(cfg)
    model = get_model(cfg, device="cpu")
    opt = make_optimizer(model, cfg.lr)
    options = {"resumed": _resumed, "loaded": _loaded, "meshed": _meshed,
               "checkpointed": lambda *a: _checkpointed(*a, tmp_path)}[how](
        cfg, model, opt)
    if how == "meshed":
        # the meshed step needs a process group; its route is what counts
        def build(*args):
            assert args[-1] is options["mesh"]
            raise _Meshed
        monkeypatch.setattr(train, "EpochPrograms", build)
        with pytest.raises(_Meshed):
            train_all_epochs(model, opt, torch.from_numpy(X),
                             torch.from_numpy(XV), cfg.seed, cfg.batch_size,
                             cfg.n_epochs, **options)
        monkeypatch.setattr(train, "EpochPrograms", _Built)
    else:
        res = train_all_epochs(model, opt, torch.from_numpy(X),
                               torch.from_numpy(XV), cfg.seed,
                               cfg.batch_size, cfg.n_epochs, **options)
        assert len(res.valid_history) == cfg.n_epochs - options.get(
            "start_epoch", 0)
        assert built.built == 2
    assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (0, 1)
    _programs_job(cfg)
    assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (1, 1)


@pytest.mark.parametrize("same_model", [True, False],
                         ids=["same_model", "new_model"])
@pytest.mark.parametrize("fused", [False, True], ids=["per_epoch", "fused"])
@pytest.mark.parametrize("variant", ["float32", "vib", "bf16_train"])
def test_a_hit_trains_as_a_job_after_the_cache_is_cleared(variant, fused,
                                                          same_model):
    """A hit on other windows of the same shapes and another seed, with the
    first job's model reset to its initial weights or a new one, gives the
    histories, the returned weights and BN buffers and Adam's state of the
    same job run on an empty cache, bit for bit."""
    cfg = _cfg(variant)
    first = get_model(cfg, device="cpu")
    start = _state(first)
    _programs_job(cfg, model=first, fused=fused)
    # windows of larger losses: a best loss left from the first job would
    # keep its snapshot
    x2, xv2 = 3 * _rows(56, 3), 3 * _rows(24, 4)
    if same_model:
        first.load_state_dict(start)
    model = first if same_model else get_model(cfg, device="cpu")
    hit, hit_opt = _programs_job(cfg, x2, xv2, model=model, fused=fused,
                                 seed=5)
    assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (1, 1)
    hit_state, hit_adam = _state(hit.model), _state(hit_opt)
    train.PROGRAMS.clear()
    fresh, fresh_opt = _programs_job(cfg, x2, xv2, fused=fused, seed=5)
    assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (0, 1)
    assert hit.train_history == fresh.train_history
    assert hit.valid_history == fresh.valid_history
    assert _equal_states(hit_state, _state(fresh.model))
    assert _equal_states(hit_adam, _state(fresh_opt))
    assert len(hit.train_ms) == len(hit.eval_ms) == cfg.n_epochs
    assert not hit.model.training
    assert all(p.grad is None for p in hit.model.parameters())


def test_a_hit_with_a_new_model_leaves_the_first_as_returned():
    """The first job's model and optimizer, still held, keep what the job
    left them while a second model of the same architecture trains on the
    kept programs, and share no storage with it."""
    cfg = _cfg("float32")
    res, opt = _programs_job(cfg)
    model, adam = _state(res.model), _state(opt)
    second = get_model(cfg, device="cpu")
    again, again_opt = _programs_job(cfg, model=second, seed=9)
    assert train.PROGRAMS.hits == 1
    assert _equal_states(_state(res.model), model)
    assert _equal_states(_state(opt), adam)
    assert not _equal_states(_state(second), model)
    first_ptrs = {t.data_ptr() for t in [*res.model.state_dict().values(),
                                         *_optimizer_state(opt)]}
    assert first_ptrs.isdisjoint(
        t.data_ptr() for t in [*second.state_dict().values(),
                               *_optimizer_state(again_opt)])


@pytest.mark.parametrize("fused", [False, True], ids=["per_epoch", "fused"])
@pytest.mark.parametrize("same_model", [True, False],
                         ids=["same_model", "new_model"])
def test_a_hit_leaves_a_kept_state_dict_of_the_first_job_as_it_was(
        same_model, fused):
    """Only the first job's `state_dict()` and Adam's state tensors are
    kept, not copies and, with a new model, not the module: the second
    job, a hit that trains the same model on or a new one, leaves those
    tensors as the first job returned them."""
    cfg = _cfg("float32")
    model = get_model(cfg, device="cpu")
    res, opt = _programs_job(cfg, model=model, fused=fused)
    kept, adam = res.model.state_dict(), list(_optimizer_state(opt))
    want, want_adam = _state(res.model), _state(opt)
    del res, opt
    if not same_model:
        del model
        model = get_model(cfg, device="cpu")
    again, _ = _programs_job(cfg, 3 * X, 3 * XV, model=model, fused=fused,
                             seed=9)
    assert train.PROGRAMS.hits == 1
    assert _equal_states(kept, want)
    assert _equal_states(adam, want_adam)
    assert not _equal_states(_state(again.model), want)


@pytest.mark.parametrize("switch", ["cuda_matmul_tf32", "cudnn_tf32",
                                    "matmul_precision"])
def test_a_job_under_another_float32_math_mode_is_a_miss(built, switch):
    """The TF32 switches and the float32 matmul precision pick the cuBLAS
    and cuDNN kernels a capture records: a job after one of them changed
    captures its own programs, and the next job under the same mode hits
    them."""
    cfg = _cfg("float32")
    _programs_job(cfg)
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    precision = torch.get_float32_matmul_precision()
    try:
        if switch == "cuda_matmul_tf32":
            torch.backends.cuda.matmul.allow_tf32 = not matmul
        elif switch == "cudnn_tf32":
            torch.backends.cudnn.allow_tf32 = not cudnn
        else:
            torch.set_float32_matmul_precision(
                "medium" if precision != "medium" else "highest")
        _programs_job(cfg)
        assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (0, 2)
        _programs_job(cfg)
        assert (train.PROGRAMS.hits, built.captured) == (1, 2)
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def test_a_job_whose_steps_are_watched_runs_its_first_epoch_eagerly(built):
    """An optimizer step hook sees every step of the job, which a replay
    would not call: the job with one registered misses, captures, and its
    programs serve the next job."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    cfg = _cfg("float32")
    _programs_job(cfg)
    steps = []
    handle = register_optimizer_step_post_hook(
        lambda opt, args, kw: steps.append(1))
    try:
        _programs_job(cfg)
    finally:
        handle.remove()
    assert len(steps) == cfg.n_epochs * -(-len(X) // cfg.batch_size)
    assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (0, 2)
    _programs_job(cfg)
    assert (train.PROGRAMS.hits, built.captured) == (1, 2)
