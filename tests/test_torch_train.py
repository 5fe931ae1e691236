"""The port's trainer and reports against the JAX package's, fp32 on the CPU.

Both sides start from the same weights (JAX's, converted by the port's
torch_compat) and fresh Adam states, and take the same batches, drawn with
numpy from a seed.  The epoch tests feed JAX's permutation to both; the
port's own draw of it (utils/jax_prng.py) is held to JAX's in
tests/test_torch_prng.py, and a whole run from a seed alone in
tests/test_torch_vib.py and tests/test_torch_bf16_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icra2021_multimodal_ad_tpu.config import Config as JConfig
from icra2021_multimodal_ad_tpu.models.builder import get_model as jget_model
from icra2021_multimodal_ad_tpu.train import (
    NoveltyDetecter as JNoveltyDetecter,
    eval_epoch as jeval_epoch,
    eval_step as jeval_step,
    report_dataframe as jreport_dataframe,
    train_epoch as jtrain_epoch,
    train_step as jtrain_step,
)
from icra2021_multimodal_ad_tpu_torch.config import Config
from icra2021_multimodal_ad_tpu_torch.models.builder import (
    build_autoencoder,
    get_model,
    load_model,
)
from icra2021_multimodal_ad_tpu_torch.novelty_detection import run
from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
    get_d_norm_loss,
    load_nap_stats,
)
from icra2021_multimodal_ad_tpu_torch.train import (
    NoveltyDetecter,
    binarize_labels,
    eval_epoch,
    eval_step,
    make_optimizer,
    report_dataframe,
    train_epoch,
    train_step,
    write_report_csv,
)
from icra2021_multimodal_ad_tpu_torch.utils.torch_compat import (
    from_jax_pytrees,
    to_jax_pytrees,
)

SMALL = dict(input_size=20, btl_size=4, n_layers=2, seed=0)


def _pair(**kw):
    """A JAX model and its port twin on the same weights."""
    fields = {**SMALL, **kw}
    jm, params, state = jget_model(JConfig(**fields))
    model = build_autoencoder(Config(**fields)).to_empty(device="cpu")
    from_jax_pytrees(params, state, model)
    return jm, params, state, model


def _rows(n, d=20, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_train_step_and_eval_step_match_jax():
    jm, params, state, model = _pair()
    jopt = optax.adam(1e-3)
    opt_state = jopt.init(params)
    opt = make_optimizer(model, 1e-3)
    rng = np.random.default_rng(0)
    ours, ref = [], []
    for _ in range(5):
        xb = rng.normal(size=(32, 20)).astype(np.float32)
        params, state, opt_state, loss = jtrain_step(
            jm, params, state, opt_state, jnp.asarray(xb), jopt)
        ref.append(float(loss))
        ours.append(float(train_step(model, opt, torch.from_numpy(xb))))
    # the tolerances of tests/test_train_parity.py:70,79
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    xb = rng.normal(size=(16, 20)).astype(np.float32)
    ref_eval = float(jeval_step(jm, params, state, jnp.asarray(xb)))
    assert float(eval_step(model, torch.from_numpy(xb))) == pytest.approx(
        ref_eval, rel=5e-3)


def test_train_and_eval_epoch_match_jax():
    jm, params, state, model = _pair()
    jopt = optax.adam(3e-3)
    opt_state = jopt.init(params)
    opt = make_optimizer(model, 3e-3)
    train_x, valid_x = _rows(100, seed=1), _rows(40, seed=2)
    key = jax.random.PRNGKey(1)
    for epoch in range(2):
        perm = np.array(jax.random.permutation(
            jax.random.fold_in(key, epoch), 100))
        params, state, opt_state, jtotal = jtrain_epoch(
            jm, params, state, opt_state, jnp.asarray(train_x),
            jnp.asarray(perm), jopt, 32)  # 3 full batches and a tail of 4
        total = train_epoch(model, opt, torch.from_numpy(train_x),
                            torch.from_numpy(perm), 32)
        assert float(total) == pytest.approx(float(jtotal), rel=2e-3)
        jv = float(jeval_epoch(jm, params, state, jnp.asarray(valid_x), 32))
        v = float(eval_epoch(model, torch.from_numpy(valid_x), 32))
        assert v == pytest.approx(jv, rel=5e-3)


def test_one_row_tail_batch_is_refused():
    *_, model = _pair()
    opt = make_optimizer(model, 1e-3)
    with pytest.raises(ValueError, match="1-row tail"):
        train_epoch(model, opt, torch.from_numpy(_rows(33)),
                    torch.arange(33), 16)


def _small_cfg(**kw):
    base = dict(input_size=12, btl_size=3, n_layers=2, batch_size=16,
                n_epochs=6, lr=1e-2, verbose=0, seed=1)
    base.update(kw)
    return Config(**base)


def test_best_model_restores_lowest_valid():
    """Best-model restore (novelty_detection.py:108-125): the returned model
    reproduces the minimum of the valid history, as
    tests/test_train_parity.py:82 checks for JAX."""
    cfg = _small_cfg()
    model = get_model(cfg, device="cpu")
    train_x, valid_x = _rows(64, 12, seed=1), _rows(32, 12, seed=2)
    res = NoveltyDetecter(cfg, device="cpu").train(model, train_x, valid_x)
    assert len(res.valid_history) == len(res.train_ms) == 6
    restored = float(eval_epoch(res.model, torch.from_numpy(valid_x), 16))
    assert restored / 32 == pytest.approx(min(res.valid_history), rel=1e-5)
    assert not res.model.training


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """Interrupt at epoch 3 of 6 and resume from the mid-run checkpoint:
    histories and best weights equal the uninterrupted run exactly
    (tests/test_train_parity.py:131 for JAX, whose uninterrupted run is
    per-epoch too, the checkpointing path's mode)."""
    cfg = _small_cfg(batch_size=20, lr=3e-3, seed=0)
    x, xv = _rows(64, 12, seed=0), _rows(20, 12, seed=3)
    full = NoveltyDetecter(cfg.replace(n_epochs=6), device="cpu").train(
        get_model(cfg, device="cpu"), x, xv, fused=False)
    ckpt = str(tmp_path / "mid")
    NoveltyDetecter(cfg.replace(n_epochs=3), device="cpu").train(
        get_model(cfg, device="cpu"), x, xv, checkpoint_path=ckpt,
        checkpoint_every=3)
    resumed = NoveltyDetecter(cfg.replace(n_epochs=6), device="cpu").train(
        get_model(cfg.replace(seed=5), device="cpu"), x, xv,
        checkpoint_path=ckpt, resume=True)
    assert full.valid_history == resumed.valid_history
    assert full.train_history == resumed.train_history
    for (k, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k


def test_orbax_checkpoint_path_is_refused(tmp_path):
    cfg = _small_cfg(n_epochs=2)
    with pytest.raises(ValueError, match="Orbax"):
        NoveltyDetecter(cfg, device="cpu").train(
            get_model(cfg, device="cpu"), _rows(32, 12), _rows(16, 12),
            checkpoint_path=str(tmp_path / "orbax") + "/",
            checkpoint_every=1)


@pytest.mark.parametrize("kw", [dict(train_dtype="bfloat16"),
                                dict(distribution="normal", k=2)])
def test_unported_training_options_raise(kw):
    """The options once refused now train, from the seed alone, to JAX's
    per-epoch losses (bf16 at the tolerance of
    tests/test_torch_bf16_train.py, VIB at fp32's)."""
    cfg = _small_cfg(n_epochs=3, **kw)
    x, xv = _rows(64, 12, seed=1), _rows(32, 12, seed=2)
    res = NoveltyDetecter(cfg, device="cpu").train(
        get_model(cfg, device="cpu"), x, xv)
    jcfg = JConfig(**{f: getattr(cfg, f) for f in (
        "input_size", "btl_size", "n_layers", "batch_size", "n_epochs", "lr",
        "verbose", "seed", "train_dtype", "distribution", "k")})
    jm, params, state = jget_model(jcfg)
    ref = JNoveltyDetecter(jcfg).train(jm, params, state, x, xv)
    rtol = 2e-2 if cfg.train_dtype == "bfloat16" else 2e-3
    np.testing.assert_allclose(res.train_history, ref.train_history,
                               rtol=rtol)
    np.testing.assert_allclose(res.valid_history, ref.valid_history,
                               rtol=rtol)


def _windows(n, rng, mix, anomalous=0):
    """Low-rank normal windows; `anomalous` rows get a shifted block."""
    x = rng.normal(size=(n, 6)) @ mix + 0.05 * rng.normal(size=(n, 24))
    x[n - anomalous:, :8] += rng.uniform(0.3, 1.5, (anomalous, 1))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def trained():
    """A port model trained on the CPU, its JAX twin, and the windows.
    end_layer_index=1 leaves out the bottleneck's diff, an exact linear map
    of the layer before it, so the NAP fit has no null direction and 600
    rows against 51 diff dims keep it well conditioned."""
    fields = dict(input_size=24, btl_size=4, n_layers=3, batch_size=128,
                  n_epochs=5, lr=3e-3, verbose=0, seed=3, end_layer_index=1)
    rng = np.random.default_rng(3)
    mix = rng.normal(size=(6, 24)) * 0.4
    data = dict(train_x=_windows(600, rng, mix),
                valid_x=_windows(200, rng, mix),
                test_x=_windows(200, rng, mix, anomalous=100),
                test_y=np.r_[np.zeros(100), np.ones(100)])
    cfg = Config(**fields)
    model = get_model(cfg, device="cpu")
    NoveltyDetecter(cfg, device="cpu").train(model, data["train_x"],
                                             data["valid_x"])
    jm, _, _ = jget_model(JConfig(**fields))
    params, state = to_jax_pytrees(model)
    return cfg, JConfig(**fields), model, jm, params, state, data


def test_novelty_detecter_test_matches_jax(trained):
    cfg, jcfg, model, jm, params, state, data = trained
    ours = NoveltyDetecter(cfg, device="cpu").test(
        model, **data, save_stats_path=False)
    ref = JNoveltyDetecter(jcfg).test(jm, params, state, **data,
                                      save_stats_path=False)
    for name, a, b in zip(("base", "sap", "nap"), ours, ref):
        # whitening amplifies the last bits: NAP at the kernels' 1e-3
        rtol = 1e-3 if name == "nap" else 1e-5
        np.testing.assert_allclose(a.score, np.asarray(b.score), rtol=rtol,
                                   err_msg=name)
        assert a.auroc == pytest.approx(b.auroc, abs=1e-6), name
        assert a.aupr == pytest.approx(b.aupr, abs=1e-6), name
        for f in ("f1", "precision", "recall"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), abs=1e-6), (
                name, f)
    assert ours[2].auroc > 0.9  # the planted anomaly is found


def test_report_csv_matches_jax_dataframe(trained, tmp_path):
    cfg, *_, model, _, _, _, data = trained
    reports = NoveltyDetecter(cfg, device="cpu").test(
        model, **data, save_stats_path=False)
    rows = report_dataframe(*reports)
    df = jreport_dataframe(*reports)
    assert list(rows[0]) == list(df.columns)
    ours = write_report_csv(str(tmp_path / "port.csv"), rows)
    df.to_csv(tmp_path / "jax.csv")
    with open(ours) as a, open(tmp_path / "jax.csv") as b:
        assert a.read() == b.read()


def test_run_trains_saves_and_reports(tmp_path):
    rng = np.random.default_rng(4)
    mix = rng.normal(size=(6, 24)) * 0.4
    cfg = Config(input_size=24, btl_size=4, n_layers=2, batch_size=64,
                 n_epochs=3, verbose=0, seed=4,
                 saved_name=str(tmp_path / "model"),
                 train_diffs=str(tmp_path / "stats.npz"),
                 data=str(tmp_path), saved_result="run")
    res = run(cfg, _windows(200, rng, mix), _windows(64, rng, mix),
              _windows(80, rng, mix, anomalous=40),
              np.r_[np.zeros(40), np.ones(40)], device="cpu")
    assert res.csv_path == str(tmp_path / "result_csv" / "run.csv")
    with open(res.csv_path) as f:
        assert f.readline().startswith(",base_auroc,sap_auroc,nap_auroc")
    _, loaded = load_model(str(tmp_path / "model"), device="cpu")
    for a, b in zip(loaded.state_dict().values(),
                    res.train.model.state_dict().values()):
        if a.is_floating_point():
            assert torch.equal(a, b)
    assert load_nap_stats(cfg.train_diffs).rotater.v.shape[0] > 0
    assert all(np.isfinite(r.score).all()
               for r in (res.base, res.sap, res.nap))


@pytest.mark.parametrize("norm_type", [1, 3])
def test_nap_report_refuses_other_norms(norm_type):
    diffs = [torch.from_numpy(_rows(16, 6))]
    with pytest.raises(NotImplementedError, match="norm_type"):
        get_d_norm_loss(diffs, diffs, diffs, np.r_[np.zeros(8), np.ones(8)],
                        norm_type=norm_type, save_stats_path=False)


def test_binarize_labels_matches_reference_rules():
    y = np.array([0, 1, 1, 0])
    cfg = Config(target_class="1")
    assert binarize_labels(cfg, y).tolist() == [False, True, True, False]
    inv = binarize_labels(cfg.replace(unimodal_normal=True), y)
    assert inv.tolist() == [True, False, False, True]
