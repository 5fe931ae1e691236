"""The port's VIB (models/vib.py, distribution="normal") against the JAX
package on the CPU, on the same weights (JAX's init, drawn by both from
the seed) and the same keys:

- the deterministic forward (eval, z = mu) within rtol 1e-5;
- the stochastic forward under one key: the noise is `jax.random.normal`'s
  replay, bit-equal for > 99 % of draws and within 4 ulp otherwise
  (tests/test_torch_prng.py), so the k reconstructions agree within rtol
  1e-5;
- one Adam step and a 3-epoch k = 2 training from the seed, each batch's
  noise from JAX's key stream: losses within rtol 1e-3;
- a resumed run given more epochs replays the same noise: bit-equal to the
  uninterrupted one."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icra2021_multimodal_ad_tpu.config import Config as JConfig
from icra2021_multimodal_ad_tpu.models.autoencoder import ae_forward
from icra2021_multimodal_ad_tpu.models.builder import get_model as jget_model
from icra2021_multimodal_ad_tpu.models.vib import (
    reparameterize_normal as jreparameterize_normal,
)
from icra2021_multimodal_ad_tpu.train import (
    NoveltyDetecter as JNoveltyDetecter,
    train_step as jtrain_step,
)
from icra2021_multimodal_ad_tpu_torch.config import Config
from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
from icra2021_multimodal_ad_tpu_torch.models.vib import reparameterize_normal
from icra2021_multimodal_ad_tpu_torch.train import (
    NoveltyDetecter,
    make_optimizer,
    train_step,
)

VIB = dict(input_size=24, btl_size=4, n_layers=3, distribution="normal",
           k=2, seed=3)
TOL = dict(rtol=1e-5, atol=1e-6)


def _x(n=20, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 24)).astype(
        np.float32)


def _pair(**kw):
    fields = {**VIB, **kw}
    jm, params, state = jget_model(JConfig(**fields))
    return jm, params, state, get_model(Config(**fields), device="cpu")


def test_builder_doubles_the_head_and_keeps_the_flags():
    *_, model = _pair(k=3, stochastic_inference=True)
    assert model.encoder.net[-1].layer.out_features == 8
    assert model.decoder.net[0].layer.in_features == 4
    assert model.k == 3 and model.stochastic_inference


def test_deterministic_forward_matches_jax():
    jm, params, state, model = _pair()
    x = _x()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want, _ = ae_forward(jm, params, state, x, train=False)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 7])
def test_reparameterize_draws_jax_noise(seed):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(16, 4)).astype(np.float32)
    sigma = rng.uniform(0.1, 2.0, (16, 4)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jreparameterize_normal(key, mu, sigma, 3, True))
    got = reparameterize_normal(np.asarray(key), torch.from_numpy(mu),
                                torch.from_numpy(sigma), 3, True).numpy()
    assert np.mean(got == want) > 0.98
    np.testing.assert_allclose(got, want, **TOL)
    det = reparameterize_normal(None, torch.from_numpy(mu),
                                torch.from_numpy(sigma), 3, False)
    np.testing.assert_array_equal(det.numpy(), np.broadcast_to(mu, (3, 16, 4)))
    with pytest.raises(ValueError, match="PRNG key"):
        reparameterize_normal(None, torch.from_numpy(mu),
                              torch.from_numpy(sigma), 3, True)


def test_stochastic_forward_under_one_key_matches_jax():
    jm, params, state, model = _pair(k=3, stochastic_inference=True)
    x = _x(seed=1)
    key = jax.random.PRNGKey(42)
    with torch.no_grad():
        samples = model(torch.from_numpy(x), key=np.asarray(key),
                        return_samples=True).numpy()
        mean = model(torch.from_numpy(x), key=np.asarray(key)).numpy()
    want, _ = ae_forward(jm, params, state, x, train=False, rng=key,
                         return_samples=True)
    assert samples.shape == (3, 20, 24)
    np.testing.assert_allclose(samples, np.asarray(want), **TOL)
    want_mean, _ = ae_forward(jm, params, state, x, train=False, rng=key)
    np.testing.assert_allclose(mean, np.asarray(want_mean), **TOL)
    # another key, other samples
    with torch.no_grad():
        other = model(torch.from_numpy(x), key=np.array([0, 43], np.uint32),
                      return_samples=True).numpy()
    assert not np.allclose(other, samples)


def test_train_step_under_one_key_matches_jax():
    jm, params, state, model = _pair()
    jopt = optax.adam(1e-3)
    opt_state = jopt.init(params)
    opt = make_optimizer(model, 1e-3)
    rng = np.random.default_rng(2)
    ours, ref = [], []
    for step in range(4):
        xb = rng.normal(size=(16, 24)).astype(np.float32)
        key = jax.random.PRNGKey(step)
        params, state, opt_state, loss = jtrain_step(
            jm, params, state, opt_state, jnp.asarray(xb), jopt, rng=key)
        ref.append(float(loss))
        ours.append(float(train_step(model, opt, torch.from_numpy(xb),
                                     np.asarray(key))))
    np.testing.assert_allclose(ours, ref, rtol=1e-3)


def _train_cfg(**kw):
    return Config(**{**VIB, **dict(batch_size=16, n_epochs=3, lr=3e-3,
                                   verbose=0)}, **kw)


def test_three_epochs_k2_from_the_seed_track_jax():
    cfg = _train_cfg()
    x, xv = _x(56, seed=4), _x(24, seed=5)
    res = NoveltyDetecter(cfg, device="cpu").train(
        get_model(cfg, device="cpu"), x, xv)
    jcfg = JConfig(**{f: getattr(cfg, f) for f in (
        *VIB, "batch_size", "n_epochs", "lr", "verbose")})
    jm, params, state = jget_model(jcfg)
    ref = JNoveltyDetecter(jcfg).train(jm, params, state, x, xv)
    np.testing.assert_allclose(res.train_history, ref.train_history,
                               rtol=1e-3)
    np.testing.assert_allclose(res.valid_history, ref.valid_history,
                               rtol=1e-3)


def test_resume_with_more_epochs_is_bit_equal(tmp_path):
    """The noise of an epoch depends on (seed, epoch) alone, not on the
    epoch budget (JAX: tests/test_vib_integration.py:207, its uninterrupted
    run per-epoch too)."""
    cfg = _train_cfg()
    x, xv = _x(48, seed=6), _x(16, seed=7)
    full = NoveltyDetecter(cfg.replace(n_epochs=5), device="cpu").train(
        get_model(cfg, device="cpu"), x, xv, fused=False)
    ckpt = str(tmp_path / "mid")
    NoveltyDetecter(cfg.replace(n_epochs=3), device="cpu").train(
        get_model(cfg, device="cpu"), x, xv, checkpoint_path=ckpt,
        checkpoint_every=3)
    resumed = NoveltyDetecter(cfg.replace(n_epochs=5), device="cpu").train(
        get_model(cfg.replace(seed=9), device="cpu"), x, xv,
        checkpoint_path=ckpt, resume=True)
    assert full.train_history == resumed.train_history
    assert full.valid_history == resumed.valid_history
    for (k, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k
