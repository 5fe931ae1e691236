"""On the card: the trainer's kept epoch programs (`train.PROGRAMS`), whose
CUDA graphs are captured and replayed only there.  A hit job, every epoch a
replay of graphs an earlier job captured, trains as a job on an empty
cache does, bit for bit; thirty jobs of one shape in one process capture
once and all finish.  Skips where there is no card.  On the card, where
JAX is not installed: `python -m pytest --noconftest -q
tests/test_torch_program_cache_card.py`."""

import numpy as np
import pytest
import torch

from icra2021_multimodal_ad_tpu_torch import train
from icra2021_multimodal_ad_tpu_torch.config import Config
from icra2021_multimodal_ad_tpu_torch.models.builder import get_model

#: 600 train rows at batch 64: nine full batches and a tail of 24
FIELDS = dict(input_size=64, btl_size=8, n_layers=2, batch_size=64,
              n_epochs=4, lr=1e-2, verbose=0, seed=1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the epoch programs are CUDA "
                    "graphs, captured and replayed only there")
    train.PROGRAMS.clear()  # each test from an empty cache
    return torch.device("cuda")


def _rows(n, seed, device):
    rng = np.random.default_rng(seed)
    mix = np.random.default_rng(99).normal(size=(8, 64)) * 0.5
    x = rng.normal(size=(n, 8)) @ mix + 0.1 * rng.normal(size=(n, 64))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _job(cfg, x, xv, device, model=None, fused=False, seed=None):
    model = model or get_model(cfg, device=device)
    opt = train.make_optimizer(model, cfg.lr)
    res = train.train_all_epochs(model, opt, x, xv,
                                 cfg.seed if seed is None else seed,
                                 cfg.batch_size, cfg.n_epochs, fused=fused)
    torch.cuda.synchronize()
    state = {k: v.clone() for k, v in res.model.state_dict().items()}
    adam = [t.clone() for st in opt.state.values()
            for t in (st["step"], st["exp_avg"], st["exp_avg_sq"])]
    return res, state, adam


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["per_epoch", "fused"])
def test_a_hit_on_the_card_is_bit_identical_to_a_fresh_job(card, fused):
    """A new model trained on other windows and another seed by replaying
    the kept graphs from its first epoch: the histories, the returned
    weights and BN buffers, Adam's state and one `train_ms` an epoch, as
    the same job on an empty cache gives them; the first job's
    `state_dict()`, still held, keeps what that job returned."""
    cfg = Config(**FIELDS)
    first, first_state, _ = _job(cfg, _rows(600, 1, card),
                                 _rows(200, 2, card), card, fused=fused)
    kept = first.model.state_dict()
    x, xv = _rows(600, 3, card), _rows(200, 4, card)
    hit, hit_state, hit_adam = _job(cfg, x, xv, card, fused=fused, seed=5)
    assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (1, 1)
    torch.cuda.synchronize()
    assert all(torch.equal(kept[k], first_state[k]) for k in first_state)
    train.PROGRAMS.clear()
    fresh, state, adam = _job(cfg, x, xv, card, fused=fused, seed=5)
    assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (0, 1)
    assert hit.train_history == fresh.train_history
    assert hit.valid_history == fresh.valid_history
    assert all(torch.equal(hit_state[k], state[k]) for k in state)
    assert len(hit_adam) == len(adam)
    assert all(torch.equal(a, b) for a, b in zip(hit_adam, adam))
    assert len(hit.train_ms) == len(hit.eval_ms) == cfg.n_epochs
    assert all(np.isfinite(hit.train_history + hit.valid_history))


@pytest.mark.cuda
def test_thirty_same_shape_jobs_capture_once_and_all_finish(card,
                                                           monkeypatch):
    """Jobs back to back from the seeded initial weights, as a sweep over
    seeds or the benchmark's training cell runs them, per-epoch with the
    progress lines: one capture, then twenty-nine hits, each job's
    histories finite."""
    captures = []
    capture = train.EpochPrograms.capture

    def counted(self):
        captures.append(1)
        capture(self)

    monkeypatch.setattr(train.EpochPrograms, "capture", counted)
    cfg = Config(**{**FIELDS, "verbose": 1})
    x, xv = _rows(600, 1, card), _rows(200, 2, card)
    det = train.NoveltyDetecter(cfg, device=card)
    model = get_model(cfg, device=card)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(30):
        model.load_state_dict(start)
        res = det.train(model, x, xv)
        assert np.isfinite(res.train_history + res.valid_history).all()
    torch.cuda.synchronize()
    assert len(captures) == 1
    assert (train.PROGRAMS.hits, train.PROGRAMS.misses) == (29, 1)
