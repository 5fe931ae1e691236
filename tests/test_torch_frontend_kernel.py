"""The tick's front end in one kernel (`ops/frontend_kernel.py`,
`csrc/frontend_fuse.cu`).

On the CPU: which payloads the kernel reads and what `stage` makes of the
rest, that the CPU keeps the stock ops (frames of another size resized),
that the serving request paths never reach the front end's module, and
that the kernel's launch count is one a replay adds to.  On the card
(marked `cuda`; skips without one): the kernel against its plain version,
the stock ops (`normalize_mods` + `fuse` on the card, TF32 off), at the
fusion's tolerance, also on staged payloads; the NaN columns of a constant
mic batch; one launch a captured tick, whose scores are the eager tick's
bit for bit.  On the card,
where JAX is not installed: `python -m pytest --noconftest -q
tests/test_torch_frontend_kernel.py`."""

import numpy as np
import pytest
import torch

from icra2021_multimodal_ad_tpu_torch.config import Config, get_input_size
from icra2021_multimodal_ad_tpu_torch.data import streaming
from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
from icra2021_multimodal_ad_tpu_torch.ops import frontend_kernel, serving
from icra2021_multimodal_ad_tpu_torch.ops.frontend_kernel import (
    frontend_fuse,
    frontend_fuse_plain,
    shapes_fit,
    stage,
)
from icra2021_multimodal_ad_tpu_torch.ops.fusion import fusion_init
from icra2021_multimodal_ad_tpu_torch.utils import graphs

#: the fusion's tolerance (tests/test_torch_fusion.py): the convs sum in
#: another order than cuDNN's
TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(sensor="All", batch_size=10, n_layers=2, btl_size=6, seed=0,
             verbose=0)


def _payloads(b: int, frames=torch.uint8, hw=(32, 32), seed: int = 0,
              device="cpu"):
    """r (B, H, W, 3) HWC and d (B, 1, H, W) in [0, 255], t (B, 1) in
    newtons, m (B, 1, 13) MFCC-like frames."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 256, (b, *hw, 3))
    d = rng.integers(0, 256, (b, 1, *hw))
    if frames == torch.uint8:
        r, d = r.astype(np.uint8), d.astype(np.uint8)
    else:  # fractional pixels, as a resized or filtered frame has
        r = (r + rng.uniform(0, 0.5, r.shape)).astype(np.float32)
        d = (d + rng.uniform(0, 0.5, d.shape)).astype(np.float32)
    t = rng.uniform(0, 400, (b, 1)).astype(np.float32)
    m = rng.normal(-300, 100, (b, 1, 13)).astype(np.float32)
    return tuple(torch.from_numpy(v).to(device) for v in (r, d, t, m))


def test_launch_count_is_replayed():
    assert (frontend_fuse, "launches") in graphs.COUNTERS


def _alter(case: str, r, d, t, m):
    if case == "fp32 frames":
        return r.float(), d.float(), t, m
    if case == "24 x 32 frames":
        return r[:, :24].contiguous(), d[:, :, :24].contiguous(), t, m
    if case == "fp64 force":
        return r, d, t.double(), m
    if case == "CHW camera":
        return r.permute(0, 3, 1, 2).contiguous(), d, t, m
    if case == "strided camera":
        return r.permute(0, 2, 1, 3), d, t, m
    if case == "mic without its channel":
        return r, d, t, m[:, 0]
    if case == "no rows":
        return r[:0], d[:0], t[:0], m[:0]
    return r, d, t, m


#: the cases `stage` cannot bring to what the kernel reads
UNSTAGED = ("CHW camera", "mic without its channel", "no rows")


@pytest.mark.parametrize("case,fits", [
    ("uint8 frames", True), ("fp32 frames", True), ("24 x 32 frames", False),
    ("fp64 force", False), ("CHW camera", False), ("strided camera", False),
    ("mic without its channel", False), ("no rows", False)])
def test_which_payloads_the_kernel_reads(case, fits):
    """The kernel reads 32 x 32 HWC camera frames of uint8 or fp32, fp32
    force and MFCC frames, contiguous, one row or more; `stage` brings
    frames of another size or type, force of another type and strided
    payloads to that, and the wrapper raises on what is left, and on CPU
    tensors whatever their shapes."""
    mods = _alter(case, *_payloads(3))
    assert shapes_fit(*mods) is fits
    assert shapes_fit(*stage(*mods)) is (case not in UNSTAGED)
    with pytest.raises(ValueError):
        frontend_fuse(fusion_init(3, device="cpu"), *mods)


@pytest.mark.parametrize("case", ["uint8 frames", "fp32 frames",
                                  "24 x 32 frames", "fp64 force",
                                  "strided camera"])
def test_staging_keeps_the_plain_result(case):
    """What the card's kernel is given is what the stock ops read, in their
    order: cast, resize, then the normalization."""
    p = fusion_init(3, device="cpu")
    mods = _alter(case, *_payloads(4, seed=6))
    torch.testing.assert_close(frontend_fuse_plain(p, *stage(*mods)),
                               frontend_fuse_plain(p, *mods).float(), **TOL)


def test_frames_of_another_size_take_the_resize_path():
    """24 x 32 frames (the HSR's) fuse through the stock ops on the CPU,
    resized."""
    p = fusion_init(3, device="cpu")
    r, d, t, m = _payloads(4, hw=(24, 32), seed=5)
    x = streaming._normalize_and_fuse(p, r, d, t, m)
    assert x.shape == (4, 1728) and torch.isfinite(x).all()
    torch.testing.assert_close(x, frontend_fuse_plain(p, r, d, t, m),
                               rtol=0, atol=0)


@pytest.fixture
def spy(monkeypatch):
    """frontend_fuse replaced by a recorder that computes the plain
    version."""
    calls = []

    def fake(params, r, d, t, m):
        calls.append(r.shape[0])
        return frontend_fuse_plain(params, r, d, t, m)

    monkeypatch.setattr(frontend_kernel, "frontend_fuse", fake)
    return calls


def _bundle():
    cfg = Config(**SMALL)
    cfg = cfg.replace(input_size=get_input_size(cfg))
    model = get_model(cfg, device="cpu")
    p = fusion_init(cfg.seed, device="cpu")
    return cfg, model, p, serving.make_serving(cfg, model, fusion_params=p,
                                               device="cpu")


def test_the_cpu_takes_the_plain_path(spy):
    cfg, _, p, _ = _bundle()
    r, d, t, m = _payloads(10, seed=2)
    x = streaming.hsr_window_batch(
        cfg, p, list(t[:, 0].tolist()), list(r.numpy()),
        list(d[:, 0].numpy()), m[:, 0])
    assert spy == []
    torch.testing.assert_close(x, frontend_fuse_plain(p, r, d, t, m),
                               rtol=0, atol=0)


@pytest.mark.parametrize("path", ["hsr_window_batch", "fuse_sensor",
                                  "score_sensor"])
def test_only_the_tick_frontend_reaches_the_kernel(spy, monkeypatch, path):
    """The realtime frontend goes through the front end's module once a
    batch (the kernel on the card, its plain version here), and the
    serving request paths, which fuse in the bundle's compute dtype, never
    do."""
    plain = []

    def fake_plain(params, r, d, t, m):
        plain.append(r.shape[0])
        return frontend_fuse_plain(params, r, d, t, m)

    monkeypatch.setattr(frontend_kernel, "frontend_fuse_plain", fake_plain)
    cfg, _, p, bundle = _bundle()
    r, d, t, m = _payloads(10, seed=4)
    if path == "hsr_window_batch":
        streaming.hsr_window_batch(
            cfg, p, list(t[:, 0].tolist()), list(r.numpy()),
            list(d[:, 0].numpy()), m[:, 0])
        assert (spy, plain) == ([], [10])
        return
    chw = r.permute(0, 3, 1, 2).contiguous()
    out = getattr(bundle, path)(chw, d, t, m)
    assert torch.isfinite(out).all()
    assert (spy, plain) == ([], [])


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: frontend_fuse is CUDA code with "
                    "no CPU path (its plain version is the stock ops)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b", [1, 10, 33])
def test_kernel_matches_the_stock_ops_on_the_card(card, b, frames):
    assert not torch.backends.cudnn.allow_tf32
    p = fusion_init(11, device=card)
    mods = _payloads(b, frames, seed=b, device=card)
    got = frontend_fuse(p, *mods)
    want = frontend_fuse_plain(p, *mods)
    torch.testing.assert_close(got, want, **TOL)
    # every launch gives the same bits
    assert torch.equal(frontend_fuse(p, *mods), got)


@pytest.mark.cuda
def test_a_constant_mic_batch_gives_nan_columns_on_the_card(card):
    """hi - lo = 0: the mic normalizes to 0 / 0, and its columns are NaN
    through the ReLUs, as the stock path's; the rest stays finite."""
    p = fusion_init(11, device=card)
    r, d, t, m = _payloads(10, seed=1, device=card)
    m = torch.full_like(m, -42.0)
    got = frontend_fuse(p, r, d, t, m)
    want = frontend_fuse_plain(p, r, d, t, m)
    assert got[:, 1600:].isnan().all() and want[:, 1600:].isnan().all()
    assert torch.isfinite(got[:, :1600]).all()
    torch.testing.assert_close(got, want, equal_nan=True, **TOL)


@pytest.mark.cuda
def test_a_captured_tick_launches_the_kernel_once(card):
    """A BASE tick of the robot's detector (two graph replays): exactly
    one kernel launch a tick, by the replayed count, and the eager tick's
    scores bit for bit."""
    cfg = Config(**SMALL)
    cfg = cfg.replace(input_size=get_input_size(cfg))
    det = streaming.StreamingDetector(cfg, get_model(cfg, device=card),
                                      fusion_init(cfg.seed, device=card),
                                      device=card)
    src = streaming.SimulatedSensors(batch_size=10, seed=3)
    src.fill(12, anomaly_after=9)
    for i in range(4):
        src.tick(anomaly=i == 2)
        snap = (src.force_q.snapshot(), src.hand_q.snapshot(),
                src.depth_q.snapshot(), src.mic_q.snapshot())
        before = frontend_fuse.launches
        scores = det.score_rings(*snap)
        if i:  # the first tick captures its programs
            assert frontend_fuse.launches - before == 1
        np.testing.assert_array_equal(scores, det.score_rings_eager(*snap))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["24 x 32 frames", "fp64 force",
                                  "strided camera"])
def test_the_card_stages_what_the_kernel_reads(card, case):
    """On the card every window batch is one launch: payloads in another
    form are staged for it, and fuse as the stock ops fuse the originals."""
    p = fusion_init(11, device=card)
    mods = _alter(case, *_payloads(10, seed=7, device=card))
    before = frontend_fuse.launches
    got = streaming._normalize_and_fuse(p, *mods)
    assert frontend_fuse.launches - before == 1
    torch.testing.assert_close(got, frontend_fuse_plain(p, *mods).float(),
                               **TOL)
    with pytest.raises(ValueError):
        streaming._normalize_and_fuse(p, *_alter("mic without its channel",
                                                 *mods))
