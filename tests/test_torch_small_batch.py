"""The small-batch variants of the port's two kernels: the whole-module FC
launch and the one-launch NAP score (variant 4 of each), on the CPU.

The routing (`variant_for`, `module_forward_taps`) and the module launch's
layer table are checked here against the module; the arithmetic the card
runs is the plain version's, held against the JAX package's functions at
the batches around `SMALL_MAX_B`.  The kernels themselves are held against
variant 0 bit for bit by the CUDA-marked test at the end (and by
chip_smoke.py's small-batch phase on the card)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra2021_multimodal_ad_tpu.config import Config as JConfig
from icra2021_multimodal_ad_tpu.models.builder import get_model as jget_model
from icra2021_multimodal_ad_tpu.models.fc_module import (
    fc_module_apply_taps as jfc_module_apply_taps,
)
from icra2021_multimodal_ad_tpu.ops.normalize import (
    RotaterStats as JRotaterStats,
)
from icra2021_multimodal_ad_tpu.ops.normalize import (
    StandardizerStats as JStandardizerStats,
)
from icra2021_multimodal_ad_tpu.ops.pallas_kernels import (
    nap_score_pallas as jnap_score_pallas,
)
from icra2021_multimodal_ad_tpu.ops.scoring import NapStats as JNapStats
from icra2021_multimodal_ad_tpu_torch.config import Config
from icra2021_multimodal_ad_tpu_torch.models.builder import build_autoencoder
from icra2021_multimodal_ad_tpu_torch.ops import mlp_kernel, nap_kernel
from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
    fused_mlp_layer_pair,
    fused_mlp_module,
    mlp_pack,
    module_forward_taps,
    module_table,
)
from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
    nap_pack,
    nap_score,
)
from icra2021_multimodal_ad_tpu_torch.ops.normalize import (
    RotaterStats,
    StandardizerStats,
)
from icra2021_multimodal_ad_tpu_torch.ops.scoring import NapStats
from icra2021_multimodal_ad_tpu_torch.utils.torch_compat import (
    from_jax_pytrees,
)

SMALL = dict(sensor="All", n_layers=3, btl_size=8, input_size=48, seed=0)
#: both sides of SMALL_MAX_B, and the tick's batch
BATCHES = (1, 10, 64, 65)
#: the plain fp32 version against JAX's fp32 module (other summation order)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def models():
    """A small JAX model with random BN statistics and its port twin."""
    jm, params, state = jget_model(JConfig(**SMALL))
    rng = np.random.default_rng(3)
    for side in params:
        for p, s in zip(params[side], state[side]):
            if "bn_scale" in p:
                n = p["bn_scale"].shape[0]
                p["bn_scale"] = jnp.asarray(rng.uniform(0.5, 1.5, n),
                                            jnp.float32)
                p["bn_bias"] = jnp.asarray(rng.normal(0, 0.1, n), jnp.float32)
                s["bn_mean"] = jnp.asarray(rng.normal(0, 0.1, n), jnp.float32)
                s["bn_var"] = jnp.asarray(rng.uniform(0.5, 2, n), jnp.float32)
    model = build_autoencoder(Config(**SMALL)).to_empty(device="cpu")
    from_jax_pytrees(params, state, model)
    return jm, params, state, model.eval()


def _x(b, d, seed):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def _stats(k, j, seed, floored):
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.5, 2.0, j).astype(np.float32)
    if floored:
        var[::7] = np.inf
    mu = rng.normal(size=k).astype(np.float32)
    v = (rng.normal(size=(k, j)) / np.sqrt(k)).astype(np.float32)
    std_mu = rng.normal(size=j).astype(np.float32)
    t = torch.from_numpy
    return ((mu, v, std_mu, var),
            NapStats(RotaterStats(t(mu), t(v)),
                     StandardizerStats(t(std_mu), t(var))))


@pytest.mark.parametrize("module", [mlp_kernel, nap_kernel],
                         ids=["fused_mlp", "nap_score"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variant_for_routes_small_batches(module, dtype):
    """An fp32 NAP score or a whole fp32 FC module takes variant 4 up to
    SMALL_MAX_B and the 64 x 64 variant from the next row; bf16 keeps its
    64 x 64 variant on both sides, and a single FC layer on its own keeps
    it in both types."""
    narrow = module.VARIANTS[(dtype, False)]
    edge = module.SMALL_MAX_B
    assert 1 <= edge <= module.KERNEL_MAX_B  # the most rows the kernels take
    route = ((lambda b: module.variant_for(dtype, b, module=True))
             if module is mlp_kernel else
             (lambda b: module.variant_for(dtype, b)))
    if dtype == torch.float32:
        assert (route(edge), route(edge + 1)) == (module.SMALL_VARIANT,
                                                  narrow)
        assert module.SMALL_VARIANT not in module.VARIANTS.values()
    else:
        assert (route(edge), route(edge + 1)) == (narrow, narrow)
    if module is mlp_kernel:
        assert [module.variant_for(dtype, b) for b in (1, edge)] == [
            narrow, narrow]


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_layer_table_matches_the_module(models, side):
    """The module launch's table: one entry per layer in order, each with
    the pack's pointers, K, N, the weights' padded stride, the activation
    and BN flags, and outputs laid out one after another in rows padded to
    16 bytes."""
    *_, model = models
    module = getattr(model, side)
    pack = mlp_pack(module)
    table = pack.table
    assert table is not None and table.layers is pack.layers
    assert len(table.entries) == len(module.net) == len(pack.layers)
    offset = 0
    for e, fc, layer, off, ld in zip(table.entries, module.net, pack.layers,
                                     table.offsets, table.ldo):
        n, k = fc.layer.out_features, fc.layer.in_features
        assert (e.K, e.N) == (k, n)
        assert e.ldw == layer.w.stride(0) and e.ldw % 4 == 0 and e.ldw >= k
        assert e.w == layer.w.data_ptr() and e.bias == layer.b.data_ptr()
        assert e.leaky == int(fc.act == "leakyrelu")
        if fc.bn is None:
            assert not any((e.bn_mean, e.bn_std, e.bn_weight, e.bn_beta))
        else:
            assert (e.bn_mean, e.bn_std, e.bn_weight, e.bn_beta) == tuple(
                t.data_ptr() for t in (layer.bn_mean, layer.bn_std,
                                       layer.bn_weight, layer.bn_beta))
        assert e.ldo == ld == -(-n // 4) * 4
        assert e.out_offset == off == offset
        offset += ld
    assert table.row_floats == offset
    # a bf16 pack has no table: it keeps its per-layer variants
    assert mlp_pack(module, torch.bfloat16).table is None


def test_table_follows_replaced_layers(models):
    """A pack whose layers were replaced builds the table of its own
    layers, never the stale one."""
    *_, model = models
    pack = mlp_pack(model.encoder)
    dense = pack._replace(layers=tuple(
        lp._replace(w=lp.w.contiguous()) for lp in pack.layers))
    assert dense.table.layers is not dense.layers
    fresh = module_table(dense.layers)
    assert [e.w for e in fresh.entries] == [lp.w.data_ptr()
                                            for lp in dense.layers]


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_module_taps_match_jax_around_small_max_b(models, side, b):
    """Every tap of `module_forward_taps` on the CPU (the plain version the
    card's module launch must equal) against JAX's fc_module_apply_taps."""
    jm, params, state, model = models
    module = getattr(model, side)
    x = _x(b, module.net[0].layer.in_features, seed=b)
    taps, stream = module_forward_taps(mlp_pack(module), torch.from_numpy(x))
    jtaps, _ = jfc_module_apply_taps(getattr(jm, side), params[side],
                                     state[side], jnp.asarray(x))
    assert len(taps) == len(jtaps)
    for got, want in zip(taps, jtaps):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert torch.equal(stream, taps[-1])


@pytest.mark.parametrize("floored", [False, True])
@pytest.mark.parametrize("b", BATCHES)
def test_nap_score_matches_jax_around_small_max_b(b, floored):
    """The NAP wrapper on the CPU against JAX's Pallas kernel as the JAX
    package's CPU tests run it, on floored and un-floored stats."""
    (mu, v, std_mu, var), stats = _stats(70, 45, seed=b, floored=floored)
    x = _x(b, 70, seed=100 + b)
    got = nap_score(nap_pack(stats), torch.from_numpy(x)).numpy()
    jstats = JNapStats(JRotaterStats(jnp.asarray(mu), jnp.asarray(v)),
                       JStandardizerStats(jnp.asarray(std_mu),
                                          jnp.asarray(var)))
    want = np.asarray(jnap_score_pallas(jstats, jnp.asarray(x), tb=16,
                                        tj=128))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_module_launch_refuses_what_the_kernel_does_not_take(models):
    """The module launch runs on CUDA tensors only, fp32 packs only, and
    1 to SMALL_MAX_B rows: a CPU tensor is refused, not sent to the plain
    version behind the caller's back."""
    *_, model = models
    pack = mlp_pack(model.encoder)
    x = torch.from_numpy(_x(4, 48, seed=1))
    with pytest.raises(ValueError, match="cuda"):
        fused_mlp_module(pack, x)
    with pytest.raises(ValueError, match="fp32"):
        fused_mlp_module(mlp_pack(model.encoder, torch.bfloat16), x)
    with pytest.raises(ValueError, match="1 to"):
        fused_mlp_module(pack, torch.zeros(0, 48))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, j", [
    ("fused_mlp_module", None),
    # the split-K path, one round with idle blocks (the hand camera's
    # tick), one round nearly full, and the robot's tick
    ("nap_score", 400), ("nap_score", 3370), ("nap_score", 4096),
    ("nap_score", 5482)], ids=["fused_mlp_module", "nap_score-J400",
                               "nap_score-J3370", "nap_score-J4096",
                               "nap_score-J5482"])
def test_small_variants_equal_variant_0_on_the_card(models, kernel, j):
    """On the card, each small-batch variant against variant 0 with
    torch.equal at B in (1, 10, 33, 64); the NAP score at K = 5482 and
    each J of the parametrization."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: variant 4 is CUDA code with no "
                    "CPU path (chip_smoke.py runs this check on the card)")
    *_, model = models
    for b in (1, 10, 33, 64):
        if kernel == "nap_score":
            _, stats = _stats(5482, j, seed=b, floored=b % 2 == 1)
            pack = nap_pack(stats.to("cuda"))
            x = torch.from_numpy(_x(b, 5482, seed=b)).cuda()
            assert torch.equal(nap_score(pack, x, 4), nap_score(pack, x, 0))
            continue
        for side in ("encoder", "decoder"):
            pack = mlp_pack(copy.deepcopy(getattr(model, side)).cuda())
            x = torch.from_numpy(_x(b, pack.layers[0].w.shape[1],
                                    seed=b)).cuda()
            ref = module_forward_taps(
                pack, x, lambda layer, h: fused_mlp_layer_pair(layer, h, 0))[0]
            for got, want in zip(fused_mlp_module(pack, x), ref):
                assert torch.equal(got, want)


@pytest.mark.cuda
def test_tick_shape_launch_counts_as_balanced_on_the_card():
    """On the card, one variant-4 launch at the robot's tick shape (B = 10,
    K = J = 5482) adds 1 to both `small_launches` and `balanced_launches`:
    its partition gives no block more than `BALANCED` times the mean
    block's share of V^T."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: variant 4 is CUDA code with no "
                    "CPU path")
    _, stats = _stats(5482, 5482, seed=3, floored=False)
    pack = nap_pack(stats.to("cuda"))
    x = torch.from_numpy(_x(10, 5482, seed=3)).cuda()
    before = nap_score.small_launches, nap_score.balanced_launches
    nap_score(pack, x)
    assert (nap_score.small_launches - before[0],
            nap_score.balanced_launches - before[1]) == (1, 1)
