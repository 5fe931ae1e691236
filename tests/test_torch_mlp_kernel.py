"""The port's fused FC-module forward against the JAX package's on the CPU.

The JAX Pallas kernel runs in interpret mode, as tests/test_pallas_kernels.py
runs it; the port's wrapper takes its plain version for CPU tensors.  The
CUDA kernel faces that plain version on the card in chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra2021_multimodal_ad_tpu.config import Config as JConfig
from icra2021_multimodal_ad_tpu.models.builder import get_model as jget_model
from icra2021_multimodal_ad_tpu.ops.pallas_kernels import (
    fused_module_forward as jfused_module_forward,
    pack_module_layers as jpack_module_layers,
)
from icra2021_multimodal_ad_tpu.ops.serving import cast_floats as jcast_floats
from icra2021_multimodal_ad_tpu_torch.config import Config
from icra2021_multimodal_ad_tpu_torch.models.builder import build_autoencoder
from icra2021_multimodal_ad_tpu_torch.models.fc_module import FCModule
from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
    fused_mlp_layer,
    fused_mlp_layer_plain,
    fused_module_forward,
    mlp_pack,
    module_forward_taps,
)
from icra2021_multimodal_ad_tpu_torch.ops.serving import cast_floats
from icra2021_multimodal_ad_tpu_torch.utils.torch_compat import (
    from_jax_pytrees,
)

SMALL = dict(sensor="All", n_layers=3, btl_size=8, input_size=48, seed=0)


@pytest.fixture(scope="module")
def models():
    """A small JAX model with random BN stats and its port twin."""
    jm, params, state = jget_model(JConfig(**SMALL))
    rng = np.random.default_rng(0)
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


def _jax_module(jm, params, state, side, x, dtype):
    spec = getattr(jm, side)
    layers, acts = jpack_module_layers(spec, params[side], state[side],
                                       dtype=dtype)
    out = jfused_module_forward(layers, acts, jnp.asarray(x, dtype))
    return np.asarray(out[:, : spec.layers[-1].out_size], np.float32)


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_fp32_module_matches_jax_fused_module_forward(models, side):
    jm, params, state, model = models
    module = getattr(model, side)
    x = _x(37, module.net[0].layer.in_features, seed=1)
    ref = _jax_module(jm, params, state, side, x, jnp.float32)
    pack = mlp_pack(module, torch.float32)
    ours = fused_module_forward(pack, torch.from_numpy(x))
    assert ours.dtype == torch.float32
    # JAX folds BN into one affine, the port does not: a few ulps apart
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)
    taps, stream = module_forward_taps(pack, torch.from_numpy(x))
    assert len(taps) == len(module.net) and stream is taps[-1]
    np.testing.assert_allclose(taps[-1].numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_bf16_module_matches_jax_fused_module_forward(models, side):
    jm, params, state, model = models
    module = getattr(cast_floats(model, torch.bfloat16), side)
    x = _x(37, module.net[0].layer.in_features, seed=2)
    ref = _jax_module(jm, jcast_floats(params, jnp.bfloat16), state, side, x,
                      jnp.bfloat16)
    pack = mlp_pack(module, torch.bfloat16)
    ours = fused_module_forward(pack, torch.from_numpy(x).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    # the mean relative bound of tests/test_pallas_kernels.py:117-121
    rel = np.mean(np.abs(ours - ref) / (np.abs(ref) + 1e-3))
    assert rel < 1e-2, rel


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_taps_match_module_forward_taps(models, side):
    *_, model = models
    module = getattr(model, side)
    x = torch.from_numpy(_x(29, module.net[0].layer.in_features, seed=3))
    taps, _ = module_forward_taps(mlp_pack(module), x)
    with torch.no_grad():
        ref = module.forward_taps(x)
    assert len(taps) == len(ref)
    for a, b in zip(taps, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_bf16_pack_rounds_fp32_input_on_load(models):
    """A bf16 pack reads an fp32 input as its bf16 rounding, so a layer's
    fp32 tap feeds the next layer unchanged."""
    *_, model = models
    layer = mlp_pack(cast_floats(model, torch.bfloat16).encoder,
                     torch.bfloat16).layers[0]
    x = torch.from_numpy(_x(11, 48, seed=4))
    a = fused_mlp_layer(layer, x)
    b = fused_mlp_layer(layer, x.to(torch.bfloat16))
    assert a.dtype == b.dtype == torch.float32
    assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version(models):
    *_, model = models
    layer = mlp_pack(model.encoder).layers[0]
    x = torch.from_numpy(_x(5, 48, seed=5))
    before = fused_mlp_layer.launches
    assert torch.equal(fused_mlp_layer(layer, x),
                       fused_mlp_layer_plain(layer, x))
    assert fused_mlp_layer.launches == before
    with pytest.raises(ValueError, match="x must be"):
        fused_mlp_layer(layer, x[:, :7])
    with pytest.raises(ValueError, match="dtype"):
        mlp_pack(model.encoder, torch.float16)


def test_fused_mlp_rejects_unsupported_activation():
    """mlp_pack refuses activations the kernel does not implement rather
    than silently computing leakyrelu (tests/test_pallas_kernels.py:53-69)."""
    module = FCModule(16, 8, [12], act="tanh", device="cpu")
    with pytest.raises(NotImplementedError, match="tanh"):
        mlp_pack(module)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_padded_pack_gives_the_unpadded_taps(models, side, dtype):
    """Rows padded to 16 bytes change no tap: the pack's weights are views
    of the same values, and the plain version reads them as they are."""
    *_, model = models
    module = getattr(cast_floats(model, dtype) if dtype == torch.bfloat16
                     else model, side)
    pack = mlp_pack(module, dtype)
    per = 16 // torch.tensor([], dtype=dtype).element_size()
    for layer, fc in zip(pack.layers, module.net):
        assert layer.w.dtype == dtype and layer.w.stride(0) % per == 0
        assert torch.equal(layer.w, fc.layer.weight.detach().to(dtype))
    dense = pack._replace(layers=tuple(
        lp._replace(w=lp.w.contiguous()) for lp in pack.layers))
    x = torch.from_numpy(_x(19, module.net[0].layer.in_features, seed=6))
    taps, stream = module_forward_taps(pack, x)
    taps_d, stream_d = module_forward_taps(dense, x)
    for a, b in zip(taps, taps_d):
        assert torch.equal(a, b)
    assert torch.equal(stream, stream_d) and stream.dtype == dtype


def test_bf16_dual_output_gives_the_taps_of_rounding_on_load(models,
                                                             monkeypatch):
    """On the card a bf16 layer returns its fp32 output and that output
    rounded to bf16, and module_forward_taps hands the bf16 copy on: the
    taps equal those of the plain version, which rounds on load."""
    from icra2021_multimodal_ad_tpu_torch.ops import _build, mlp_kernel

    *_, model = models
    pack = mlp_pack(cast_floats(model, torch.bfloat16).encoder,
                    torch.bfloat16)
    x = torch.from_numpy(_x(23, 48, seed=7))
    ref_taps, ref_stream = module_forward_taps(pack, x)
    seen = []

    def card(layer, y, variant=None):
        # what the bf16 variants return: the fp32 tap and its rounding, both
        # in padded rows; the input must already be the kernel's operand
        seen.append(y.dtype)
        out = fused_mlp_layer_plain(layer, y)
        out16 = _build.padded_empty(*out.shape, torch.bfloat16, "cpu")
        return out, out16.copy_(out)

    monkeypatch.setattr(mlp_kernel, "fused_mlp_layer_pair", card)
    taps, stream = module_forward_taps(pack, x)
    assert seen == [torch.float32] + [torch.bfloat16] * (len(taps) - 1)
    for a, b in zip(taps, ref_taps):
        assert torch.equal(a, b)
    assert torch.equal(stream, ref_stream) and stream.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variant_for_takes_wide_tiles_from_the_threshold(dtype):
    from icra2021_multimodal_ad_tpu_torch.ops import mlp_kernel, nap_kernel

    for module in (mlp_kernel, nap_kernel):
        narrow = module.VARIANTS[(dtype, False)]
        wide = module.VARIANTS[(dtype, True)]
        edge = module.WIDE_MIN_B
        assert narrow != wide
        assert [module.variant_for(dtype, b) for b in (1, edge - 1, edge,
                                                        7000)] == [
            narrow, narrow, wide, wide]
    assert len(set(mlp_kernel.VARIANTS.values())) == 4
