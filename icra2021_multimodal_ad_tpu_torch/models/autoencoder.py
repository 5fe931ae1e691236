"""Deep autoencoder: PyTorch counterpart of
`icra2021_multimodal_ad_tpu/models/autoencoder.py` (the reference's
models/auto_encoder.py:21-55).

Inputs are flattened to (batch, -1) before the FC stack.  With
`distribution="normal"` the encoder's last layer is double-width (mu,
logvar) and a VIB head (models/vib.py) reparameterizes it into k samples
under a JAX key: in train mode, or in eval mode with
`stochastic_inference`.  The k samples are decoded as one (k, B, btl)
batch, whose BN normalizes over (k*B, C); the forward returns their mean
reconstruction, or the (k, B, D) samples with `return_samples`.  Without
sampling z = mu, decoded once: the k copies of mu are identical.  The
scoring paths (RaPP, serving) always take z = mu.

`nn.Module.forward` is the autograd path of training.  Every eval-mode
forward of the scoring paths goes through the fused FC-module kernel
instead: `ae_pack` lays the weights out once, `packed_forward` runs them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from icra2021_multimodal_ad_tpu_torch.models.fc_module import FCModule
from icra2021_multimodal_ad_tpu_torch.models.losses import loss_fn
from icra2021_multimodal_ad_tpu_torch.models.vib import vib_forward
from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
    LayerFn,
    MlpPack,
    fused_module_forward,
    mlp_pack,
)
from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils import jax_prng

#: the autoencoder's loss, always mse with sum reduction
#: (model_builder.py:40)
_RECON_LOSS = loss_fn("mse", "sum")


class AutoEncoder(nn.Module):
    #: (offset, global rows) of the shard a data-parallel step feeds the
    #: model (set by train.data_parallel), or None: the VIB noise is drawn
    #: for the global batch and sliced there
    row_shard = None

    def __init__(self, encoder: FCModule, decoder: FCModule,
                 distribution: Optional[str] = None, k: int = 1,
                 stochastic_inference: bool = False):
        super().__init__()
        if distribution not in (None, "normal"):
            raise NotImplementedError(
                f"Wrong distribution for information bottleneck: "
                f"{distribution}")
        self.encoder = encoder
        self.decoder = decoder
        self.distribution = distribution
        self.k = k
        self.stochastic_inference = stochastic_inference

    def encode(self, x: torch.Tensor, key: Optional[jax_prng.Key] = None):
        """(B, btl) codes; a VIB model returns the head's {"z": (k, B,
        btl), "mu", "logvar"}, z = mu (k = 1) when it does not sample."""
        x = x.reshape(x.shape[0], -1)
        if self.distribution is None:
            return self.encoder(x)
        k = self.k if self.training or self.stochastic_inference else 1
        return vib_forward(self.encoder, x, self.distribution, k,
                           self.stochastic_inference, key, self.row_shard)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor, key: Optional[jax_prng.Key] = None,
                return_samples: bool = False) -> torch.Tensor:
        """x -> x_hat (B, D); `key` is the JAX key of the VIB noise."""
        z = self.encode(x, key)
        if self.distribution is None:
            return self.decode(z).reshape(x.shape[0], -1)
        y = self.decode(z["z"])
        if return_samples:
            return y
        return y.mean(dim=0).reshape(x.shape[0], -1)


class AePack(NamedTuple):
    """Both modules' kernel operands (ops/mlp_kernel.py)."""

    encoder: MlpPack
    decoder: MlpPack
    distribution: Optional[str]


def ae_pack(model: AutoEncoder, dtype: torch.dtype = torch.float32
            ) -> AePack:
    """Pack the model's current eval-mode weights in `dtype`: fp32, the
    exact path, also for a model whose params are held in bf16 (JAX
    evaluates those in fp32 HIGHEST), or bf16 for a serving cast."""
    return AePack(mlp_pack(model.encoder, dtype),
                  mlp_pack(model.decoder, dtype), model.distribution)


def vib_mu(z: torch.Tensor, distribution: Optional[str]) -> torch.Tensor:
    """Deterministic VIB scoring: z = mu, the first half of the head."""
    return z if distribution is None else z[..., : z.shape[-1] // 2]


@torch.no_grad()
def packed_forward(pack: AePack, x: torch.Tensor,
                   layer_fn: Optional[LayerFn] = None) -> torch.Tensor:
    """Eval-mode x -> x_hat through the kernel (or `layer_fn`), in the
    pack's dtype.  VIB models take z = mu."""
    z = fused_module_forward(pack.encoder, x.reshape(x.shape[0], -1),
                             layer_fn)
    return fused_module_forward(pack.decoder, vib_mu(z, pack.distribution),
                                layer_fn)


def ae_loss(model: AutoEncoder, x: torch.Tensor, train: bool = False,
            pack: Optional[AePack] = None,
            key: Optional[jax_prng.Key] = None) -> torch.Tensor:
    """Reconstruction loss (auto_encoder.py:52-55): the mse-sum of
    (model(x), x), in fp32; a VIB model that samples takes the mean over
    its k samples of each sample's mse-sum.

    train=True runs the module's own forward with train-mode BN (which
    updates the running stats in place) and keeps the autograd graph; a
    VIB model draws its noise under `key` (numpy words or a device tensor
    of them, models/vib.py).  Otherwise the forward goes
    through the kernel on `pack`, built from the current weights in x's
    dtype when not given, with z = mu."""
    x2 = x.reshape(x.shape[0], -1)
    x32 = x2.float()
    if not train:
        if pack is None:
            pack = ae_pack(model, x2.dtype)
        return _RECON_LOSS(packed_forward(pack, x2).float(), x32)
    model.train()
    if model.distribution is None:
        return _RECON_LOSS(model(x2).float(), x32)
    y = model(x2, key=key, return_samples=True)
    return torch.stack([_RECON_LOSS(yk.float(), x32) for yk in y]).mean()
