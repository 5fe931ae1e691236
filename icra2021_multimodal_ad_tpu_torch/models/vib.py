"""Variational information bottleneck: PyTorch counterpart of
`icra2021_multimodal_ad_tpu/models/vib.py` (the reference's
decorators/variational_info_bottleneck.py:19-42).

With distribution "normal" the encoder's output is split into (mu, logvar)
and reparameterized into k samples, z = mu + sigma * eps.  The noise eps is
`jax.random.normal` under the caller's JAX key, replayed on the tensors'
device (utils/jax_prng.py), so a key draws in the port what it draws in
JAX.  Without sampling (eval mode and no stochastic inference) z is mu
broadcast over k.  A data-parallel step (`rows`) draws the noise of the
global batch and keeps its own rows, so that sharded and single runs draw
the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils import jax_prng


def reparameterize_normal(key: Optional[jax_prng.Key], mu: torch.Tensor,
                          sigma: torch.Tensor, k: int,
                          stochastic: bool,
                          rows: Optional[Tuple[int, int]] = None
                          ) -> torch.Tensor:
    """z = eps * sigma + mu with k leading samples, eps drawn under `key`
    (a JAX key: (2,) uint32, or a (2,) int64 tensor of its words on mu's
    device, which a captured program reads at each replay); mu broadcast
    over k when not stochastic
    (variational_info_bottleneck.py:20-27).  `rows` = (offset, global
    rows): mu is the shard at `offset` of a global batch, and eps is drawn
    for the global batch and sliced there."""
    if not stochastic:
        return mu[None].expand((k,) + tuple(mu.shape))
    if key is None:
        raise ValueError("stochastic reparameterization requires a PRNG key")
    dtype = "bfloat16" if sigma.dtype == torch.bfloat16 else "float32"
    b = sigma.shape[0]
    offset, n = (0, b) if rows is None else rows
    eps = jax_prng.normal_device(key, (k, n) + tuple(sigma.shape[1:]), dtype,
                                 sigma.device)[:, offset:offset + b]
    return eps * sigma[None] + mu[None]


def vib_forward(module: nn.Module, x: torch.Tensor,
                distribution: Optional[str] = None, k: int = 1,
                stochastic_inference: bool = True,
                key: Optional[jax_prng.Key] = None,
                rows: Optional[Tuple[int, int]] = None):
    """`module`'s forward with the VIB head on its output
    (variational_info_bottleneck.py:29-40): identity without a
    distribution, else {"z": (k, B, half), "mu", "logvar"}.  It samples in
    train mode or with `stochastic_inference`, as the reference samples
    whenever grad is enabled or stochastic inference is set.  `rows`
    places a shard in its global batch (`reparameterize_normal`)."""
    output = module(x)
    if distribution is None:
        return output
    if distribution != "normal":
        raise NotImplementedError(
            f"Wrong distribution for information bottleneck: {distribution}")
    if k < 1:
        raise ValueError("k should be >= 1")
    half = output.shape[-1] // 2
    mu, logvar = output[..., :half], output[..., half:]
    sigma = torch.exp(logvar * 0.5)
    z = reparameterize_normal(key, mu, sigma, k,
                              module.training or stochastic_inference,
                              rows)
    return {"z": z, "mu": mu, "logvar": logvar}
