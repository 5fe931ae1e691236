"""RaPP diff extraction, "reconstruction along the projection pathway".

PyTorch counterpart of `icra2021_multimodal_ad_tpu/ops/rapp.py` (the
reference's reconstruction_aggregation.py:6-37): the input x and its
reconstruction x_hat both go through every encoder layer, and the per-layer
differences are collected.  diffs[0] is the input-space reconstruction
error; diffs[i] (i >= 1) is the difference after encoder layer i.

Every module pass goes through the fused FC-module kernel
(ops/mlp_kernel.py).  An fp32 pack is the exact path; a bf16 pack streams
bf16 operands into fp32 accumulation, and every tap and diff stays fp32.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from icra2021_multimodal_ad_tpu_torch.models.autoencoder import (
    AePack,
    AutoEncoder,
    ae_pack,
    vib_mu,
)
from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
    module_forward_taps,
)


@torch.no_grad()
def diffs_batch(model: AutoEncoder, x: torch.Tensor,
                pack: Optional[AePack] = None):
    """Eval-mode forward plus dual-pathway layer taps; returns a tuple of
    (batch, dim_i) fp32 diffs, n_layers + 1 of them.  `pack` defaults to
    the model's current weights in their own dtype.

    The x-pathway taps are computed once and the bottleneck tap IS the
    latent, so the extraction is 2 encoder passes + 1 decoder pass.  VIB
    models score deterministically (z = mu); their taps are the raw layer
    outputs, the double-width head included.  diffs[0] is taken against x
    in fp32, so a caller streaming bf16 passes x already rounded."""
    if pack is None:
        pack = ae_pack(model)
    x = x.reshape(x.shape[0], -1)
    # each module reads the one before in the pack's dtype (its stream)
    taps_x, z = module_forward_taps(pack.encoder, x)
    taps_dec, x_hat_stream = module_forward_taps(
        pack.decoder, vib_mu(z, pack.distribution))
    x_hat = taps_dec[-1]
    taps_xhat, _ = module_forward_taps(pack.encoder, x_hat_stream)
    diffs = [x_hat - x.float()]
    diffs += [h2 - h1 for h1, h2 in zip(taps_x, taps_xhat)]
    return tuple(diffs)


def get_diffs(x: torch.Tensor, model: AutoEncoder,
              batch_size: Optional[int] = None,
              mesh=None, pack: Optional[AePack] = None) -> List[torch.Tensor]:
    """Chunked RaPP diffs over an arbitrarily-sized input; one (n, dim_i)
    tensor per pathway layer.  The pack is built once for all chunks.

    Every chunk, the tail included, runs at the same padded shape, so every
    row sees the same kernel tiling wherever it lands in the input;
    eval-mode BN couples no rows, so the zero rows cannot perturb real ones
    and are sliced off."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded diff extraction is not ported yet (ROADMAP.md "
            "queue 1, item 11: parallel/mesh.py)")
    if pack is None:
        pack = ae_pack(model)
    x = x.reshape(x.shape[0], -1)
    n = x.shape[0]
    if batch_size is None or batch_size >= n:
        return list(diffs_batch(model, x, pack))
    parts = []
    for start in range(0, n, batch_size):
        piece = x[start:start + batch_size]
        pad = batch_size - piece.shape[0]
        if pad:
            piece = torch.cat([piece, piece.new_zeros((pad, piece.shape[1]))])
        out = diffs_batch(model, piece, pack)
        parts.append([o[:batch_size - pad] for o in out])
    return [torch.cat(ps, dim=0) for ps in zip(*parts)]
