#!/usr/bin/env python3
"""Every dispatch variant of the port's two kernels across batch sizes, on
the card: the measurements behind `WIDE_MIN_B` in ops/mlp_kernel.py and
ops/nap_kernel.py.

    python3 scripts/torch_kernel_variants.py

For each variant (64 x 64 tiles, wide tiles; fp32 and bf16) of
`fused_mlp` at the first canonical layer (1728 -> 1402) and of `nap_score`
at the canonical serving shape (K = 5482, J = 4096) and the train-and-score
shape (J = 5482), at B in {10, 64, 256, 1024, 2048, 4096, 7000}: one JSON
line with the time (`torch_kernel_ab.device_ms`: CUDA events, median of
25, L2 flushed, host overhead kept out), the product's TFLOP/s, whether the
wrapper dispatches that variant at that batch, and the max abs error
against the plain version.  Weights, inputs and whitening stats are random
from fixed seeds.  Needs one NVIDIA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (10, 64, 256, 1024, 2048, 4096, 7000)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from torch_kernel_ab import device_ms
    from icra2021_multimodal_ad_tpu_torch.models.builder import get_model
    from icra2021_multimodal_ad_tpu_torch.ops import mlp_kernel, nap_kernel
    from icra2021_multimodal_ad_tpu_torch.ops.serving import cast_floats

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(),
        flush=True)
    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    cfg = cs.canonical_config()
    model = get_model(cfg, torch.Generator().manual_seed(cfg.seed))

    def row(kernel, variant, dtype, b, k, n, ms, err, module):
        print(json.dumps(dict(
            kernel=kernel, dtype=str(dtype), variant=variant, b=b, k=k, n=n,
            ms=ms, tflops=cs.tflops(2 * b * k * n, ms),
            dispatched=variant == module.variant_for(dtype, b),
            max_abs_err=err)), flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        m = model if dtype == torch.float32 else cast_floats(model, dtype)
        layer = mlp_kernel.mlp_pack(m.encoder, dtype).layers[0]
        n, k = layer.w.shape
        for b in BATCHES:
            x = torch.randn(b, k, generator=g, device="cuda").to(dtype)
            ref = mlp_kernel.fused_mlp_layer_plain(layer, x)
            for variant in cs.variants_of(mlp_kernel, dtype):
                got = mlp_kernel.fused_mlp_layer(layer, x, variant)
                ms = device_ms(
                    lambda: mlp_kernel.fused_mlp_layer(layer, x, variant),
                    flush)
                row("fused_mlp", variant, dtype, b, k, n, ms,
                    float((got - ref).abs().max()), mlp_kernel)

    for j, batches in ((cs.CANON_J, BATCHES[:-1]),
                       (cs.RUN_NAP_J, cs.RUN_NAP_B)):
        stats = cs.random_stats(cs.CANON_K, j, seed=j)
        for dtype in (torch.float32, torch.bfloat16):
            pack = nap_kernel.nap_pack(stats, dtype)
            for b in batches:
                x = torch.tensor(np.random.default_rng(b).normal(
                    size=(b, cs.CANON_K)), dtype=torch.float32,
                    device="cuda")
                ref = nap_kernel.nap_score_plain(pack, x)
                for variant in cs.variants_of(nap_kernel, dtype):
                    got = nap_kernel.nap_score(pack, x, variant)
                    ms = device_ms(
                        lambda: nap_kernel.nap_score(pack, x, variant),
                        flush)
                    row("nap_score", variant, dtype, b, cs.CANON_K, j, ms,
                        float((got - ref).abs().max()), nap_kernel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
