#!/usr/bin/env python3
"""How the bf16 NAP kernel's centring moves its scores, on the CPU.

The bf16 NAP kernel feeds the tensor cores bf16 operands, so x - rot_mu
must be rounded somewhere.  This script builds the setting of
tests/test_torch_serving.py (a small model with random BN stats, NAP
stats fitted by JAX on 512 windows, the bf16 variance floor), scores the
same concat diffs with each candidate arithmetic in plain PyTorch, and
prints one JSON line per candidate with the mean relative error (the
test's metric, |a - b| / (|b| + 1e-3)) against the port's fp32 scores and
against JAX's bf16 scorer (the test's limit: 1e-2):

  * "bf16(x) - mu, hi/lo" (the kernel since PR 3): x rounded to bf16,
    centred in fp32, both bf16 halves of the result against bf16 V;
  * "bf16(x - mu)": the centred row rounded once to bf16;
  * "bf16(x) - mu, fp32" (PR 1-2): the centring in fp32 after rounding x,
    the product on fp32 FMAs;
  * "JAX bf16": the JAX package's bf16 serving scorer itself.

    JAX_PLATFORMS=cpu python3 scripts/nap_bf16_centring_study.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp
    import torch

    from icra2021_multimodal_ad_tpu.config import Config as JConfig
    from icra2021_multimodal_ad_tpu.models.builder import (
        get_model as jget_model,
    )
    from icra2021_multimodal_ad_tpu.ops.rapp import (
        diffs_batch as jdiffs_batch,
    )
    from icra2021_multimodal_ad_tpu.ops.scoring import nap_fit as jnap_fit
    from icra2021_multimodal_ad_tpu.ops.serving import (
        make_serving as jmake_serving,
    )
    from icra2021_multimodal_ad_tpu_torch.config import Config
    from icra2021_multimodal_ad_tpu_torch.models.builder import (
        build_autoencoder,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.normalize import (
        RotaterStats,
        StandardizerStats,
    )
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import NapStats
    from icra2021_multimodal_ad_tpu_torch.ops.serving import (
        NAP_VAR_FLOOR_REL_BF16,
        make_serving,
    )
    from icra2021_multimodal_ad_tpu_torch.utils.torch_compat import (
        from_jax_pytrees,
    )

    small = dict(sensor="All", n_layers=3, btl_size=8, input_size=96, seed=0)
    cfg = JConfig(**small)
    jm, params, state = jget_model(cfg)
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
    train = rng.uniform(0, 1, (512, 96)).astype(np.float32)
    jstats = jnap_fit(jnp.concatenate(jdiffs_batch(jm, params, state, train),
                                      axis=-1))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    stats = NapStats(RotaterStats(t(jstats.rotater.mu), t(jstats.rotater.v)),
                     StandardizerStats(t(jstats.standardizer.mu),
                                       t(jstats.standardizer.var)))
    model = build_autoencoder(Config(**small)).to_empty(device="cpu")
    from_jax_pytrees(params, state, model)
    model.eval()
    x = rng.uniform(0, 1, (40, 96)).astype(np.float32)

    jserv = jmake_serving(cfg.replace(compute_dtype="bfloat16"), jm, params,
                          state, nap_stats=jstats,
                          nap_var_floor_rel=NAP_VAR_FLOOR_REL_BF16)
    cat = np.asarray(jserv.nap_diffs(jnp.asarray(x)))
    jax_bf16 = np.asarray(jserv.score_nap(jnp.asarray(cat)), np.float32)
    serv = make_serving(Config(**small), model, nap_stats=stats,
                        device="cpu", nap_var_floor_rel=NAP_VAR_FLOOR_REL_BF16)
    fp32 = serv.score_nap(torch.tensor(cat)).numpy()
    pack = make_serving(Config(**small, compute_dtype="bfloat16"), model,
                        nap_stats=stats, device="cpu",
                        nap_var_floor_rel=NAP_VAR_FLOOR_REL_BF16).nap_pack

    bf16 = lambda v: v.to(torch.bfloat16).float()  # noqa: E731
    xt, v = torch.tensor(cat), pack.v.float()

    def score(xc):
        u = (xc @ v - pack.std_mu) * pack.inv_std
        return ((u * u).sum(-1) / pack.j).numpy()

    c = bf16(xt) - pack.mu
    hi = bf16(c)
    candidates = {
        "bf16(x) - mu, hi/lo": score(hi + bf16(c - hi)),
        "bf16(x - mu)": score(bf16(xt - pack.mu)),
        "bf16(x) - mu, fp32": score(c),
        "JAX bf16": jax_bf16,
    }
    rel = lambda a, b: float(np.mean(np.abs(a - b) / (np.abs(b) + 1e-3)))  # noqa: E731,E501
    for name, s in candidates.items():
        print(json.dumps({"centring": name,
                          "mean_rel_vs_fp32": rel(s, fp32),
                          "mean_rel_vs_jax_bf16": rel(s, jax_bf16)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
