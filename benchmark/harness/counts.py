"""Operations and bytes from shapes, and the H100's peaks: the arithmetic
that every roofline share and `mfu` metric divides by.

A frozen copy of `chip_smoke.py`'s `bound`, `nap_bound` and `mlp_bound`: a
kernel's least time is the larger of its operations at the type's peak and
its bytes at HBM's rate, each input byte read once and each output byte
written once per launch.  The model FLOPs of `mfu` count the products
only: 2 per weight and row for a forward pass, 6 for a training step.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.harness.inputs import module_widths

#: published dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
#: data sheet): fp32 on the CUDA cores, bf16 on the tensor cores, and HBM3
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least seconds of a launch: operations at the peak against bytes
    at HBM's rate."""
    return max(ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S)


def fc_layer_cost(b: int, k: int, n: int, leaky: bool, bn: bool
                  ) -> Tuple[float, float]:
    """(operations, bytes) of one fp32 FC layer on b rows: x, W, the fp32
    vectors and the fp32 output moved once, against 2bkn products plus the
    epilogue (bias; 1 for the activation; 4 for the BN) per output."""
    n_vec = 1 + (4 if bn else 0)
    epi = 1 + int(leaky) + (4 if bn else 0)
    return (2.0 * b * k * n + epi * b * n,
            4.0 * (b * k + k * n + n_vec * n + b * n))


def module_layers(config: dict, module: str) -> List[Tuple[int, int, bool]]:
    """(k, n, has activation and BN) of each layer of `module`."""
    w = module_widths(config)[module]
    return [(k, n, i < len(w) - 2)
            for i, (k, n) in enumerate(zip(w[:-1], w[1:]))]


def module_cost(config: dict, module: str, b: int
                ) -> Tuple[float, float, float]:
    """(operations, bytes, least seconds) of one pass of `module` over b
    rows: every layer's launch bound added, the sum a whole-module launch is
    held to as well."""
    ops = nbytes = least = 0.0
    for k, n, act in module_layers(config, module):
        o, m = fc_layer_cost(b, k, n, act, act)
        ops, nbytes, least = ops + o, nbytes + m, least + bound_s(o, m)
    return ops, nbytes, least


def rapp_fc_cost(config: dict, b: int) -> Tuple[float, float, float]:
    """The FC kernel's work in one RaPP diff extraction of b rows: the
    encoder on x, the decoder on its code, the encoder on x_hat."""
    parts = [module_cost(config, m, b)
             for m in ("encoder", "decoder", "encoder")]
    return tuple(sum(p[i] for p in parts) for i in range(3))


def forward_fc_cost(config: dict, b: int) -> Tuple[float, float, float]:
    """The FC kernel's work in one eval-mode forward of b rows (encoder,
    decoder), as the trainer's validation pass runs it."""
    parts = [module_cost(config, m, b) for m in ("encoder", "decoder")]
    return tuple(sum(p[i] for p in parts) for i in range(3))


def diff_width(config: dict) -> int:
    """K, the concatenated RaPP diffs' width: the input and every encoder
    layer's output."""
    return sum(module_widths(config)["encoder"])


def nap_cost(b: int, k: int, j: int) -> Tuple[float, float, float]:
    """(operations, bytes, least seconds) of one NAP score of b rows: x, V,
    the fp32 vectors and the scores moved once, against 2bkj products plus
    the centring (bk) and the epilogue (4bj)."""
    ops = 2.0 * b * k * j + b * k + 4.0 * b * j
    nbytes = 4.0 * (b * k + k * j + k + 2 * j + b)
    return ops, nbytes, bound_s(ops, nbytes)


def weight_count(config: dict) -> int:
    """Weights of the FC layers (the products' count per row and pass)."""
    w = module_widths(config)
    return sum(k * n for m in ("encoder", "decoder")
               for k, n in zip(w[m][:-1], w[m][1:]))


def parameter_count(config: dict) -> int:
    """Every trained parameter: weights, biases, and the BN affine."""
    total = 0
    for m in ("encoder", "decoder"):
        for k, n, act in module_layers(config, m):
            total += k * n + n + (2 * n if act else 0)
    return total


def score_model_flops(config: dict, b: int, j: int) -> float:
    """Model FLOPs of scoring b windows: three module passes (encoder,
    decoder, encoder on x_hat) and the NAP product, 2bKJ."""
    enc = sum(k * n for k, n, _ in module_layers(config, "encoder"))
    dec = sum(k * n for k, n, _ in module_layers(config, "decoder"))
    return 2.0 * b * (2 * enc + dec) + 2.0 * b * diff_width(config) * j


def base_model_flops(config: dict, b: int) -> float:
    """Model FLOPs of BASE-scoring b windows: two module passes (encoder,
    decoder) and no NAP product."""
    return 2.0 * b * weight_count(config)


def train_model_flops(config: dict, n_train: int, n_valid: int,
                      epochs: int) -> float:
    """Model FLOPs of a training job: 6 per parameter and training window
    each epoch, and the validation forward, 2 per weight and window."""
    return epochs * (6.0 * parameter_count(config) * n_train
                     + 2.0 * weight_count(config) * n_valid)
