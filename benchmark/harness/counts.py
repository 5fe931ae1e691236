"""Operations and bytes from shapes, and the H100's peaks: the arithmetic
that every roofline share and `mfu` metric divides by.

A frozen copy of `chip_smoke.py`'s `bound`, `nap_bound` and `mlp_bound`: a
kernel's least time is the larger of its operations at the type's peak and
its bytes at HBM's rate, each input byte read once and each output byte
written once per launch.  A kernel's operands are charged in the type it
reads and writes them in (`ITEM_BYTES`): fp32 kernels move fp32 only; a
bf16 kernel reads its weights, V^T and FC inputs in bf16 and every vector
in fp32 (the port's `ops/mlp_kernel.LayerPack` and `ops/nap_kernel.NapPack`
hold them so), and its operations run at the bf16 peak.  The model FLOPs
of `mfu` count the products only: 2 per weight and row for a forward
pass, 6 for a training step.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.harness.inputs import module_widths

#: published dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
#: data sheet): fp32 on the CUDA cores, bf16 on the tensor cores, and HBM3
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
#: bytes of one element of each kernel type
ITEM_BYTES = {"float32": 4, "bfloat16": 2}


def compute_dtype(config: dict, traffic: dict) -> str:
    """The type a cell's kernels run in: its traffic's `compute_dtype`
    (the serving path's), else its configuration's."""
    return traffic.get("compute_dtype", config.get("dtype", "float32"))


def bound_s(ops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least seconds of a launch: operations at the peak against bytes
    at HBM's rate."""
    return max(ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S)


def fc_layer_cost(b: int, k: int, n: int, leaky: bool, bn: bool,
                  dtype: str = "float32") -> Tuple[float, float]:
    """(operations, bytes) of one FC layer on b rows in `dtype`: x and W in
    that type, the fp32 vectors and the fp32 output moved once, and for
    bf16 also the output's bf16 copy, which the next layer reads; against
    2bkn products plus the epilogue (bias; 1 for the activation; 4 for the
    BN) per output."""
    item = ITEM_BYTES[dtype]
    out = 4 + (item if dtype != "float32" else 0)
    n_vec = 1 + (4 if bn else 0)
    epi = 1 + int(leaky) + (4 if bn else 0)
    return (2.0 * b * k * n + epi * b * n,
            float(item * (b * k + k * n) + 4 * n_vec * n + out * b * n))


def module_layers(config: dict, module: str) -> List[Tuple[int, int, bool]]:
    """(k, n, has activation and BN) of each layer of `module`."""
    w = module_widths(config)[module]
    return [(k, n, i < len(w) - 2)
            for i, (k, n) in enumerate(zip(w[:-1], w[1:]))]


def module_cost(config: dict, module: str, b: int, dtype: str = "float32"
                ) -> Tuple[float, float, float]:
    """(operations, bytes, least seconds) of one pass of `module` over b
    rows in `dtype`: every layer's launch bound added, the sum a
    whole-module launch is held to as well."""
    ops = nbytes = least = 0.0
    for k, n, act in module_layers(config, module):
        o, m = fc_layer_cost(b, k, n, act, act, dtype)
        ops, nbytes, least = (ops + o, nbytes + m,
                              least + bound_s(o, m, dtype))
    return ops, nbytes, least


def rapp_fc_cost(config: dict, b: int, dtype: str = "float32"
                 ) -> Tuple[float, float, float]:
    """The FC kernel's work in one RaPP diff extraction of b rows: the
    encoder on x, the decoder on its code, the encoder on x_hat."""
    parts = [module_cost(config, m, b, dtype)
             for m in ("encoder", "decoder", "encoder")]
    return tuple(sum(p[i] for p in parts) for i in range(3))


def forward_fc_cost(config: dict, b: int, dtype: str = "float32"
                    ) -> Tuple[float, float, float]:
    """The FC kernel's work in one eval-mode forward of b rows (encoder,
    decoder), as the trainer's validation pass runs it."""
    parts = [module_cost(config, m, b, dtype) for m in ("encoder", "decoder")]
    return tuple(sum(p[i] for p in parts) for i in range(3))


def diff_width(config: dict) -> int:
    """K, the concatenated RaPP diffs' width: the input and every encoder
    layer's output."""
    return sum(module_widths(config)["encoder"])


def nap_cost(b: int, k: int, j: int, dtype: str = "float32"
             ) -> Tuple[float, float, float]:
    """(operations, bytes, least seconds) of one NAP score of b rows in
    `dtype`: the fp32 diffs x, V in that type, the fp32 vectors and the
    scores moved once, against 2bkj products plus the centring (bk) and
    the epilogue (4bj).  A bf16 kernel multiplies two bf16 halves of the
    centred rows, twice the 2bkj; only the score's own 2bkj is counted."""
    ops = 2.0 * b * k * j + b * k + 4.0 * b * j
    nbytes = float(4 * b * k + ITEM_BYTES[dtype] * k * j + 4 * k + 8 * j
                   + 4 * b)
    return ops, nbytes, bound_s(ops, nbytes, dtype)


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
