"""Fused FC-module forward: the hand-written Hopper kernel, its pack and its
plain version.

Per layer of an eval-mode FC module, in fp32 accumulation:

    out = bn(act(y @ W.T + b)),  bn(v) = (v - mean) / std * weight + beta

with LeakyReLU(0.2) or identity as `act` and `std = sqrt(running_var +
eps)`.  Replaces the TPU kernel `_make_mlp_kernel` (icra2021_multimodal_ad_tpu/
ops/pallas_kernels.py, entry `fused_module_forward`).  The CUDA source is
`csrc/fused_mlp.cu` on the shared mainloop of `csrc/sm90_gemm.cuh`; their
header notes give the design and the bound on the H100.  The kernel runs one
layer per launch, and `module_forward_taps` loops over a module's layers.
`fused_mlp_layer` launches the kernel for CUDA tensors and takes
`fused_mlp_layer_plain` only for CPU tensors; `fused_mlp_layer.launches`
counts the kernel launches, every variant included.

Each launch picks one of four variants by type and batch (`variant_for`):
fp32 on the CUDA cores or bf16 on the tensor cores, 64 x 64 tiles at small
batches or 128 x 128 tiles at large ones.  Operand rows are padded to 16
bytes, as TMA and 16-byte copies need: `mlp_pack` pads the weights once,
and every output is allocated padded, so only a module's first input may
need a copy.

Unlike the TPU kernel, the BN affine is not folded (see the source note).
A bf16 layer writes its fp32 output (the RaPP tap) and that output rounded
to bf16, which the next bf16 layer reads: the arithmetic of rounding the
fp32 input on load.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from icra2021_multimodal_ad_tpu_torch.models.fc_module import FCModule
from icra2021_multimodal_ad_tpu_torch.models.layers import (
    BN_EPS,
    LEAKY_SLOPE,
)
from icra2021_multimodal_ad_tpu_torch.ops import _build

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: the variants of csrc/fused_mlp.cu, by (dtype, wide tiles)
VARIANTS = {(torch.float32, False): 0, (torch.float32, True): 1,
            (torch.bfloat16, False): 2, (torch.bfloat16, True): 3}
#: the batch from which the 128 x 128 tiles run in both types (below,
#: 64 x 64): where they measured faster on the H100 (PERF.md §6,
#: scripts/torch_kernel_variants.py)
WIDE_MIN_B = 4096


def variant_for(dtype: torch.dtype, b: int) -> int:
    """The kernel variant that a (b, K) input of a `dtype` layer launches."""
    return VARIANTS[(dtype, b >= WIDE_MIN_B)]


class LayerPack(NamedTuple):
    """One layer's kernel operands; the BN vectors are None without BN."""

    w: torch.Tensor                    # (N, K), kernel dtype, rows
    #                                    padded to 16 bytes
    b: torch.Tensor                    # (N,) fp32
    leaky: bool                        # LeakyReLU(0.2) or identity
    bn_mean: Optional[torch.Tensor]    # (N,) fp32 running mean
    bn_std: Optional[torch.Tensor]     # (N,) fp32 sqrt(running_var + eps)
    bn_weight: Optional[torch.Tensor]  # (N,) fp32
    bn_beta: Optional[torch.Tensor]    # (N,) fp32


class MlpPack(NamedTuple):
    layers: Tuple[LayerPack, ...]
    dtype: torch.dtype


@torch.no_grad()
def mlp_pack(module: FCModule, dtype: torch.dtype = torch.float32) -> MlpPack:
    """Lay out each eval-mode layer's operands once, on the module's device:
    the weights in `dtype` with rows padded to 16 bytes, the vectors in fp32
    and one sqrt per BN layer.  Refuses activations the kernel does not
    implement."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"fused MLP kernel dtype must be one of "
                         f"{_KERNEL_DTYPES}, got {dtype}")
    layers = []
    for fc in module.net:
        if fc.act not in (None, "leakyrelu"):
            raise NotImplementedError(
                f"fused MLP kernel only implements leakyrelu/identity "
                f"activations, got {fc.act!r}: use the module's own forward "
                f"for other registry activations")
        bn = fc.bn
        layers.append(LayerPack(
            w=_build.operand(fc.layer.weight.detach(), dtype),
            b=fc.layer.bias.detach().float().contiguous(),
            leaky=fc.act == "leakyrelu",
            bn_mean=None if bn is None else bn.running_mean.float(),
            bn_std=(None if bn is None
                    else torch.sqrt(bn.running_var.float() + BN_EPS)),
            bn_weight=None if bn is None else bn.weight.detach().float(),
            bn_beta=None if bn is None else bn.bias.detach().float()))
    return MlpPack(layers=tuple(layers), dtype=dtype)


def fused_mlp_layer_plain(layer: LayerPack, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: x is rounded to the pack's
    dtype, then both operands are widened to fp32 (exactly), so a bf16 pack
    reproduces bf16-operand, fp32-accumulate arithmetic."""
    acc = x.to(layer.w.dtype).float() @ layer.w.float().t() + layer.b
    if layer.leaky:
        acc = F.leaky_relu(acc, LEAKY_SLOPE)
    if layer.bn_mean is not None:
        acc = ((acc - layer.bn_mean) / layer.bn_std * layer.bn_weight
               + layer.bn_beta)
    return acc


_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int,
              ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    if lib.fused_mlp.argtypes is None:
        lib.fused_mlp.argtypes = _ARGTYPES
        lib.fused_mlp.restype = ctypes.c_int
        lib.fused_mlp_smem_bytes.argtypes = [ctypes.c_int]
        lib.fused_mlp_smem_bytes.restype = ctypes.c_int
        lib.fused_mlp_error_string.argtypes = [ctypes.c_int]
        lib.fused_mlp_error_string.restype = ctypes.c_char_p
    return lib


def fused_mlp_layer(layer: LayerPack, x: torch.Tensor,
                    variant: Optional[int] = None) -> torch.Tensor:
    """One eval-mode layer of (B, K) inputs -> (B, N) fp32 outputs.

    x may be fp32 or the pack's dtype; a bf16 pack rounds fp32 x to bf16.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (`variant`, default `variant_for`) or raises."""
    return fused_mlp_layer_pair(layer, x, variant)[0]


def fused_mlp_layer_pair(layer: LayerPack, x: torch.Tensor,
                         variant: Optional[int] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(fp32 output, its bf16 rounding or None): a bf16 layer on the card
    also returns its output rounded to bf16, laid out for the next layer;
    fp32 layers and the plain version return None beside the output."""
    n, k = layer.w.shape
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (B, {k}), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_mlp_layer_plain(layer, x), None
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_layer runs on cpu or cuda, not "
                         f"{x.device}")
    operands = (layer.w, layer.b, layer.bn_mean, layer.bn_std,
                layer.bn_weight, layer.bn_beta)
    for t in (t for t in operands if t is not None):
        if t.device != x.device:
            raise ValueError(f"layer pack is on {t.device}, x on {x.device}")
    dtype = layer.w.dtype
    b = x.shape[0]
    if variant is None:
        variant = variant_for(dtype, b)
    elif variant not in (VARIANTS[(dtype, False)], VARIANTS[(dtype, True)]):
        raise ValueError(f"variant {variant} does not take {dtype} weights")
    xd = _build.operand(x, dtype)
    out = _build.padded_empty(b, n, torch.float32, x.device)
    out16 = (None if dtype == torch.float32
             else _build.padded_empty(b, n, dtype, x.device))
    if b == 0:
        return out, out16
    lib = _lib()
    bn = ([None] * 4 if layer.bn_mean is None else
          [t.data_ptr() for t in (layer.bn_mean, layer.bn_std,
                                  layer.bn_weight, layer.bn_beta)])
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.fused_mlp(
            variant, xd.data_ptr(), xd.stride(0), layer.w.data_ptr(),
            layer.w.stride(0), layer.b.data_ptr(), *bn, out.data_ptr(),
            out.stride(0), None if out16 is None else out16.data_ptr(),
            0 if out16 is None else out16.stride(0), b, k, n,
            int(layer.leaky), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_mlp kernel launch failed: "
                           + lib.fused_mlp_error_string(err).decode())
    fused_mlp_layer.launches += 1
    return out, out16


fused_mlp_layer.launches = 0


def module_forward_taps(pack: MlpPack, x: torch.Tensor
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(taps, stream): every layer's fp32 output, taps[-1] the module
    output, and the stream, the module output in the pack's dtype (what the
    next module reads).  On the card a bf16 layer hands the next one its
    bf16 output, so only the module's input may be cast."""
    taps = []
    y = x
    for layer in pack.layers:
        out, out16 = fused_mlp_layer_pair(layer, y)
        taps.append(out)
        y = out if out16 is None else out16
    return taps, y.to(pack.dtype)


def fused_module_forward(pack: MlpPack, x: torch.Tensor) -> torch.Tensor:
    """The module output of (B, Din) inputs, in the pack's dtype."""
    return module_forward_taps(pack, x)[1]
