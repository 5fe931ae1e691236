"""Fused FC-module forward: the hand-written Hopper kernel, its pack and its
plain version.

Per layer of an eval-mode FC module, in fp32 accumulation:

    out = bn(act(y @ W.T + b)),  bn(v) = (v - mean) / std * weight + beta

with LeakyReLU(0.2) or identity as `act` and `std = sqrt(running_var +
eps)`.  Replaces the TPU kernel `_make_mlp_kernel` (icra2021_multimodal_ad_tpu/
ops/pallas_kernels.py, entry `fused_module_forward`).  The CUDA source is
`csrc/fused_mlp.cu` on the shared mainloop of `csrc/sm90_gemm.cuh`; their
header notes give the design and the bound on the H100.

Two ways to launch it.  Per layer (`fused_mlp_layer`, variants 0-3): fp32
on the CUDA cores or bf16 on the tensor cores, 64 x 64 tiles at small
batches or 128 x 128 tiles at large ones, and `module_forward_taps` loops
over a module's layers.  Per module (`fused_mlp_module`, variant 4): an
fp32 module at B <= SMALL_MAX_B runs every layer in one cooperative
launch, the TPU kernel's own fusion, with outputs bit-equal to variant 0's:
a producer warp per SM streams each block's weight rows by bulk copies
through a ring that runs across layers (the next layer's weights arrive
while this one computes and syncs; only its inputs wait for the grid
sync), and the consumer warps split each output's K into 32-deep stages,
their totals added in stage order (see the source note).
`variant_for` picks by type and batch, and whether a whole module runs:
`module_forward_taps` takes the module launch for a CUDA fp32 pack at B <=
SMALL_MAX_B unless it is given a `layer_fn`, and a single layer takes
variant 4 only when asked for it.  Both launch the kernel for CUDA tensors and take
`fused_mlp_layer_plain` only for CPU tensors.  `fused_mlp_layer.launches`
counts the per-layer launches (variants 0-3); `fused_mlp_module.launches`
counts the module launches (variant 4, a single layer's included) and
`fused_mlp_module.layers_run` the layers they ran; a captured program
(`utils/graphs.py`) adds what its capture counted at each replay.

Operand rows are padded to 16 bytes, as TMA and 16-byte copies need:
`mlp_pack` pads the weights once, and every output is allocated padded, so
only a module's first input may need a copy.

Unlike the TPU kernel, the BN affine is not folded (see the source note).
A bf16 layer writes its fp32 output (the RaPP tap) and that output rounded
to bf16, which the next bf16 layer reads: the arithmetic of rounding the
fp32 input on load.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from icra2021_multimodal_ad_tpu_torch.models.fc_module import FCModule
from icra2021_multimodal_ad_tpu_torch.models.layers import (
    BN_EPS,
    LEAKY_SLOPE,
)
from icra2021_multimodal_ad_tpu_torch.ops import _build
from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils import graphs

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: the variants of csrc/fused_mlp.cu, by (dtype, wide tiles)
VARIANTS = {(torch.float32, False): 0, (torch.float32, True): 1,
            (torch.bfloat16, False): 2, (torch.bfloat16, True): 3}
#: the whole-module fp32 variant of csrc/fused_mlp.cu
SMALL_VARIANT = 4
#: the batch from which the 128 x 128 tiles run in both types (below,
#: 64 x 64): where they measured faster on the H100 (PERF.md §6,
#: scripts/torch_kernel_variants.py)
WIDE_MIN_B = 4096
#: the largest batch an fp32 module runs in one launch (variant 4): it
#: measured faster than variant 0 at every B <= 32 on the H100, the
#: encoder's also at B = 33 and 64 (PERF.md §6); the limit rises only once
#: chip_smoke.py phase 2b shows the module faster at every B up to it
SMALL_MAX_B = 32
#: the most rows and layers one module launch takes (FM_MAX_B and
#: FM_MAX_LAYERS in the source)
KERNEL_MAX_B, MODULE_MAX_LAYERS = 64, 32


def variant_for(dtype: torch.dtype, b: int, module: bool = False) -> int:
    """The kernel variant that a (b, K) input of a `dtype` layer launches
    on its own, or with `module` as the first layer of a whole module
    (`module_forward_taps`): an fp32 module of at most SMALL_MAX_B rows
    runs in one launch (variant 4), a single layer per layer."""
    if module and dtype == torch.float32 and 1 <= b <= SMALL_MAX_B:
        return SMALL_VARIANT
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


class _FmLayer(ctypes.Structure):
    """One entry of the module launch's layer table: FmLayer in
    csrc/fused_mlp.cu."""

    _fields_ = [("w", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("bn_mean", ctypes.c_void_p), ("bn_std", ctypes.c_void_p),
                ("bn_weight", ctypes.c_void_p), ("bn_beta", ctypes.c_void_p),
                ("out_offset", ctypes.c_longlong), ("ldw", ctypes.c_int),
                ("K", ctypes.c_int), ("N", ctypes.c_int), ("ldo", ctypes.c_int),
                ("leaky", ctypes.c_int), ("pad", ctypes.c_int)]


class ModuleTable(NamedTuple):
    """The module launch's layer table for `layers`, built once: the
    entries, and where each layer's (B, N) output lies in one buffer of B *
    `row_floats` floats (at B * offsets[l], row stride ldo[l])."""

    layers: Tuple[LayerPack, ...]
    entries: ctypes.Array
    offsets: Tuple[int, ...]
    ldo: Tuple[int, ...]
    row_floats: int


def module_table(layers: Tuple[LayerPack, ...]) -> ModuleTable:
    """The layer table of fp32 `layers`: their pointers, shapes, strides,
    activation and BN flags, and the padded output layout."""
    entries = (_FmLayer * len(layers))()
    offsets, ldo, off = [], [], 0
    for e, layer in zip(entries, layers):
        n, k = layer.w.shape
        pad = -(-n // 4) * 4  # fp32 rows padded to 16 bytes
        e.w, e.bias = layer.w.data_ptr(), layer.b.data_ptr()
        if layer.bn_mean is not None:
            e.bn_mean, e.bn_std = (layer.bn_mean.data_ptr(),
                                   layer.bn_std.data_ptr())
            e.bn_weight, e.bn_beta = (layer.bn_weight.data_ptr(),
                                      layer.bn_beta.data_ptr())
        e.out_offset, e.ldw, e.K, e.N, e.ldo = (off, layer.w.stride(0), k, n,
                                                pad)
        e.leaky = int(layer.leaky)
        offsets.append(off)
        ldo.append(pad)
        off += pad
    return ModuleTable(layers, entries, tuple(offsets), tuple(ldo), off)


class MlpPack(NamedTuple):
    layers: Tuple[LayerPack, ...]
    dtype: torch.dtype
    #: the module launch's table of an fp32 pack, built by `mlp_pack`
    table: Optional[ModuleTable] = None


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
    layers = tuple(layers)
    return MlpPack(layers=layers, dtype=dtype,
                   table=(module_table(layers) if dtype == torch.float32
                          else None))


def fused_mlp_layer_plain(layer: LayerPack, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: x is rounded to the pack's
    dtype, then both operands are widened to the bias's dtype (exactly), so
    a bf16 pack reproduces bf16-operand, fp32-accumulate arithmetic.  The
    bias is fp32 in every kernel pack; a pack cast to float64 whole runs
    the same layer in float64."""
    acc_dtype = layer.b.dtype
    acc = (x.to(layer.w.dtype).to(acc_dtype) @ layer.w.to(acc_dtype).t()
           + layer.b)
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
        lib.fused_mlp_module.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.fused_mlp_module.restype = ctypes.c_int
        lib.fused_mlp_smem_bytes.argtypes = [ctypes.c_int]
        lib.fused_mlp_module_smem_bytes.argtypes = [ctypes.c_int] * 2
        for fn in (lib.fused_mlp_smem_bytes, lib.fused_mlp_module_smem_bytes):
            fn.restype = ctypes.c_int
        lib.fused_mlp_module_entry_bytes.restype = ctypes.c_int
        lib.fused_mlp_error_string.argtypes = [ctypes.c_int]
        lib.fused_mlp_error_string.restype = ctypes.c_char_p
        if lib.fused_mlp_module_entry_bytes() != ctypes.sizeof(_FmLayer):
            raise RuntimeError("the module launch's layer table does not "
                               "match csrc/fused_mlp.cu's FmLayer")
    return lib


def _check_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.fused_mlp_error_string(err).decode())


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
    elif variant not in _variants_of(dtype):
        raise ValueError(f"variant {variant} does not take {dtype} weights")
    if variant == SMALL_VARIANT:
        if b == 0:
            return _build.padded_empty(0, n, torch.float32, x.device), None
        return fused_mlp_module(MlpPack((layer,), dtype), x)[0], None
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
    _check_error(lib, err, "fused_mlp")
    fused_mlp_layer.launches += 1
    return out, out16


graphs.counted(fused_mlp_layer, "launches")


def _variants_of(dtype: torch.dtype) -> Tuple[int, ...]:
    per_layer = (VARIANTS[(dtype, False)], VARIANTS[(dtype, True)])
    return per_layer + ((SMALL_VARIANT,) if dtype == torch.float32 else ())


def fused_mlp_module(pack: MlpPack, x: torch.Tensor) -> List[torch.Tensor]:
    """Every layer of an fp32 module on (B, Din) CUDA inputs in one launch
    (variant 4), 1 <= B <= KERNEL_MAX_B: the taps, each (B, N) fp32 with
    rows padded to 16 bytes, bit-equal to variant 0's per-layer outputs.
    Raises where the kernel does not take the pack, x or its launch."""
    if pack.dtype != torch.float32:
        raise ValueError(f"the module launch takes fp32 packs, not "
                         f"{pack.dtype}")
    k = pack.layers[0].w.shape[1]
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (B, {k}), got {tuple(x.shape)}")
    b = x.shape[0]
    if x.device.type != "cuda" or not 1 <= b <= KERNEL_MAX_B:
        raise ValueError(f"the module launch takes 1 to {KERNEL_MAX_B} rows "
                         f"on cuda, got {b} on {x.device}")
    if len(pack.layers) > MODULE_MAX_LAYERS:
        raise ValueError(f"the module launch takes at most "
                         f"{MODULE_MAX_LAYERS} layers")
    for layer in pack.layers:
        if layer.w.device != x.device:
            raise ValueError(f"layer pack is on {layer.w.device}, x on "
                             f"{x.device}")
    table = pack.table
    if table is None or table.layers is not pack.layers:
        table = module_table(pack.layers)
    xd = _build.operand(x, torch.float32)
    out = torch.empty(b * table.row_floats, dtype=torch.float32,
                      device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.fused_mlp_module(
            ctypes.addressof(table.entries), len(pack.layers), xd.data_ptr(),
            xd.stride(0), out.data_ptr(), b,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_error(lib, err, "fused_mlp_module")
    fused_mlp_module.launches += 1
    fused_mlp_module.layers_run += len(pack.layers)
    return [out.as_strided((b, layer.w.shape[0]), (ld, 1), b * off)
            for layer, off, ld in zip(pack.layers, table.offsets, table.ldo)]


graphs.counted(fused_mlp_module, "launches", "layers_run")


def fused_mlp_layer_plain_pair(layer: LayerPack, x: torch.Tensor
                               ) -> Tuple[torch.Tensor, None]:
    """`fused_mlp_layer_pair` on the plain version, on any device: the layer
    function of a traversal that must not launch the kernel (an exported
    artifact, a float64 reference)."""
    return fused_mlp_layer_plain(layer, x), None


#: a layer of a module traversal: (pack, x) -> (fp32 output, bf16 copy or
#: None), as `fused_mlp_layer_pair`
LayerFn = Callable[[LayerPack, torch.Tensor],
                   Tuple[torch.Tensor, Optional[torch.Tensor]]]


def module_forward_taps(pack: MlpPack, x: torch.Tensor,
                        layer_fn: Optional[LayerFn] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(taps, stream): every layer's fp32 output, taps[-1] the module
    output, and the stream, the module output in the pack's dtype (what the
    next module reads).  On the card a bf16 layer hands the next one its
    bf16 output, so only the module's input may be cast.  `layer_fn` runs
    each layer: by default the kernel, the whole module in one launch for
    an fp32 pack on CUDA inputs of at most SMALL_MAX_B rows
    (`fused_mlp_module`), else `fused_mlp_layer_pair` per layer."""
    if layer_fn is None:
        if (x.device.type == "cuda" and x.dim() == 2
                and len(pack.layers) <= MODULE_MAX_LAYERS
                and variant_for(pack.dtype, x.shape[0], module=True)
                == SMALL_VARIANT):
            taps = fused_mlp_module(pack, x)
            return taps, taps[-1]
        layer_fn = fused_mlp_layer_pair
    taps = []
    y = x
    for layer in pack.layers:
        out, out16 = layer_fn(layer, y)
        taps.append(out)
        y = out if out16 is None else out16
    return taps, y.to(pack.dtype)


def fused_module_forward(pack: MlpPack, x: torch.Tensor,
                         layer_fn: Optional[LayerFn] = None) -> torch.Tensor:
    """The module output of (B, Din) inputs, in the pack's dtype."""
    return module_forward_taps(pack, x, layer_fn)[1]
