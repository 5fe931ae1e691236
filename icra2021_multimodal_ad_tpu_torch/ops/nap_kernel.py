"""Fused NAP score: the hand-written Hopper kernel, its pack and its plain
version.

    score_b = mean_j( ((((x_b - rot_mu) @ V)_j - std_mu_j) * inv_std_j)^2 )

Replaces the TPU kernel `_nap_kernel` (icra2021_multimodal_ad_tpu/ops/
pallas_kernels.py, entry `nap_score_pallas`).  The CUDA source is
`csrc/nap_score.cu` on the shared mainloop of `csrc/sm90_gemm.cuh`; their
header notes give the design and the bound on the H100.  `nap_score`
launches it for CUDA tensors and takes `nap_score_plain` only for CPU
tensors.  `nap_score.launches` counts the calls that launched the kernel,
every variant included; `nap_score.small_launches` those of variant 4;
`nap_score.balanced_launches` those of variant 4 whose partition gives no
block more than `BALANCED` times the mean block's share of V^T (the
library's `nap_score_small_balance`); a captured program
(`utils/graphs.py`) adds what its capture counted at each replay.

Each call picks one of five variants by type and batch (`variant_for`):
fp32 on the CUDA cores or bf16 on the tensor cores, 64 x 64 tiles at small
batches, 128 x 128 (fp32) or 128 x 256 (bf16) tiles at large ones, each a
centring launch, the tile product and a reduction launch; and variant 4,
fp32 at B <= SMALL_MAX_B in one cooperative launch that centres, multiplies
and reduces, bit-equal to variant 0.  Every fp32
variant sums K in two levels, each 32-deep stage its own chain and the
stage totals added in stage order.  Variant 4 at B <= 16, where J has
32-column tiles for half the SMs or more, deals J's columns out evenly over
the blocks in one round, each output's running total kept by one thread;
else it takes whole tiles, and where J is small spreads K's stages over
blocks too (its scratch then holds every stage total:
`nap_score_small_scratch` in the source).  The kernel centres x first: an
fp32 pack multiplies x - rot_mu; a bf16 pack rounds x to bf16, centres it
in fp32 and multiplies both bf16 halves of the result, hi = bf16(xc) and
lo = bf16(xc - hi), by the bf16 rotation with fp32 accumulation (see
`nap_score_plain` and the source note).
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, NamedTuple, Optional

import torch

from icra2021_multimodal_ad_tpu_torch.ops import _build
from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils import graphs

if TYPE_CHECKING:  # ops/scoring.py imports this module
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import NapStats

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: the variants of csrc/nap_score.cu, by (dtype, wide tiles)
VARIANTS = {(torch.float32, False): 0, (torch.float32, True): 1,
            (torch.bfloat16, False): 2, (torch.bfloat16, True): 3}
#: the fp32 one-launch variant for small batches
SMALL_VARIANT = 4
#: the batch from which the wide tiles run in both types (128 x 128 fp32,
#: 128 x 256 bf16; below, 64 x 64): where they measured faster on the H100
WIDE_MIN_B = 1024
#: the largest batch that fp32 scores in one launch (variant 4): it
#: measured faster than variant 0 at every B <= 32 on the H100 and not at
#: B = 64, J = 4096 (PERF.md §6, scripts/torch_kernel_ab.py)
SMALL_MAX_B = 32
#: the most rows variant 4 takes (NS_MAX_B in the source)
KERNEL_MAX_B = 64
#: the busiest block's share of V^T over the mean that a variant-4 launch
#: may reach and still count among `nap_score.balanced_launches`
BALANCED = 1.05


def variant_for(dtype: torch.dtype, b: int) -> int:
    """The kernel variant that a batch of b rows on a `dtype` pack
    launches."""
    if dtype == torch.float32 and b <= SMALL_MAX_B:
        return SMALL_VARIANT
    return VARIANTS[(dtype, b >= WIDE_MIN_B)]


def _variants_of(dtype: torch.dtype):
    per_call = (VARIANTS[(dtype, False)], VARIANTS[(dtype, True)])
    return per_call + ((SMALL_VARIANT,) if dtype == torch.float32 else ())


class NapPack(NamedTuple):
    """Kernel operands, built once per serving bundle (`make_serving`)."""

    vt: torch.Tensor       # (J, K) V^T, kernel dtype, rows padded to 16
    #                        bytes: K-major like the FC weights
    mu: torch.Tensor       # (K,) fp32 rotation mean, subtracted from x
    std_mu: torch.Tensor   # (J,) fp32 standardizer mean
    inv_std: torch.Tensor  # (J,) fp32; 0 on floored (var = inf) columns
    k: int
    j: int

    @property
    def v(self) -> torch.Tensor:
        """The (K, J) rotation, a view of `vt`."""
        return self.vt.t()


def nap_pack(stats: NapStats, dtype: torch.dtype = torch.float32) -> NapPack:
    """Cast and lay out the kernel operands of `stats` on their device."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"NAP kernel dtype must be one of {_KERNEL_DTYPES}, "
                         f"got {dtype}")
    v = stats.rotater.v
    k, j = v.shape
    return NapPack(
        vt=_build.operand(v.t(), dtype),
        mu=stats.rotater.mu.float().contiguous(),
        std_mu=stats.standardizer.mu.float().contiguous(),
        inv_std=(1.0 / torch.sqrt(stats.standardizer.var.float())).contiguous(),
        k=k, j=j)


def nap_score_plain(pack: NapPack, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch.  fp32: (x - rot_mu) @ V.
    bf16: xc = bf16(x) - rot_mu in fp32, then (hi + lo) @ V_bf16 for its
    bf16 halves hi = bf16(xc), lo = bf16(xc - hi), every operand widened to
    fp32 (exactly): bf16 operands, fp32 accumulation."""
    if pack.vt.dtype == torch.float32:
        xc = x.float() - pack.mu
    else:
        bf16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
        xc = bf16(x.float()) - pack.mu
        hi = bf16(xc)
        xc = hi + bf16(xc - hi)
    rot = xc @ pack.v.float()
    t = (rot - pack.std_mu) * pack.inv_std
    return (t * t).sum(dim=-1) / pack.j


_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.load("nap_score")
    if lib.nap_score.argtypes is None:
        lib.nap_score.argtypes = _ARGTYPES
        lib.nap_score.restype = ctypes.c_int
        for fn in (lib.nap_score_tile_j, lib.nap_score_xc_cols,
                   lib.nap_score_smem_bytes):
            fn.restype = ctypes.c_int
        lib.nap_score_tile_j.argtypes = [ctypes.c_int]
        lib.nap_score_smem_bytes.argtypes = [ctypes.c_int]
        lib.nap_score_xc_cols.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.nap_score_error_string.argtypes = [ctypes.c_int]
        lib.nap_score_error_string.restype = ctypes.c_char_p
        lib.nap_score_small_scratch.argtypes = [ctypes.c_int] * 3
        lib.nap_score_small_scratch.restype = ctypes.c_longlong
        lib.nap_score_small_balance.argtypes = [ctypes.c_int] * 3
        lib.nap_score_small_balance.restype = ctypes.c_double
        # the per-variant queries, asked once when the library loads
        lib.tile_j = {v: lib.nap_score_tile_j(v)
                      for v in (*VARIANTS.values(), SMALL_VARIANT)}
        lib.xc_cols = functools.lru_cache(maxsize=None)(lib.nap_score_xc_cols)
        lib.small_shape = functools.lru_cache(maxsize=None)(_small_shape)
    return lib


def _small_shape(device: int, b: int, k: int, j: int):
    """(floats of scratch, whether the partition is balanced) of variant 4
    at (b, k, j) on CUDA device `device`: its launch shape (and whether it
    splits K) follows the card's SMs."""
    lib = _build.load("nap_score")
    with torch.cuda.device(device):
        n = lib.nap_score_small_scratch(b, k, j)
        balance = lib.nap_score_small_balance(b, k, j)
    if n < 0 or balance < 0:
        raise RuntimeError(f"nap_score variant 4 takes no ({b}, {k}, {j})")
    return n, balance <= BALANCED


def nap_score(pack: NapPack, x: torch.Tensor,
              variant: Optional[int] = None) -> torch.Tensor:
    """Fused NAP score of (B, K) concat diffs -> (B,) fp32 scores.

    x is read in fp32.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (`variant`, default `variant_for`) or raises."""
    if x.dim() != 2 or x.shape[1] != pack.k:
        raise ValueError(f"x must be (B, {pack.k}), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return nap_score_plain(pack, x)
    if x.device.type != "cuda":
        raise ValueError(f"nap_score runs on cpu or cuda, not {x.device}")
    for name in ("vt", "mu", "std_mu", "inv_std"):
        if getattr(pack, name).device != x.device:
            raise ValueError(f"pack.{name} is on {getattr(pack, name).device},"
                             f" x on {x.device}")
    dtype = pack.vt.dtype
    b = x.shape[0]
    if variant is None:
        variant = variant_for(dtype, b)
    elif variant not in _variants_of(dtype):
        raise ValueError(f"variant {variant} does not take a {dtype} pack")
    if variant == SMALL_VARIANT and b > KERNEL_MAX_B:
        raise ValueError(f"variant {variant} takes at most {KERNEL_MAX_B} "
                         f"rows, got {b}")
    xf = x.float()
    if xf.stride(1) != 1:
        xf = xf.contiguous()
    if b == 0:
        return torch.empty(0, dtype=torch.float32, device=x.device)
    lib = _lib()
    if variant == SMALL_VARIANT:
        # one allocation: the kernel's scratch at its (16-byte aligned)
        # start (the outputs' t, or the centred rows, the stage totals where
        # the launch splits K and the tile partials), then the scores
        n, balanced = lib.small_shape(x.device.index, b, pack.k, pack.j)
        buf = torch.empty(n + b, dtype=torch.float32, device=x.device)
        partial, out, xc, ldxc = buf[:n], buf[n:], None, 0
    else:
        n_tiles = -(-pack.j // lib.tile_j[variant])
        out = torch.empty(b, dtype=torch.float32, device=x.device)
        xc = _build.padded_empty(b, lib.xc_cols(variant, pack.k), dtype,
                                 x.device)
        partial, ldxc = torch.empty((n_tiles, b), dtype=torch.float32,
                                    device=x.device), xc.stride(0)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.nap_score(
            variant, xf.data_ptr(), xf.stride(0), pack.vt.data_ptr(),
            pack.vt.stride(0), pack.mu.data_ptr(), pack.std_mu.data_ptr(),
            pack.inv_std.data_ptr(), None if xc is None else xc.data_ptr(),
            ldxc, partial.data_ptr(), out.data_ptr(), b, pack.k, pack.j,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("nap_score kernel launch failed: "
                           + lib.nap_score_error_string(err).decode())
    nap_score.launches += 1
    if variant == SMALL_VARIANT:
        nap_score.small_launches += 1
        nap_score.balanced_launches += int(balanced)
    return out


graphs.counted(nap_score, "launches", "small_launches", "balanced_launches")
