"""Fused NAP score: the hand-written Hopper kernel, its pack and its plain
version.

    score_b = mean_j( ((((x_b - rot_mu) @ V)_j - std_mu_j) * inv_std_j)^2 )

Replaces the TPU kernel `_nap_kernel` (icra2021_multimodal_ad_tpu/ops/
pallas_kernels.py, entry `nap_score_pallas`).  The CUDA source is
`csrc/nap_score.cu` on the shared mainloop of `csrc/sm90_gemm.cuh`; their
header notes give the design and the bound on the H100.  `nap_score`
launches it for CUDA tensors and takes `nap_score_plain` only for CPU
tensors.  `nap_score.launches` counts the kernel launches, every variant
included.

Each launch picks one of four variants by type and batch (`variant_for`):
fp32 on the CUDA cores or bf16 on the tensor cores, 64 x 64 tiles at small
batches, 128 x 128 (fp32) or 128 x 256 (bf16) tiles at large ones.  The
kernel centres x first: an fp32 pack multiplies x - rot_mu; a bf16 pack
rounds x to bf16, centres it in fp32 and multiplies both bf16 halves of the
result, hi = bf16(xc) and lo = bf16(xc - hi), by the bf16 rotation with
fp32 accumulation (see `nap_score_plain` and the source note).
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, NamedTuple, Optional

import torch

from icra2021_multimodal_ad_tpu_torch.ops import _build

if TYPE_CHECKING:  # ops/scoring.py imports this module
    from icra2021_multimodal_ad_tpu_torch.ops.scoring import NapStats

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: the variants of csrc/nap_score.cu, by (dtype, wide tiles)
VARIANTS = {(torch.float32, False): 0, (torch.float32, True): 1,
            (torch.bfloat16, False): 2, (torch.bfloat16, True): 3}
#: the batch from which the wide tiles run in both types (128 x 128 fp32,
#: 128 x 256 bf16; below, 64 x 64): where they measured faster on the H100
WIDE_MIN_B = 1024


def variant_for(dtype: torch.dtype, b: int) -> int:
    """The kernel variant that a batch of b rows on a `dtype` pack
    launches."""
    return VARIANTS[(dtype, b >= WIDE_MIN_B)]


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
    return lib


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
    elif variant not in (VARIANTS[(dtype, False)], VARIANTS[(dtype, True)]):
        raise ValueError(f"variant {variant} does not take a {dtype} pack")
    xf = x.float()
    if xf.stride(1) != 1:
        xf = xf.contiguous()
    out = torch.empty(b, dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    lib = _lib()
    xc = _build.padded_empty(b, lib.nap_score_xc_cols(variant, pack.k),
                             dtype, x.device)
    n_tiles = -(-pack.j // lib.nap_score_tile_j(variant))
    partial = torch.empty((n_tiles, b), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.nap_score(
            variant, xf.data_ptr(), xf.stride(0), pack.vt.data_ptr(),
            pack.vt.stride(0), pack.mu.data_ptr(), pack.std_mu.data_ptr(),
            pack.inv_std.data_ptr(), xc.data_ptr(), xc.stride(0),
            partial.data_ptr(), out.data_ptr(), b, pack.k, pack.j,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("nap_score kernel launch failed: "
                           + lib.nap_score_error_string(err).decode())
    nap_score.launches += 1
    return out


nap_score.launches = 0
