"""A replay of JAX's default PRNG, so the port draws what JAX draws.

The JAX package seeds everything it draws from `jax.random.PRNGKey(seed)`:
the fusion projection, the model's initial weights, each epoch's shuffle and
the VIB reparameterization noise.  This module reproduces those draws under
JAX's default threefry PRNG with `jax_threefry_partitionable=True` (the
default since JAX 0.5), without JAX:

- `prng_key(seed)` is `jax.random.PRNGKey(seed)` without x64: the key words
  are `[0, seed mod 2**32]`, so `PRNGKey(2**32 + 3)` is `[0, 3]`;
- `split(key, n)` is `jax.random.split(key, n)`: threefry-2x32 of the key
  over the counters `(0, i)`;
- `fold_in(key, data)` is `jax.random.fold_in`: threefry of the key over
  the one counter `(0, data)`;
- `random_bits(key, shape)`: bits `b1 ^ b2` of threefry over the counters
  `(0, i)` in row-major order;
- `uniform(key, shape, lo, hi)` is `jax.random.uniform` in float32 or
  bfloat16.  float32 ORs the top 23 bits into the exponent of 1.0,
  subtracts 1 and rounds `f * (hi - lo) + lo` once, as XLA's fused
  multiply-add does.  bfloat16 has 7 mantissa bits, fewer than 8, so JAX
  draws 8 bits: the low byte of `b1 ^ b2`, its top 7 ORed into the
  exponent of 1.0, then `f * (hi - lo) + lo` with each op rounded to
  bfloat16;
- `permutation(key, n)` is `jax.random.permutation(key, n)`: ceil(3 ln n /
  ln(2**32 - 1)) rounds (1 up to n = 1625, 2 up to n = 2**21), each a
  split, 32 random bits per element and a stable sort on them;
- `normal(key, shape)` is `jax.random.normal` in float32: a uniform in
  (nextafter(-1, 0), 1), then sqrt(2) * erf_inv(u) with XLA's erf_inv
  (M. Giles' single-precision polynomials).  Its log1p is rounded from
  float64 and its Horner steps are fused multiply-adds; XLA's CPU log1p is
  an approximation of its own, so a draw may sit an ulp or so from JAX's
  (tests/test_torch_prng.py states the bound it meets).

Everything above is uint32 arithmetic in numpy, which wraps as XLA's does,
in blocks of `_BLOCK` counters that stay in the CPU's cache.  The bulk
draws, the model's weights and the VIB noise, are also replayed on a card
(`uniform_device`, `normal_device`): torch integer ops, uint32 emulated in
int64 with masks, equal bit for bit to the numpy replay.  On the CPU
`uniform_device` takes the numpy replay, which runs there ~4x faster than
torch's int64 ops.  Their key is a numpy key or a (2,) int64 tensor of its
words on the draw's device: a captured program (the trainer's epoch,
train.py) reads the tensor's words from its buffer at each replay, where a
numpy key's words would be baked into the graph.  Both forms draw the same
bits, and the torch ops copy nothing from the host, so they may be
captured.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF

#: M. Giles, "Approximating the erfinv function", single precision: the
#: coefficients for w < 5 and for w >= 5, highest degree first, as XLA's
#: ErfInv32 (chlo.erf_inv) evaluates them
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
#: the float32 below -1 nearest 0, the low end of normal's uniform
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
_DTYPES = ("float32", "bfloat16")
#: counters per numpy block: 64 K uint32 keep the threefry rounds in cache
_BLOCK = 1 << 16


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Random123), as `jax.random`'s
    `threefry2x32_p`: the key words and their parity form the schedule,
    injected after every 4 rounds with the injection count."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_KS_PARITY))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` (raw key data) without x64."""
    return np.array([0, int(seed) & _M32], dtype=np.uint32)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)`: (n, 2) uint32 keys."""
    b0, b1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)`: threefry of the key over (0, data)."""
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & _M32], np.uint32))
    return np.array([b0[0], b1[0]], dtype=np.uint32)


def _n_elements(shape: Sequence[int]) -> int:
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 32:
        raise ValueError("the replay covers arrays below 2**32 elements")
    return n


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element of `shape`, as the partitionable
    `jax.random.bits`: the flat index is the counter."""
    n = _n_elements(shape)
    out = np.empty(n, np.uint32)
    for start in range(0, n, _BLOCK):
        stop = min(start + _BLOCK, n)
        b0, b1 = threefry2x32(key, np.zeros(stop - start, np.uint32),
                              np.arange(start, stop, dtype=np.uint32))
        out[start:stop] = b0 ^ b1
    return out.reshape(tuple(shape))


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """`jax.random.permutation(key, n)`: int64 (n,)."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def _fma_to_f32(a: np.ndarray, b, c) -> np.ndarray:
    """float32 of the exact a * b + c, rounded once (a fused multiply-add);
    a, b and c are float32 (b and c may be arrays).

    a and b carry 24 significant bits, so a * b is exact in float64; the sum
    with c is exact as s + e (TwoSum).  Rounding s to float32 is then wrong
    only where s falls exactly halfway between two float32 values and e
    says on which side the exact sum lies."""
    p = (np.asarray(a, np.float32).astype(np.float64)
         * np.asarray(b, np.float32).astype(np.float64))
    c64 = np.asarray(c, np.float32).astype(np.float64)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    # the float32 neighbour on the other side of s, and whether s sits
    # exactly between r and it
    toward = np.where(s > r.astype(np.float64), np.float32(np.inf),
                      np.float32(-np.inf)).astype(np.float32)
    other = np.nextafter(r, toward)
    mid = (r.astype(np.float64) + other.astype(np.float64)) / 2
    tie = (s == mid) & (e != 0)
    # at a tie the exact value lies beyond s on the side of e's sign
    go_other = tie & ((e > 0) == (other > r))
    return np.where(go_other, other, r)


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the float32 of its nearest bfloat16 (ties to even)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, dtype: str = "float32") -> np.ndarray:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)` for dtype
    "float32" or "bfloat16"; bfloat16 draws come back as the float32 of
    each bfloat16 value (exact)."""
    if dtype not in _DTYPES:
        raise ValueError(f"uniform replays {_DTYPES}, not {dtype!r}")
    bits = random_bits(key, shape).reshape(-1)
    out = np.empty(bits.size, np.float32)
    for start in range(0, bits.size, _BLOCK):
        block = bits[start:start + _BLOCK]
        out[start:start + _BLOCK] = (_uniform_f32(block, minval, maxval)
                                     if dtype == "float32" else
                                     _uniform_bf16(block, minval, maxval))
    return out.reshape(tuple(shape))


def _uniform_f32(bits: np.ndarray, minval: float, maxval: float):
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    lo, hi = np.float32(minval), np.float32(maxval)
    out = _fma_to_f32(f - np.float32(1.0), np.float32(hi - lo), lo)
    return np.maximum(lo, out)


def _uniform_bf16(bits: np.ndarray, minval: float, maxval: float):
    # the low byte, its top 7 bits the mantissa of a bfloat16 in [1, 2)
    f = ((((bits & np.uint32(0xFF)) >> np.uint32(1)) | np.uint32(0x3F80))
         << np.uint32(16)).view(np.float32) - np.float32(1.0)
    lo = _round_bf16(np.float32(minval))
    hi = _round_bf16(np.float32(maxval))
    span = _round_bf16(hi - lo)
    # each bfloat16 op rounds: f * span (exact in float32, 7 and 8
    # significant bits), then the sum with lo
    out = _round_bf16(_round_bf16(f * span) + lo)
    return np.maximum(lo, out)


def _erf_inv_f32(u: np.ndarray) -> np.ndarray:
    """XLA's float32 erf_inv on float32 u in (-1, 1)."""
    u = np.asarray(u, np.float32)
    # float32 -u * u, its log1p rounded from float64
    w = (-np.log1p((-u * u).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    # float32 sqrt, correctly rounded from float64 (torch's CPU float32
    # sqrt is not)
    root = np.sqrt(w.astype(np.float64)).astype(np.float32)
    w = np.where(lt, w - np.float32(2.5),
                 root - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma_to_f32(p, w, np.where(lt, np.float32(c_lt),
                                       np.float32(c_ge)))
    return (p * u).astype(np.float32)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.normal(key, shape, jnp.float32)`."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return (np.float32(_SQRT2_F32) * _erf_inv_f32(u)).astype(np.float32)


# -- the same draws as torch integer ops, for a card --------------------------


#: a JAX key: numpy (2,) uint32 words, or a (2,) int64 tensor of them
Key = Union[np.ndarray, torch.Tensor]


def _threefry_torch(key: Key, x1: torch.Tensor) -> torch.Tensor:
    """`b1 ^ b2` of threefry-2x32 over the counters (0, x1); x1 and the
    result are int64 holding uint32 values.  A tensor key's words stay
    0-d tensors on its device, so nothing reads them on the host."""
    if isinstance(key, torch.Tensor):
        k0, k1 = key[0], key[1]
    else:
        k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = torch.zeros_like(x1) + ks[0]
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0 ^ x1


def _random_bits_torch(key: Key, shape: Sequence[int],
                       device) -> torch.Tensor:
    """`random_bits` on `device`: int64 holding the uint32 bits."""
    n = _n_elements(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _threefry_torch(key, idx).reshape(tuple(shape))


def _as_f32(bits: torch.Tensor) -> torch.Tensor:
    """int64 holding float32 bit patterns below 2**31 -> float32."""
    return bits.to(torch.int32).view(torch.float32)


def _fma_to_f32_torch(a: torch.Tensor, b, c) -> torch.Tensor:
    """`_fma_to_f32` in torch float64: float32 of the exact a * b + c; b
    and c are float32 tensors or float32 values (numpy scalars), which
    enter as Python floats, exactly, with no copy to the device."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor)
                      else float(np.float32(b)))
    c64 = (c.double() if isinstance(c, torch.Tensor)
           else float(np.float32(c)))
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    inf = torch.full_like(r, math.inf)
    other = torch.nextafter(r, torch.where(s > r.double(), inf, -inf))
    mid = (r.double() + other.double()) / 2
    go_other = (s == mid) & (e != 0) & ((e > 0) == (other > r))
    return torch.where(go_other, other, r)


def uniform_device(key: Key, shape: Sequence[int],
                   minval: float = 0.0, maxval: float = 1.0,
                   dtype: str = "float32", device="cpu") -> torch.Tensor:
    """`uniform` on `device`, as a tensor of `dtype` (float32 or
    bfloat16): the numpy replay on the CPU, torch integer ops on a card."""
    if torch.device(device).type == "cpu":
        key = np.asarray(key).astype(np.uint32)  # a CPU tensor key's words
        return torch.from_numpy(uniform(key, shape, minval, maxval,
                                        dtype)).to(getattr(torch, dtype))
    return _uniform_torch(key, shape, minval, maxval, dtype, device)


def _uniform_torch(key: Key, shape: Sequence[int], minval: float,
                   maxval: float, dtype: str, device) -> torch.Tensor:
    """`uniform` as torch integer ops on `device`."""
    if dtype not in _DTYPES:
        raise ValueError(f"uniform replays {_DTYPES}, not {dtype!r}")
    bits = _random_bits_torch(key, shape, device)
    if dtype == "float32":
        f = _as_f32((bits >> 9) | 0x3F800000) - 1.0
        lo, hi = np.float32(minval), np.float32(maxval)
        out = _fma_to_f32_torch(f, np.float32(hi - lo), lo)
        return torch.clamp_min(out, float(lo))
    f = _as_f32((((bits & 0xFF) >> 1) | 0x3F80) << 16) - 1.0
    lo = float(_round_bf16(np.float32(minval)))
    span = float(_round_bf16(_round_bf16(np.float32(maxval)) - lo))
    out = ((f * span).to(torch.bfloat16).float() + lo).to(torch.bfloat16)
    return torch.clamp_min(out, lo)


def _erf_inv_torch(u: torch.Tensor) -> torch.Tensor:
    """`_erf_inv_f32` in torch."""
    w = (-torch.log1p((-u * u).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)

    def coef(i):  # float32 values as Python floats: no upload
        return torch.where(lt, float(np.float32(_ERFINV_LT5[i])),
                           float(np.float32(_ERFINV_GE5[i])))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma_to_f32_torch(p, w, coef(i))
    return p * u


def normal_device(key: Key, shape: Sequence[int],
                  dtype: str = "float32", device="cpu") -> torch.Tensor:
    """`normal` on `device`, as a tensor of `dtype`.  bfloat16 follows
    `_normal_real` in bfloat16: a bfloat16 uniform in (nextafter(-1, 0),
    1), erf_inv in float32 rounded to bfloat16, times bfloat16 sqrt(2)."""
    if dtype == "float32":
        u = uniform_device(key, shape, _NORMAL_LO, 1.0, device=device)
        return _SQRT2_F32 * _erf_inv_torch(u)
    if dtype != "bfloat16":
        raise ValueError(f"normal replays {_DTYPES}, not {dtype!r}")
    lo = -1.0 + 2.0 ** -8  # the bfloat16 above -1 nearest 0
    u = uniform_device(key, shape, lo, 1.0, dtype, device)
    e = _erf_inv_torch(u.float()).to(torch.bfloat16)
    sqrt2 = float(_round_bf16(np.float32(_SQRT2_F32)))
    return (sqrt2 * e.float()).to(torch.bfloat16)
