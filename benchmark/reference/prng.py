"""A frozen copy of the draws the trainer's epoch order comes from:
`jax.random.permutation(fold_in(PRNGKey(seed + 1), epoch), n)`, replayed
in numpy (Threefry-2x32, 20 rounds, as `jax.random`), as the port's
`utils/jax_prng.py` replays it.  The reference needs the order, and the
program draws it from the seed, so the reference draws it again."""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF
_BLOCK = 1 << 16


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
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
    return np.array([0, int(seed) & _M32], dtype=np.uint32)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    b0, b1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & _M32], np.uint32))
    return np.array([b0[0], b1[0]], dtype=np.uint32)


def random_bits(key: np.ndarray, n: int) -> np.ndarray:
    out = np.empty(n, np.uint32)
    for start in range(0, n, _BLOCK):
        stop = min(start + _BLOCK, n)
        b0, b1 = threefry2x32(key, np.zeros(stop - start, np.uint32),
                              np.arange(start, stop, dtype=np.uint32))
        out[start:stop] = b0 ^ b1
    return out


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The trainer's order of its n rows in `epoch`."""
    return permutation(fold_in(prng_key(seed + 1), epoch), n)
