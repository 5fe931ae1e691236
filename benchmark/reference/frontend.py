"""The robot's window frontend in plain PyTorch, in the dtype asked for:
the mic ring's wave, MFCC, the fixed-range normalization and the fusion
convs that turn one tick's ring snapshots into (B, 1728) windows.

The semantics are the reference's realtime path (its utils/
data_loaders.py:676-737 and test_file/realtime_tester.py): librosa's MFCC
(centred STFT with reflect padding, periodic Hann window, power spectrum,
Slaney mel filterbank, `power_to_db(ref=max, top_db=80)`, orthonormal
DCT-II, 13 coefficients), the last B frames of the mic's wave floored to
whole 0.1 s windows from its oldest side, images and force mapped from
their fixed ranges and the mic by its batch min-max onto [-1, 1], and the
fusion projection's convs.  The constants are computed here in float64.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SR = 44100
N_FFT = 4410
N_MELS = 128
N_MFCC = 13


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log = (min_log_mel
               + np.log(np.maximum(f, 1e-300) / min_log_hz) / logstep)
    return np.where(f >= min_log_hz, log, f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@lru_cache(maxsize=2)
def mel_filterbank() -> np.ndarray:
    """(128, 2206) Slaney-normalized triangular filters, float64."""
    freqs = np.linspace(0, SR / 2.0, 1 + N_FFT // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2.0),
                                N_MELS + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (hz[2:] - hz[:-2]))[:, None]


@lru_cache(maxsize=2)
def dct_ortho() -> np.ndarray:
    """(13, 128) orthonormal DCT-II, float64."""
    k = np.arange(N_MFCC)[:, None]
    n = np.arange(N_MELS)[None, :]
    m = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2.0 * N_MELS))
    m[0] /= math.sqrt(2.0)
    return m * math.sqrt(1.0 / (2.0 * N_MELS))


def floored_wave(chunks: Sequence[np.ndarray]) -> np.ndarray:
    """The ring's int16 chunks joined, floored to whole 0.1 s windows
    from the oldest side."""
    y = np.concatenate([np.asarray(c, dtype=np.int16) for c in chunks])
    return y[len(y) - (len(y) // N_FFT) * N_FFT:]


def mfcc_last(waves: torch.Tensor, b: int,
              dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(n, b, 13) MFCC frames: the last b frames of each of n waves of
    one length, each wave's dB reference its own maximum."""
    y = waves.to(dtype)
    n, length = y.shape
    pad = N_FFT // 2
    y = F.pad(y[:, None, :], (pad, N_FFT - pad), mode="reflect")[:, 0]
    n_frames = 1 + (length + 2 * pad - N_FFT) // N_FFT
    frames = y[:, :n_frames * N_FFT].reshape(n, n_frames, N_FFT)
    window = (0.5 - 0.5 * torch.cos(
        2.0 * math.pi * torch.arange(N_FFT, dtype=torch.float64,
                                     device=y.device) / N_FFT)).to(dtype)
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    fb = torch.from_numpy(mel_filterbank()).to(y.device, dtype)
    mel = power @ fb.t()                                   # (n, frames, 128)
    ref = mel.amax(dim=(1, 2), keepdim=True).clamp_min(1e-10)
    db = 10.0 * torch.log10(mel.clamp_min(1e-10)) - 10.0 * torch.log10(ref)
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    mfcc = db @ torch.from_numpy(dct_ortho()).to(y.device, dtype).t()
    return mfcc[:, n_frames - b:, :]


def _minmax(v: torch.Tensor, lo, hi) -> torch.Tensor:
    return 2.0 * (v - lo) / (hi - lo) - 1.0


def fuse_ticks(fusion: Dict[str, Dict[str, torch.Tensor]],
               hand: torch.Tensor, depth: torch.Tensor, force: torch.Tensor,
               mfcc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(n * B, 1728) windows of n ticks of B rows each: hand (n, B, 32, 32,
    3) and depth (n, B, 32, 32) uint8, force (n, B) in newtons, mfcc (n, B,
    13); the mic normalized over each tick's frames."""
    n, b = force.shape
    p = {k: {kk: vv.to(hand.device, dtype) for kk, vv in v.items()}
         for k, v in fusion.items()}
    r = _minmax(hand.to(dtype).reshape(n * b, 32, 32, 3).permute(0, 3, 1, 2),
                0.0, 255.0)
    d = _minmax(depth.to(dtype).reshape(n * b, 1, 32, 32), 0.0, 255.0)
    t = _minmax(force.to(dtype).reshape(n * b, 1), 0.0, 400.0)
    m = mfcc.to(dtype)
    lo = m.amin(dim=(1, 2), keepdim=True)
    hi = m.amax(dim=(1, 2), keepdim=True)
    m = _minmax(m, lo, hi).reshape(n * b, 1, N_MFCC)

    def conv2(x, name, stride, padding):
        return F.relu(F.conv2d(x, p[name]["w"], p[name]["b"], stride=stride,
                               padding=padding))

    def conv1(x, name, stride, padding):
        return F.relu(F.conv1d(x, p[name]["w"], p[name]["b"], stride=stride,
                               padding=padding))

    rgb = conv2(conv2(conv2(r, "rgb1", 2, 0), "rgb2", 1, 1), "rgb3", 2, 0)
    dep = conv2(conv2(conv2(d, "dep1", 2, 0), "dep2", 1, 1), "dep3", 2, 0)
    frc = t[:, :, None, None].expand(n * b, 1, 8, 8)
    mic = conv1(conv1(m, "lid1", 9, 9), "lid2", 2, 0)
    mic = mic.reshape(n * b, 2, 8, 1).expand(n * b, 2, 8, 8)
    return torch.cat([x.reshape(n * b, -1) for x in (rgb, dep, frc, mic)],
                     dim=1)


def tick_windows(fusion, ticks: List[dict], b: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """(len(ticks) * b, 1728) windows of ticks given as ring snapshots:
    {"force" (b,), "hand" (b, 32, 32, 3), "depth" (b, 32, 32), "chunks"
    [int16 arrays]}, grouped by wave length so each group's MFCC is one
    batched call."""
    waves = [floored_wave(t["chunks"]) for t in ticks]
    out = [None] * len(ticks)
    for length in sorted({len(w) for w in waves}):
        idx = [i for i, w in enumerate(waves) if len(w) == length]
        mf = mfcc_last(torch.from_numpy(np.stack([waves[i] for i in idx]))
                       .to(device), b, dtype)
        stack = lambda key: torch.from_numpy(  # noqa: E731
            np.stack([np.asarray(ticks[i][key]) for i in idx])).to(device)
        x = fuse_ticks(fusion, stack("hand"), stack("depth"),
                       stack("force").to(torch.float64), mf, dtype)
        for j, i in enumerate(idx):
            out[i] = x[j * b:(j + 1) * b]
    return torch.cat(out)
