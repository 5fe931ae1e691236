"""Multimodal fusion frontend: the fixed random conv projection that turns
(RGB, depth, force, mic[, LiDAR]) windows into fused feature vectors.

PyTorch counterpart of `icra2021_multimodal_ad_tpu/ops/fusion.py`, with the
same layer shapes:

  RGB   (B,3,32,32) -> Conv2d(3,16,k2,s2) -> Conv2d(16,16,k3,s1,p1)
                     -> Conv2d(16,16,k2,s2) -> (B,16,8,8)   = 1024 feat
  depth (B,1,32,32) -> Conv2d(1,8,k2,s2) -> Conv2d(8,8,k3,s1,p1)
                     -> Conv2d(8,8,k2,s2)  -> (B,8,8,8)     = 512
  force (B,1)       -> broadcast           -> (B,1,8,8)     = 64
  mic   (B,1,13)    -> Conv1d(1,8,k18,s9,p9) -> Conv1d(8,16,k2,s2)
                     -> reshape (B,2,8,1) broadcast -> (B,2,8,8) = 128
  LiDAR (B,1,963)   -> 5x Conv1d stack -> (B,32,8,1) broadcast -> 2048
  All:  [rgb, depth, force, mic] flattened channel-major -> 1728

The mic path drives the LiDAR convs `lid1`/`lid2`, as the reference does.
`fusion_init(seed)` draws the weights JAX draws for
`fusion_init(jax.random.PRNGKey(seed))`, bit for bit, through the numpy
replay of JAX's PRNG (`utils/jax_prng.py`).  The convs are stock
`F.conv2d`/`F.conv1d` (cuDNN on the card) in fp32 with TF32 off; on the
card the realtime tick normalizes and fuses in one hand-written kernel
instead (`ops/frontend_kernel.py`), whose plain version is
`normalize_mods` + `fuse(sensor="All")`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from icra2021_multimodal_ad_tpu_torch.ops.image import (
    norm_minmax_global,
    resize_bilinear,
)
from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils import jax_prng
from icra2021_multimodal_ad_tpu_torch.utils.device import resolve_device


class FusionParams(NamedTuple):
    """Each field is {"w": OIHW or OIH weight, "b": bias} on one device."""

    rgb1: dict
    rgb2: dict
    rgb3: dict
    dep1: dict
    dep2: dict
    dep3: dict
    lid1: dict
    lid2: dict
    lid3: dict
    lid4: dict
    lid5: dict

    def to(self, device) -> "FusionParams":
        return FusionParams(*({k: v.to(device) for k, v in p.items()}
                              for p in self))


#: (field, out channels, in channels, kernel) in the order of JAX's split
_SHAPES = (
    ("rgb1", 16, 3, (2, 2)), ("rgb2", 16, 16, (3, 3)),
    ("rgb3", 16, 16, (2, 2)),
    ("dep1", 8, 1, (2, 2)), ("dep2", 8, 8, (3, 3)), ("dep3", 8, 8, (2, 2)),
    ("lid1", 8, 1, (18,)), ("lid2", 16, 8, (2,)), ("lid3", 32, 16, (2,)),
    ("lid4", 16, 32, (3,)), ("lid5", 32, 16, (2,)),
)


def _init_conv(key: np.ndarray, out_ch: int, in_ch: int, kernel) -> dict:
    """torch's Conv default init, U(+-1/sqrt(fan_in)), drawn as JAX draws
    it: one split, weight from the first key, bias from the second."""
    k_w, k_b = jax_prng.split(key)
    bound = 1.0 / (in_ch * int(np.prod(kernel))) ** 0.5
    return {"w": jax_prng.uniform(k_w, (out_ch, in_ch) + tuple(kernel),
                                  -bound, bound),
            "b": jax_prng.uniform(k_b, (out_ch,), -bound, bound)}


def fusion_init(seed: int, device="cuda") -> FusionParams:
    """The fusion projection of `seed` on `device`, the card unless the
    caller asks for the CPU: bit-equal to the JAX package's
    `fusion_init(jax.random.PRNGKey(seed))`.  The split is 13-way, as
    there; the last two keys are never drawn."""
    dev = resolve_device(device)
    ks = jax_prng.split(jax_prng.prng_key(seed), 13)
    return FusionParams(**{
        name: {k: torch.from_numpy(v).to(dev)
               for k, v in _init_conv(ks[i], o, c, kernel).items()}
        for i, (name, o, c, kernel) in enumerate(_SHAPES)})


def _conv2d(x, p, stride, padding):
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


def _conv1d(x, p, stride, padding):
    return F.conv1d(x, p["w"], p["b"], stride=stride, padding=padding)


def _rgb_path(p: FusionParams, r):
    y = F.relu(_conv2d(r, p.rgb1, 2, 0))
    y = F.relu(_conv2d(y, p.rgb2, 1, 1))
    return F.relu(_conv2d(y, p.rgb3, 2, 0))                     # (B,16,8,8)


def _depth_path(p: FusionParams, d):
    y = F.relu(_conv2d(d, p.dep1, 2, 0))
    y = F.relu(_conv2d(y, p.dep2, 1, 1))
    return F.relu(_conv2d(y, p.dep3, 2, 0))                     # (B,8,8,8)


def _force_path(t):
    # scalar broadcast to an 8x8 plane
    return t[:, :, None, None].expand(t.shape[0], 1, 8, 8)


def _mic_path(p: FusionParams, m):
    # the mic drives the LiDAR 1-d convs
    y = F.relu(_conv1d(m, p.lid1, 9, 9))                        # (B,8,2)
    y = F.relu(_conv1d(y, p.lid2, 2, 0))                        # (B,16,1)
    y = y.reshape(y.shape[0], 2, 8, 1)
    return y.expand(y.shape[0], 2, 8, 8)                        # (B,2,8,8)


def _lidar_path(p: FusionParams, l):
    y = F.relu(_conv1d(l, p.lid1, 9, 9))
    y = F.relu(_conv1d(y, p.lid2, 2, 0))
    y = F.relu(_conv1d(y, p.lid3, 2, 0))
    y = F.relu(_conv1d(y, p.lid4, 2, 3))
    y = F.relu(_conv1d(y, p.lid5, 2, 0))                        # (B,32,8)
    y = y.reshape(y.shape[0], 32, 8, 1)
    return y.expand(y.shape[0], 32, 8, 8)                       # (B,32,8,8)


def normalize_mods(r, d, t, m):
    """Fixed-range normalization of native sensor payloads (the realtime
    `norm_vec`): images [0, 255] -> [-1, 1], force [0, 400] -> [-1, 1], mic
    frames by their global min-max -> [-1, 1]; camera frames of another
    size are resized bilinearly to 32 x 32 first.  Integer frames are cast
    to fp32 on their device.  Returns fp32 (r, d, t, m)."""
    if not r.is_floating_point():
        r = r.float()
    if not d.is_floating_point():
        d = d.float()
    if tuple(r.shape[-2:]) != (32, 32):
        r = resize_bilinear(r, (32, 32))
    if tuple(d.shape[-2:]) != (32, 32):
        d = resize_bilinear(d, (32, 32))
    r = norm_minmax_global(r, in_lo=0.0, in_hi=255.0)
    d = norm_minmax_global(d, in_lo=0.0, in_hi=255.0)
    t = norm_minmax_global(t, in_lo=0.0, in_hi=400.0)
    m = norm_minmax_global(m)
    return r, d, t, m


def fuse(params: FusionParams, *, sensor: str = "All",
         r: Optional[torch.Tensor] = None, d: Optional[torch.Tensor] = None,
         l: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
         m: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched fusion; returns (B, feat) fp32 features.

    sensor='All' flattens [rgb, depth, force, mic] channel-major in the
    order rr, dd, tt, mm -> (B, 1728).  A single sensor returns its branch,
    flattened."""
    if sensor == "All":
        b = (r if r is not None else d).shape[0]
        out = torch.cat([_rgb_path(params, r).reshape(b, -1),
                         _depth_path(params, d).reshape(b, -1),
                         _force_path(t).reshape(b, -1),
                         _mic_path(params, m).reshape(b, -1)], dim=1)
    elif sensor == "hand_camera":
        out = _rgb_path(params, r)
    elif sensor == "head_depth":
        out = _depth_path(params, d)
    elif sensor == "force_torque":
        out = _force_path(t)
    elif sensor == "mic":
        out = _mic_path(params, m)
    elif sensor == "LiDAR":
        out = _lidar_path(params, l)
    else:
        raise ValueError(f"unknown sensor: {sensor}")
    return out.reshape(out.shape[0], -1)
