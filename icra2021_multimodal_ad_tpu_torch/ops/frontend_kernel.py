"""The robot tick's front end in one hand-written kernel: native sensor
payloads to fused (B, 1728) fp32 windows.

`frontend_fuse` launches `csrc/frontend_fuse.cu`, the fixed-range
normalization of `ops/fusion.normalize_mods` and `ops/fusion.fuse(sensor=
"All")` in one launch; `frontend_fuse_plain` is its plain version, those
stock ops.  The kernel replaces no TPU kernel (the JAX package's front end
is plain jnp, which XLA fuses): the stock ops are about 45 launches at
B = 10 against a bound under 1 us, see the source's note.
`frontend_fuse.launches` counts the launches; a captured program
(`utils/graphs.py`) adds what its capture counted at each replay.

Who runs it: `data/streaming._normalize_and_fuse`, the device side of every
tick program (BASE or NAP, an fp32, bf16 or int8 bundle, sequential or
pipelined), of `score_rings_eager` and of `hsr_window_batch` (the live
guard, `get_realtime_dataloader`, a NAP fit over the realtime frontend),
chooses by device alone: on the card it always launches the kernel, on
payloads `stage` has put in the form the kernel reads (a no-op for a tick
program's staging; frames of another size are resized there, before the
kernel's normalization, as `normalize_mods` orders it), and on the CPU it
runs the plain version, which the tests use.  Payloads the kernel cannot
read even so raise.  The rest never reaches this module: `ops/serving.py`'s
request paths, which fuse in the bundle's compute dtype where this kernel
fuses in fp32 alone (so those paths are kept apart, not adapted), and the
offline loaders `data/dataset.py` and `data/fixture.py`, whose
normalization differs.
"""

from __future__ import annotations

import ctypes

import torch

from icra2021_multimodal_ad_tpu_torch.ops import _build
from icra2021_multimodal_ad_tpu_torch.ops.fusion import (
    FusionParams,
    fuse,
    normalize_mods,
)
from icra2021_multimodal_ad_tpu_torch.ops.image import resize_bilinear
from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils import graphs

#: the fused window's width: rgb 0-1023, depth 1024-1535, force 1536-1599,
#: mic 1600-1727
FEAT = 1728
#: the convs the kernel reads, in the order of its parameter list
CONVS = ("rgb1", "rgb2", "rgb3", "dep1", "dep2", "dep3", "lid1", "lid2")
_FRAME_DTYPES = (torch.uint8, torch.float32)


def shapes_fit(r, d, t, m) -> bool:
    """Whether the payloads are what the kernel reads: r (B, 32, 32, 3)
    HWC and d (B, 1, 32, 32), each uint8 or fp32, t (B, 1) and m (B, 1,
    13) fp32, B >= 1, all contiguous."""
    b = r.shape[0]
    return (b >= 1 and tuple(r.shape) == (b, 32, 32, 3)
            and tuple(d.shape) == (b, 1, 32, 32)
            and tuple(t.shape) == (b, 1) and tuple(m.shape) == (b, 1, 13)
            and r.dtype in _FRAME_DTYPES and d.dtype in _FRAME_DTYPES
            and t.dtype == torch.float32 and m.dtype == torch.float32
            and all(v.is_contiguous() for v in (r, d, t, m)))


def stage(r, d, t, m):
    """The payloads as `frontend_fuse` reads them, on their device: frames
    other than uint8 in fp32, frames of another size than 32 x 32 cast and
    resized as `normalize_mods` casts and resizes them, t and m in fp32,
    all contiguous.  A no-op for a tick program's staged inputs."""
    r, d = (v if v.dtype == torch.uint8 else v.float() for v in (r, d))
    if tuple(r.shape[1:3]) != (32, 32):
        r = resize_bilinear(r.float().permute(0, 3, 1, 2),
                            (32, 32)).permute(0, 2, 3, 1)
    if tuple(d.shape[-2:]) != (32, 32):
        d = resize_bilinear(d.float(), (32, 32))
    return tuple(v.contiguous() for v in (r, d, t.float(), m.float()))


def frontend_fuse_plain(params: FusionParams, r, d, t, m) -> torch.Tensor:
    """The stock ops: the camera's HWC frames to CHW, `normalize_mods`
    (frames of another size resized), `fuse(sensor="All")`."""
    r, d, t, m = normalize_mods(r.permute(0, 3, 1, 2).contiguous(), d, t, m)
    return fuse(params, sensor="All", r=r, d=d, t=t, m=m)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p,
             ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("frontend_fuse")
    if lib.frontend_fuse.argtypes is None:
        lib.frontend_fuse.argtypes = _ARGTYPES
        lib.frontend_fuse.restype = ctypes.c_int
        lib.frontend_fuse_error_string.argtypes = [ctypes.c_int]
        lib.frontend_fuse_error_string.restype = ctypes.c_char_p
    return lib


def frontend_fuse(params: FusionParams, r, d, t, m) -> torch.Tensor:
    """Fused (B, 1728) fp32 windows of one batch's payloads (`shapes_fit`)
    on CUDA, in one launch on the current stream; raises on anything else,
    and if the launch fails."""
    if r.device.type != "cuda" or any(v.device != r.device for v in (d, t, m)):
        raise ValueError("frontend_fuse runs on one cuda device, not on "
                         + ", ".join(str(v.device) for v in (r, d, t, m)))
    if not shapes_fit(r, d, t, m):
        raise ValueError(
            "frontend_fuse takes contiguous r (B, 32, 32, 3) and d (B, 1, "
            "32, 32) of uint8 or fp32, t (B, 1) and m (B, 1, 13) fp32; got "
            + ", ".join(f"{tuple(v.shape)} {v.dtype}" for v in (r, d, t, m)))
    ptrs = []
    for name in CONVS:
        for k in ("w", "b"):
            p = getattr(params, name)[k]
            if (p.dtype != torch.float32 or not p.is_contiguous()
                    or p.device != r.device):
                raise ValueError(f"params.{name}[{k!r}] must be contiguous "
                                 f"fp32 on {r.device}")
            ptrs.append(p.data_ptr())
    b = r.shape[0]
    out = torch.empty((b, FEAT), dtype=torch.float32, device=r.device)
    lib = _lib()
    with torch.cuda.device(r.device):  # the launch goes to the current device
        err = lib.frontend_fuse(
            r.data_ptr(), int(r.dtype == torch.uint8), d.data_ptr(),
            int(d.dtype == torch.uint8), t.data_ptr(), m.data_ptr(),
            (ctypes.c_void_p * len(ptrs))(*ptrs), out.data_ptr(), b,
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError("frontend_fuse kernel launch failed: "
                           + lib.frontend_fuse_error_string(err).decode())
    frontend_fuse.launches += 1
    return out


graphs.counted(frontend_fuse, "launches")
