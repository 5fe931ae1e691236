"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain `extern "C"` interface.  It is compiled
at first use by `nvcc` for `sm_90a` into a shared library under
`build/torch_kernels/` at the repository root and loaded with `ctypes`.  The
library's file name carries a hash of its source, of every shared header
`csrc/*.cuh` and of the compiler flags, so an edited source or header is
rebuilt and a stale library is never loaded.  Nothing here runs at import
time: the CPU tests import every module on a host without `nvcc`.

Every kernel operand and output is a row-major matrix whose rows start on
16-byte boundaries (16-byte copies and TMA need it): `padded_empty` and
`operand` lay tensors out so, padding each row stride where it must.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every library of `names` that is not built yet, one `nvcc`
    per source, all started together.  Returns {name: {"seconds", "log"}}
    for the ones it built; raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    built, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def padded_empty(rows: int, cols: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """An uninitialised (rows, cols) tensor whose row stride is a multiple
    of 16 bytes."""
    per = 16 // dtype.itemsize
    return torch.empty_strided((rows, cols), (-(-cols // per) * per, 1),
                               dtype=dtype, device=device)


def operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """2-D x as a kernel reads it: `dtype`, unit column stride, 16-byte
    aligned rows.  x itself where it is so already, else a padded copy.
    The kernels read no column past the last, so the padding stays
    unwritten."""
    if (x.dtype == dtype and x.stride(1) == 1
            and x.stride(0) % (16 // dtype.itemsize) == 0
            and x.data_ptr() % 16 == 0):
        return x
    return padded_empty(*x.shape, dtype, x.device).copy_(x)
