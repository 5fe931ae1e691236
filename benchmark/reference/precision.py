"""The precisions the reference runs in: float64 as the reference, and the
controls' step below each configuration's precision.

Below fp32 with TF32 off is fp32 storage with TF32 matrix products and
convolutions on the card (`tf32`).  Below bf16, the serving path's type,
is `e4m3`: fp32 storage, and every matrix product and convolution takes
its two operands rounded to float8 e4m3, each tensor under its own scale
(its largest magnitude onto e4m3's largest, 448), the products summed in
fp32 with TF32 off; the bias is added in fp32.

A split control lowers one part of the reference only (its parts: the
tick's `frontend`, MFCC and fusion; the `ae`, the autoencoder and its
score; and the NAP `fit`).  `tf32_ae` runs the frontend in fp32 and the
autoencoder and its score in TF32, the step a kernel of the autoencoder
alone would take.  `e4m3` lowers what the bf16 tick runs in bf16, the
autoencoder and the NAP score, and leaves its frontend in fp32 and its
fit to the float64 reference, as the program fuses and fits in fp32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

#: name -> (storage dtype, TF32 products, e4m3 operands)
PRECISIONS = {"float64": (torch.float64, False, False),
              "float32": (torch.float32, False, False),
              "tf32": (torch.float32, True, False),
              "e4m3": (torch.float32, False, True)}

#: split controls: name -> {part: the precision that part runs in}
SPLITS = {"tf32_ae": {"frontend": "float32", "ae": "tf32"},
          "e4m3": {"frontend": "float32", "fit": "float64", "ae": "e4m3"}}

#: float8 e4m3's largest finite magnitude
E4M3_MAX = 448.0


def part(name: str, which: str) -> str:
    """The precision that part `which` (`frontend`, `fit`, `ae`) of the
    reference runs in under `name`: a split control's for that part, else
    `name`."""
    return SPLITS[name].get(which, name) if name in SPLITS else name


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under a per-tensor scale, its largest
    magnitude onto E4M3_MAX, and brought back to its own type."""
    amax = float(t.detach().abs().max()) if t.numel() else 0.0
    scale = amax / E4M3_MAX if amax > 0 else 1.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


#: the products and convolutions whose first two tensor arguments (the
#: input and the weight) `E4m3Operands` rounds
_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.mm, F.linear, F.conv1d, F.conv2d}


class E4m3Operands(TorchFunctionMode):
    """While active, every product and convolution of `_PRODUCTS` takes
    its two operands rounded by `round_e4m3`; everything else runs as
    written."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS and len(args) >= 2:
            args = (round_e4m3(args[0]), round_e4m3(args[1]), *args[2:])
        return func(*args, **kwargs)


@contextlib.contextmanager
def precision(name: str):
    """Yields the storage dtype of `name`, with TF32 set as it asks for the
    block and restored after, and its operands rounded where it says so."""
    dtype, tf32, e4m3 = PRECISIONS[name]
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with E4m3Operands() if e4m3 else contextlib.nullcontext():
            yield dtype
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
