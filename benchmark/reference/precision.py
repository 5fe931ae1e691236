"""The precisions the reference runs in: float64 as the reference, and the
controls' step below the configurations' fp32 with TF32 off, which is fp32
storage with TF32 matrix products and convolutions on the card.  A split
control lowers one part of the reference only: `tf32_ae` runs the tick's
frontend (MFCC, fusion) in fp32 and the autoencoder and its score in TF32,
the step a kernel of the autoencoder alone would take."""

from __future__ import annotations

import contextlib

import torch

#: name -> (storage dtype, TF32 products)
PRECISIONS = {"float64": (torch.float64, False),
              "float32": (torch.float32, False),
              "tf32": (torch.float32, True)}

#: split controls: name -> {part: the precision that part runs in}
SPLITS = {"tf32_ae": {"frontend": "float32", "ae": "tf32"}}


def part(name: str, which: str) -> str:
    """The precision that part `which` (`frontend`, `ae`) of the reference
    runs in under `name`: a split control's for that part, else `name`."""
    return SPLITS[name][which] if name in SPLITS else name


@contextlib.contextmanager
def precision(name: str):
    """Yields the storage dtype of `name`, with TF32 set as it asks for the
    block and restored after."""
    dtype, tf32 = PRECISIONS[name]
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield dtype
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
