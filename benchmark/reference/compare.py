"""The numbers that decide `correct`, each a gap between the program's
answer and the reference's, held to a limit of its own."""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import torch


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def widest_rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest |prog - ref| / |ref| over the answers; inf where the
    program's answer is missing or not finite."""
    prog = prog.to(ref.device, torch.float64).reshape(-1)
    ref = ref.to(torch.float64).reshape(-1)
    if prog.shape != ref.shape or not torch.isfinite(prog).all():
        return float("inf")
    if ref.numel() == 0:
        return 0.0
    return float(((prog - ref).abs() / ref.abs().clamp_min(1e-300)).max())


def median_rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The median over the answers of |prog - ref| / |ref|."""
    prog = prog.to(ref.device, torch.float64).reshape(-1)
    ref = ref.to(torch.float64).reshape(-1)
    if prog.shape != ref.shape or not torch.isfinite(prog).all():
        return float("inf")
    return float(((prog - ref).abs() / ref.abs().clamp_min(1e-300))
                 .median())


def leaf_norm_gap(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
                  masks: Optional[Sequence[torch.Tensor]] = None) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over the larger of the
    reference leaf's norm and the median leaf's norm; with `masks`, each
    leaf's norms over the elements its mask keeps (a leaf it keeps none of
    is left out)."""
    if len(prog) != len(ref):
        return float("inf")
    if masks is None:
        masks = [None] * len(ref)
    p, r = [], []
    for a, b, m in zip(prog, ref, masks):
        a, b = a.to(b.device).double(), b.double()
        if m is not None:
            if not bool(m.any()):
                continue
            a, b = a[m], b[m]
        p.append(float(torch.linalg.vector_norm(a)))
        r.append(float(torch.linalg.vector_norm(b)))
    if not all(math.isfinite(v) for v in p):
        return float("inf")
    if not r:
        return 0.0
    med = sorted(r)[len(r) // 2]
    return max(abs(a - b) / max(b, med, 1e-300) for a, b in zip(p, r))


def moving(first_grad: Sequence[torch.Tensor],
           rel: float = 1e-3) -> List[torch.Tensor]:
    """Per leaf, the elements whose first gradient in the reference is
    above `rel` of the median leaf's gradient per element (its norm over
    the root of its size).  The rest are nought to rounding, as the bias
    of a unit whose activation keeps its sign over the batch is under the
    batch norm that follows it, and Adam moves them by round-off alone."""
    rms = [float(torch.linalg.vector_norm(g.double())) / max(g.numel(), 1)
           ** 0.5 for g in first_grad]
    scale = sorted(rms)[len(rms) // 2]
    return [g.abs() > rel * scale for g in first_grad]
