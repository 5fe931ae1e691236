"""NAP in plain PyTorch: the whitening fit on train diffs and the score
(the reference's utils/metric.py:183-238 and utils/normalize.py).

Fit: centre the diffs, rotate onto the right singular vectors of the
centred matrix (here the eigenvectors of its Gram matrix, descending, cut
to min(n, K): the same rotation, computed in float64), and standardize each
rotated column by its mean and unbiased variance.  Score: the mean over
columns of the whitened row's squares.  A variance floor relative to the
largest variance drops the columns below it, as the port's
`ops/scoring.nap_effective_stats` does.
"""

from __future__ import annotations

from typing import Dict

import torch

#: the cut, relative to the largest variance, above which `whiten_gap`
#: holds a fit to the reference's: the configurations' floor, every
#: direction their scores whiten
WHITEN_ABOVE = 1e-6


def fit(x: torch.Tensor, floor_rel: float = 0.0) -> Dict[str, torch.Tensor]:
    """The whitening of `x`; columns whose variance is at most `floor_rel`
    times the largest are dropped from the score (variance +inf), the
    column count, the mean's denominator, kept.  "raw_var" holds every
    column's variance before the floor."""
    mu = x.mean(dim=0)
    xc = x - mu
    _, v = torch.linalg.eigh(xc.t() @ xc)
    v = v.flip(1)[:, :min(x.shape)]
    rot = xc @ v
    std_mu = rot.mean(dim=0)
    var = raw = ((rot - std_mu) ** 2).sum(dim=0) / max(x.shape[0] - 1, 1)
    if floor_rel:
        var = torch.where(var > floor_rel * var.max(), var,
                          torch.full_like(var, float("inf")))
    return {"mu": mu, "v": v, "std_mu": std_mu, "var": var, "raw_var": raw}


def score(stats: Dict[str, torch.Tensor], x: torch.Tensor,
          rows: int = 4096) -> torch.Tensor:
    out = []
    for i in range(0, x.shape[0], rows):
        t = ((x[i:i + rows] - stats["mu"]) @ stats["v"] - stats["std_mu"])
        out.append((t * t / stats["var"]).mean(dim=1))
    return torch.cat(out)


def mean_gap(got: Dict[str, torch.Tensor],
             ref: Dict[str, torch.Tensor]) -> float:
    """A fit's centring mean against the reference's: the norm of their
    difference over the reference's norm."""
    return float(torch.linalg.vector_norm(got["mu"].double() - ref["mu"])
                 / torch.linalg.vector_norm(ref["mu"]))


def whitened_cov(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 above: float) -> torch.Tensor:
    """The covariance that the fit `got` whitens by (its rotation and its
    variances before any floor, "raw_var"), in the reference fit's
    whitened coordinates over the reference's directions whose variance
    is above `above` times its largest: the identity where `got` is the
    reference.  Each side's variances before the floor, so that a
    direction next to the floor, which one side keeps and the other
    drops, reads as the small gap it is.  NAP's score cannot tell rotations inside a
    space of equal variances apart, and neither can this; a rotation that
    mixes directions of different variances, or a wrong variance, moves
    it off the identity by what it moves a score there."""
    var = ref.get("raw_var", ref["var"]).double()
    keep = var > above * var.max()
    v_s = ref["v"].double()[:, keep]
    g_var = got.get("raw_var", got["var"]).double().to(var.device)
    b = (got["v"].double().to(var.device).t() @ v_s) * g_var.sqrt()[:, None]
    scale = var[keep].rsqrt()
    return (b.t() @ b) * scale[:, None] * scale[None, :]


def whiten_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               above: float = WHITEN_ABOVE) -> float:
    """The fit `got` held to the reference's: the largest entry of
    |whitened_cov - I| over the reference's directions above `above`."""
    a = whitened_cov(got, ref, above)
    a.diagonal().sub_(1.0)
    return float(a.abs().max())
