"""The autoencoder in plain PyTorch: eval-mode forward, RaPP diffs, and one
whole training job, in the dtype asked for (float64 as the reference).

The model is the reference's (its models/auto_encoder.py, modules/
fc_module.py, layers/fc_layer.py): FC layers Linear -> LeakyReLU(0.2) ->
BatchNorm1d (eps 1e-5, momentum 0.1; activation before BN), a module's last
layer Linear alone.  Training: MSE with sum reduction, Adam (betas 0.9 /
0.999, eps 1e-8), each epoch's full batches in the trainer's order, then the
tail batch; validation in eval mode; the model with the lowest validation
mean kept (novelty_detection.py:92-125).  Nothing here is the program's:
the weights come in as the run drew them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import prng

LEAKY_SLOPE = 0.2
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def leaf_names(weights: List[dict]) -> List[str]:
    """One name per trained leaf: `<module>.<layer>.<w|b|bn_weight|
    bn_bias>`."""
    names = []
    for l in weights:
        base = f"{l['module']}.{l['index']}"
        names += [f"{base}.w", f"{base}.b"]
        if l["bn"] is not None:
            names += [f"{base}.bn_weight", f"{base}.bn_bias"]
    return names


class Ae:
    """The model's leaves and BN buffers as plain tensors of `dtype` on
    `device`."""

    def __init__(self, weights: List[dict], dtype: torch.dtype, device):
        cast = lambda t: t.detach().to(device, dtype).clone()  # noqa: E731
        self.modules: Dict[str, List[dict]] = {"encoder": [], "decoder": []}
        for l in weights:
            layer = {"w": cast(l["w"]), "b": cast(l["b"]), "leaky": l["leaky"],
                     "bn": None}
            if l["bn"] is not None:
                layer["bn"] = {k: cast(v) for k, v in l["bn"].items()}
            self.modules[l["module"]].append(layer)

    def leaves(self) -> List[torch.Tensor]:
        out = []
        for m in ("encoder", "decoder"):
            for l in self.modules[m]:
                out += [l["w"], l["b"]]
                if l["bn"] is not None:
                    out += [l["bn"]["weight"], l["bn"]["bias"]]
        return out

    def buffers(self) -> List[torch.Tensor]:
        return [l["bn"][k] for m in ("encoder", "decoder")
                for l in self.modules[m] if l["bn"] is not None
                for k in ("mean", "var")]

    def module(self, name: str, x: torch.Tensor, train: bool = False
               ) -> List[torch.Tensor]:
        """Every layer's output of module `name` on x (the taps)."""
        taps = []
        for l in self.modules[name]:
            x = x @ l["w"].t() + l["b"]
            if l["leaky"]:
                x = torch.nn.functional.leaky_relu(x, LEAKY_SLOPE)
            bn = l["bn"]
            if bn is not None:
                if train:
                    mean = x.mean(dim=0)
                    var = x.var(dim=0, unbiased=False)
                    with torch.no_grad():
                        n = x.shape[0]
                        bn["mean"].mul_(1 - BN_MOMENTUM).add_(
                            BN_MOMENTUM * mean)
                        bn["var"].mul_(1 - BN_MOMENTUM).add_(
                            BN_MOMENTUM * var * (n / (n - 1)))
                else:
                    mean, var = bn["mean"], bn["var"]
                x = ((x - mean) / torch.sqrt(var + BN_EPS) * bn["weight"]
                     + bn["bias"])
            taps.append(x)
        return taps

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        z = self.module("encoder", x, train)[-1]
        return self.module("decoder", z, train)[-1]

    @torch.no_grad()
    def diffs(self, x: torch.Tensor) -> List[torch.Tensor]:
        """RaPP diffs of eval-mode x: x_hat - x, then each encoder layer's
        output on x_hat less its output on x."""
        taps_x = self.module("encoder", x)
        x_hat = self.module("decoder", taps_x[-1])[-1]
        taps_h = self.module("encoder", x_hat)
        return [x_hat - x] + [h - t for t, h in zip(taps_x, taps_h)]


@torch.no_grad()
def concat_diffs(ae: Ae, x: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """(n, K) concatenated diffs, computed `rows` at a time."""
    return torch.cat([torch.cat(ae.diffs(x[i:i + rows]), dim=1)
                      for i in range(0, x.shape[0], rows)])


@torch.no_grad()
def base_losses(ae: Ae, x: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """Per-window squared reconstruction error, summed over the window."""
    return torch.cat([((ae.forward(x[i:i + rows]) - x[i:i + rows]) ** 2)
                      .sum(dim=1) for i in range(0, x.shape[0], rows)])


def train_job(weights: List[dict], train_x: torch.Tensor,
              valid_x: torch.Tensor, seed: int, batch: int, epochs: int,
              lr: float, dtype: torch.dtype, fault: Optional[str] = None
              ) -> dict:
    """One whole training job from `weights`: {"train_history",
    "valid_history" (per-epoch means), "first_grad" (each leaf's gradient
    of step 1, as Adam's first moment holds it), "change3" (each leaf's
    change after step 3), "change_e2" (after the second epoch), "best" and "best_buffers" (the kept leaves and
    BN statistics), "best_epoch", "start" (the leaves before step 1)}.

    `fault` plants one of the controls' faults where the program would
    have it: "stale" (every step leaves the state as it was),
    "half_batch" (each step's loss over the first half of its rows, as
    a mean over them scaled back to the batch), "altered" (the reported
    losses altered where they are produced)."""
    dev = train_x.device
    ae = Ae(weights, dtype, dev)
    leaves = ae.leaves()
    for t in leaves:
        t.requires_grad_(True)
    start = [t.detach().clone() for t in leaves]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    x_train, x_valid = train_x.to(dtype), valid_x.to(dtype)
    n, n_valid = x_train.shape[0], x_valid.shape[0]
    out = {"train_history": [], "valid_history": [], "start": start}
    best_loss, step = float("inf"), 0
    for epoch in range(epochs):
        order = torch.from_numpy(prng.epoch_order(seed, epoch, n)).to(dev)
        shuffled = x_train[order]
        total = 0.0
        for i in range(0, n, batch):
            xb = shuffled[i:i + batch]
            if fault == "half_batch":
                half = xb[: xb.shape[0] // 2]
                loss = ((ae.forward(half, train=True) - half) ** 2).sum() * (
                    xb.shape[0] / half.shape[0])
            else:
                loss = ((ae.forward(xb, train=True) - xb) ** 2).sum()
            grads = torch.autograd.grad(loss, leaves)
            step += 1
            with torch.no_grad():
                for p, g, mi, vi in zip(leaves, grads, m, v):
                    mi.mul_(BETAS[0]).add_((1 - BETAS[0]) * g)
                    vi.mul_(BETAS[1]).add_((1 - BETAS[1]) * g * g)
                    if fault == "stale":
                        continue
                    c1 = 1 - BETAS[0] ** step
                    c2 = (1 - BETAS[1] ** step) ** 0.5
                    p.sub_(lr / c1 * mi / (vi.sqrt() / c2 + ADAM_EPS))
            if step == 1:
                out["first_grad"] = [mi / (1 - BETAS[0]) for mi in m]
            if step == 3:
                out["change3"] = [p.detach() - s
                                  for p, s in zip(leaves, start)]
            total += float(loss.detach())
        with torch.no_grad():
            valid = sum(float(((ae.forward(x_valid[i:i + batch])
                                - x_valid[i:i + batch]) ** 2).sum())
                        for i in range(0, n_valid, batch))
        train_mean, valid_mean = total / n, valid / n_valid
        if epoch == 1:
            out["change_e2"] = [p.detach().clone() - s
                                for p, s in zip(leaves, start)]
        if fault == "altered":
            train_mean, valid_mean = train_mean * 1.01, valid_mean * 1.01
        out["train_history"].append(train_mean)
        out["valid_history"].append(valid_mean)
        if valid_mean < best_loss:
            best_loss = valid_mean
            out["best"] = [p.detach().clone() for p in leaves]
            out["best_buffers"] = [b.clone() for b in ae.buffers()]
            out["best_epoch"] = epoch
    return out


def with_state(weights: List[dict], leaves: Sequence[torch.Tensor],
               buffers: Sequence[torch.Tensor]) -> List[dict]:
    """`weights`' layout holding other leaves and BN buffers, in the order
    of `Ae.leaves` and `Ae.buffers`."""
    leaves, buffers = iter(leaves), iter(buffers)
    out = []
    for l in weights:
        layer = {**l, "w": next(leaves), "b": next(leaves)}
        if l["bn"] is not None:
            layer["bn"] = {"weight": next(leaves), "bias": next(leaves)}
            layer["bn"]["mean"] = next(buffers)
            layer["bn"]["var"] = next(buffers)
        out.append(layer)
    return out


@torch.no_grad()
def valid_mean(weights: List[dict], x: torch.Tensor, batch: int,
               dtype: torch.dtype) -> float:
    """The eval-mode validation loss of a model, its sum over the rows
    over their count, as the trainer's validation pass defines it."""
    ae = Ae(weights, dtype, x.device)
    x = x.to(dtype)
    total = sum(float(((ae.forward(x[i:i + batch]) - x[i:i + batch]) ** 2)
                      .sum()) for i in range(0, x.shape[0], batch))
    return total / x.shape[0]
