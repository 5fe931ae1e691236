"""Faults planted in the port's trainer, for the controls on the card and
the CPU tests: each acts from a job's second epoch on, the epochs the card
replays as captured graphs (`train.EpochPrograms`; the CPU runs the same
calls eagerly), and leaves the eager first epoch, which the check's first
steps read, as it was.

    with planted("half_batch"):
        ...  # build the cell's entry and run it

Faults: "stale" (each step leaves the weights as they were), "half_batch"
(each step's loss over the first half of its rows, scaled back to the
batch), "stale_order" (every epoch takes the first epoch's order),
"altered" (each epoch's reported means 1 % high).
"""

from __future__ import annotations

import contextlib

FAULTS = ("stale", "half_batch", "stale_order", "altered")


@contextlib.contextmanager
def planted(fault: str):
    import torch

    import icra2021_multimodal_ad_tpu_torch.train as train

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    replaying = [False]
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    init, capture = train.EpochPrograms.__init__, train.EpochPrograms.capture

    def init_(self, *args, **kwargs):
        replaying[0] = False
        init(self, *args, **kwargs)

    def capture_(self):
        # the programs capture after the first epoch's eager launch
        replaying[0] = True
        capture(self)

    patch(train.EpochPrograms, "__init__", init_)
    patch(train.EpochPrograms, "capture", capture_)
    step, order, end = (train.train_step, train.epoch_permutation,
                        train._end_epoch)

    def stale(model, optimizer, x, key=None, mesh=None):
        if not replaying[0]:
            return step(model, optimizer, x, key, mesh)
        before = [p.detach().clone() for p in model.parameters()]
        loss = step(model, optimizer, x, key, mesh)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return loss

    def half_batch(model, optimizer, x, key=None, mesh=None):
        if not replaying[0]:
            return step(model, optimizer, x, key, mesh)
        return step(model, optimizer, x[: x.shape[0] // 2], key, mesh) * 2

    def stale_order(seed, epoch, n):
        return order(seed, 0 if replaying[0] else epoch, n)

    def altered(epoch, train_loss, valid_loss, *rest):
        if epoch > 0:
            train_loss, valid_loss = train_loss * 1.01, valid_loss * 1.01
        return end(epoch, train_loss, valid_loss, *rest)

    if fault == "stale":
        patch(train, "train_step", stale)
    elif fault == "half_batch":
        patch(train, "train_step", half_batch)
    elif fault == "stale_order":
        patch(train, "epoch_permutation", stale_order)
    else:
        patch(train, "_end_epoch", altered)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)
