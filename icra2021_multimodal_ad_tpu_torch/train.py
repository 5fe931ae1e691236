"""Training and evaluation engine: the NoveltyDetecter.

PyTorch counterpart of `icra2021_multimodal_ad_tpu/train.py` (the
reference's novelty_detection.py:10-127), on one device or data-parallel
over a mesh (parallel/mesh.py, one process per card).

Semantics kept:
  * optimizer: Adam(lr) with betas (0.9, 0.999) and eps 1e-8, the defaults
    of both torch.optim.Adam and optax.adam;
  * loss: MSE with sum reduction over the flattened batch, in fp32;
  * the train step runs BN in training mode and updates running stats; the
    validation pass runs in eval mode through the fused FC-module kernel,
    on a pack built at each eval call (the weights change every epoch), a
    VIB model with z = mu;
  * each epoch walks a permutation, full batches first, then the tail
    batch; the per-epoch loss is the exact mean (sum of batch sums / rows);
  * `config.train_dtype` "bfloat16" is mixed-precision training: the
    windows are rounded to bf16, the layers take the bf16 branch of
    models/layers.py (fp32 master params, Adam state and BN stats), and the
    validation pass runs the bf16 FC kernel, as JAX's eval of bf16 windows
    takes its low-precision branch; the test path stays fp32;
  * best-model selection keeps a deep copy of the weights with the lowest
    validation loss and restores it after the last epoch;
  * test(): binarize labels against target_class, extract RaPP diffs for
    train/valid/test, produce the BASE / SAP / NAP reports.

JAX runs an epoch as two device programs, `train_epoch` (the shuffle, a
scan over the full batches, then the tail batch) and `eval_epoch`, or, in
its fused mode, the whole run as one program that also picks the best model
on the device (`train_all_epochs`).  The port captures the same two passes
as CUDA graphs (`EpochPrograms`, on utils/graphs.Program) and replays them
every epoch over pinned staging:

  * per-epoch mode (the default with verbose >= 1, and always with
    checkpointing): the train replay and the validation replay, then the
    host fetches the two loss sums, divides them in float64, keeps the best
    model, prints and checkpoints, as JAX's loop;
  * fused mode (verbose < 1 and no checkpointing, or fused=True): the
    validation program also divides in fp32, compares with the best loss
    so far and writes the best snapshot in place (`torch.where`), and the
    epoch's two means into device histories; the host waits on no epoch and
    fetches the histories once, after the last.

While epoch e replays, the host draws and stages epoch e + 1's order and
VIB keys in the other of two staging slots.  The run's first epoch runs
eagerly on a side stream as the programs' warm-up, real work, and the
capture follows it, so the run takes exactly its own Adam steps.  On CUDA a
failed capture or replay raises; the eager loop, `train_all_epochs_eager`,
is the reference the programs are held to bit for bit (chip_smoke.py).

The captured programs outlive their job, as JAX's jit cache keeps a
compiled epoch program for the next call of the same static arguments and
shapes: the process keeps the last job's programs on each device
(`PROGRAMS`), and a job of the same `programs_key` rebinds them, its
initial weights, a zeroed Adam state and its windows copied into the
tensors the graphs captured, and replays every epoch, its first included;
at its end the model and optimizer get copies of what those tensors hold,
so nothing a job returns shares storage with the kept programs.  The
arithmetic is the captured graphs', which equal the eager epochs bit for
bit, so such a job trains as a fresh one would.  A job of other shapes
releases the entry, synchronizing, before it captures its own.

A mesh runs the same programs, its collectives inside them, as JAX runs
its meshed `train_epoch` and `train_all_epochs`: wherever the mesh is
`capturable` (parallel/mesh.py), an NCCL mesh on the cards and any mesh on
the CPU.  The first, eager epoch issues every collective of the programs
on the communicator the graphs then replay on; every rank stages, launches
and captures the same programs in the same order.  A gloo mesh on a card
stages its collectives through the host, which no graph can hold: that
configuration takes the eager loop.  On the CPU the programs call their
functions eagerly on the same staging.

The draws are JAX's, replayed (utils/jax_prng.py) from rng =
PRNGKey(config.seed + 1): each epoch's order is `permutation(fold_in(rng,
epoch), n)` and the VIB noise of its batches comes from
`split(fold_in(fold_in(rng, "VIB!"), epoch), n_full + 1)`, a key per full
batch and the last for the tail.  Both are functions of (seed, epoch)
alone, so a resumed run, even one given more epochs, replays the same order
and noise.

With a mesh, one sharded step equals a single-device step on the global
batch: every rank draws the same epoch order and takes its share of each
global batch; the gradients are SUMMED over the ranks (the loss is a sum
over the global batch, where DDP would average); train-mode BN normalizes
by the global batch's statistics (models/layers.py); a VIB model's noise
is drawn for the global batch and sliced.  A batch whose rows do not
divide by the world size runs replicated, every rank the whole batch, as
in JAX.  Adam's state stays replicated: equal gradients give equal
updates.  Validation and test() run the kernels on each rank's shard
(ops/rapp.py, ops/scoring.py).  Only rank 0 writes checkpoints.
"""

from __future__ import annotations

import contextlib
import csv
import math
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.optim import optimizer as optim_hooks

from icra2021_multimodal_ad_tpu_torch.config import Config
from icra2021_multimodal_ad_tpu_torch.models.autoencoder import (
    AePack,
    AutoEncoder,
    ae_loss,
    ae_pack,
    packed_forward,
)
from icra2021_multimodal_ad_tpu_torch.models.layers import FCLayer
from icra2021_multimodal_ad_tpu_torch.ops.rapp import get_diffs
from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
    ScoreReport,
    get_d_loss,
    get_d_norm_loss,
    get_recon_loss,
)
from icra2021_multimodal_ad_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    all_reduce_grads,
    map_rows,
    replicate,
    shard_batch,
)
from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils import graphs
from icra2021_multimodal_ad_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from icra2021_multimodal_ad_tpu_torch.utils import jax_prng
from icra2021_multimodal_ad_tpu_torch.utils.device import resolve_device
from icra2021_multimodal_ad_tpu_torch.utils.profiling import span
from icra2021_multimodal_ad_tpu_torch.utils.torch_compat import (
    from_jax_pytrees,
    pytrees_to_state_dict,
    state_dict_to_pytrees,
    to_jax_pytrees,
)


class TrainResult(NamedTuple):
    """`train_ms` / `eval_ms`: each epoch's train and validation pass, in
    device time on CUDA, read after the run from events recorded between
    the replays (the first, eager epoch's passes too); host time on the CPU
    and in the eager loop."""

    model: AutoEncoder        # the best model by validation loss, eval mode
    train_history: list       # per-epoch mean train loss
    valid_history: list       # per-epoch mean validation loss
    train_ms: list            # per-epoch time of the train pass
    eval_ms: list             # per-epoch time of the validation pass


def make_optimizer(model: AutoEncoder, lr: float) -> torch.optim.Adam:
    """Adam at optax.adam's defaults (the reference's
    novelty_detection.py:90).  On CUDA it is capturable: its step count
    stays on the device and the bias correction is computed there, with no
    host sync, so an epoch program can capture it; the eager loop on the
    card takes the same optimizer.  torch has no capturable Adam on the
    CPU, where the default Adam stays."""
    params = list(model.parameters())
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=params[0].device.type == "cuda")


#: the tag of the VIB noise stream (JAX train._VIB_STREAM_TAG, "VIB!")
_VIB_STREAM_TAG = 0x5649_4221


def _train_rng(seed: int) -> np.ndarray:
    """JAX's trainer key, PRNGKey(seed + 1)."""
    return jax_prng.prng_key(seed + 1)


def epoch_permutation(seed: int, epoch: int, n: int) -> torch.Tensor:
    """The epoch's shuffle, JAX's `permutation(fold_in(PRNGKey(seed + 1),
    epoch), n)`."""
    return torch.from_numpy(jax_prng.permutation(
        jax_prng.fold_in(_train_rng(seed), epoch), n))


def vib_epoch_key(seed: int, epoch: int) -> np.ndarray:
    """JAX's `_vib_epoch_key(PRNGKey(seed + 1), epoch)`: the epoch's VIB
    noise key, on a stream apart from the shuffle's and independent of the
    epoch budget."""
    return jax_prng.fold_in(jax_prng.fold_in(_train_rng(seed),
                                             _VIB_STREAM_TAG), epoch)


def save_train_checkpoint(path: str, epoch: int, model: AutoEncoder,
                          optimizer: torch.optim.Adam, best: dict,
                          train_history, valid_history) -> str:
    """Mid-training checkpoint in the flat npz format: the weights in the
    JAX layout, Adam's moments and step per parameter (in
    `model.parameters()` order), the epoch, the best-so-far snapshot and the
    loss histories.  Orbax directories are refused, as by save_checkpoint."""
    params, state = to_jax_pytrees(model)
    best_params, best_state = state_dict_to_pytrees(best["state_dict"], model)
    opt = optimizer.state_dict()["state"]
    ids = range(len(list(model.parameters())))
    extra = {
        "epoch": np.asarray(epoch),
        "opt_step": np.asarray([float(opt[i]["step"]) for i in ids],
                               dtype=np.float32),
        # bf16 moments (param_dtype bfloat16) widen exactly to fp32
        "opt_exp_avg": [opt[i]["exp_avg"].float().cpu().numpy()
                        for i in ids],
        "opt_exp_avg_sq": [opt[i]["exp_avg_sq"].float().cpu().numpy()
                           for i in ids],
        "best_loss": np.asarray(best["loss"]),
        "best_params": best_params,
        "best_state": best_state,
        "train_history": np.asarray(train_history, dtype=np.float64),
        "valid_history": np.asarray(valid_history, dtype=np.float64),
    }
    return save_checkpoint(path, params, state, extra=extra)


def load_train_checkpoint(path: str, model: AutoEncoder,
                          optimizer: torch.optim.Adam) -> dict:
    """Inverse of save_train_checkpoint: loads the weights into `model` and
    the moments into `optimizer`, in place, each on its parameter's device
    and in its dtype, and Adam's step there too when the optimizer is
    capturable (on the CPU torch keeps it a CPU tensor); returns the
    epoch, the best snapshot and the histories."""
    params, state, meta = load_checkpoint(path)
    extra = meta["extra"]
    from_jax_pytrees(params, state, model)
    steps = np.atleast_1d(extra["opt_step"])
    on_device = optimizer.param_groups[0]["capturable"]
    optimizer.load_state_dict({
        "state": {i: {"step": torch.tensor(
                          float(steps[i]),
                          device=p.device if on_device else "cpu"),
                      "exp_avg": torch.tensor(np.array(m), dtype=p.dtype,
                                              device=p.device),
                      "exp_avg_sq": torch.tensor(np.array(v), dtype=p.dtype,
                                                 device=p.device)}
                  for i, (p, m, v) in enumerate(zip(
                      model.parameters(), extra["opt_exp_avg"],
                      extra["opt_exp_avg_sq"]))},
        "param_groups": optimizer.state_dict()["param_groups"],
    })
    device = next(model.parameters()).device
    best_sd = pytrees_to_state_dict(extra["best_params"], extra["best_state"],
                                    model)
    return {
        "epoch": int(extra["epoch"]),
        "best": {"loss": float(extra["best_loss"]),
                 "state_dict": {k: torch.tensor(v, device=device)
                                for k, v in best_sd.items()}},
        "train_history": [float(v)
                          for v in np.atleast_1d(extra["train_history"])],
        "valid_history": [float(v)
                          for v in np.atleast_1d(extra["valid_history"])],
    }


@contextlib.contextmanager
def data_parallel(model: AutoEncoder, mesh: Mesh, offset: int, rows: int):
    """While it is open, `model` takes a shard at row `offset` of a global
    batch of `rows`: train-mode BN over the global batch, VIB noise drawn
    for it."""
    layers = [m for m in model.modules() if isinstance(m, FCLayer)]
    for layer in layers:
        layer.mesh = mesh
    model.row_shard = (offset, rows)
    try:
        yield
    finally:
        for layer in layers:
            layer.mesh = None
        model.row_shard = None


def train_step(model: AutoEncoder, optimizer: torch.optim.Adam,
               x: torch.Tensor, key: Optional[jax_prng.Key] = None,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One Adam step on one batch: train-mode BN, MSE-sum loss
    (auto_encoder.py:57-77); `key` (a JAX key, numpy words or a device
    tensor of them) draws a VIB model's noise.
    With `mesh`, x is the global batch: a batch that divides by the world
    size is sharded (each rank its rows, gradients summed over the ranks),
    another runs replicated.  Returns the batch loss (a device scalar),
    the global batch's."""
    optimizer.zero_grad(set_to_none=True)
    if mesh is None or x.shape[0] % mesh.world_size:
        loss = ae_loss(model, x, train=True, key=key)
        loss.backward()
        optimizer.step()
        return loss.detach()
    b = x.shape[0] // mesh.world_size
    with data_parallel(model, mesh, mesh.rank * b, x.shape[0]):
        loss = ae_loss(model, shard_batch(mesh, x), train=True, key=key)
        loss.backward()
    all_reduce_grads(mesh, list(model.parameters()))
    optimizer.step()
    return all_reduce(mesh, loss.detach())


def eval_step(model: AutoEncoder, x: torch.Tensor, pack=None,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Validation loss of one batch in eval mode, through the kernel
    (auto_encoder.py:80-90); with `mesh`, each rank runs its shard and the
    per-row losses are gathered."""
    with torch.no_grad():
        if mesh is None:
            return ae_loss(model, x, train=False, pack=pack)
        if pack is None:
            pack = ae_pack(model, x.dtype)
        return map_rows(mesh, lambda s: _row_losses(pack, s), x).sum()


def _row_losses(pack: AePack, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    d = packed_forward(pack, x).float() - x.float()
    return (d * d).sum(dim=-1)


def train_epoch(model: AutoEncoder, optimizer: torch.optim.Adam,
                train_x: torch.Tensor, perm: torch.Tensor,
                batch: int, rng: Optional[np.ndarray] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One epoch over `train_x` in the order `perm`: the full batches, then
    the tail batch.  A VIB model's noise comes from `split(rng, n_full +
    1)`, as JAX's `train_epoch` (rng defaults to PRNGKey(0) there too).
    With `mesh` every rank passes the same global `train_x` and `perm`.
    Returns the sum of the batch losses (a device scalar)."""
    keys = None
    if model.distribution is not None:
        keys = jax_prng.split(jax_prng.prng_key(0) if rng is None else rng,
                              len(perm) // batch + 1)
    return _train_batches(model, optimizer, train_x, perm, batch, keys, mesh)


def _train_batches(model: AutoEncoder, optimizer: torch.optim.Adam,
                   train_x: torch.Tensor, perm: torch.Tensor, batch: int,
                   keys=None, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """`train_epoch` on the epoch's VIB keys (n_full + 1, 2), numpy words
    or a device tensor of them, or None without VIB."""
    shuffled = train_x[perm.to(train_x.device)]
    n = shuffled.shape[0]
    n_full = n // batch
    total = torch.zeros((), device=train_x.device)
    for i in range(n_full + (n > n_full * batch)):
        total += train_step(model, optimizer,
                            shuffled[i * batch:(i + 1) * batch],
                            None if keys is None else keys[i], mesh)
    return total


def eval_epoch(model: AutoEncoder, x: torch.Tensor,
               batch: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Eval-mode loss sum over all rows, full batches then the tail, on one
    pack of the current weights in x's dtype (bf16 windows, under bf16
    training, take the bf16 kernel)."""
    pack = ae_pack(model, x.dtype)
    n = x.shape[0]
    total = torch.zeros((), device=x.device)
    for start in range(0, n, batch):
        total += eval_step(model, x[start:start + batch], pack, mesh)
    return total


def _snapshot(model: AutoEncoder) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class EpochPrograms:
    """JAX's epoch programs (`train_epoch`, `eval_epoch` and the best-model
    select of `train_all_epochs`), on one device or on each rank of a
    capturable `mesh`, as two stateful captured programs
    (utils/graphs.Program) sharing one memory pool.

    The train program reads the epoch's order (n int64) and VIB keys
    (n_full + 1 key words, int64) from pinned staging, two slots of it,
    gathers `train_x[perm]`, takes the full-batch steps and then the tail
    step, each `zero_grad(set_to_none=True)`, forward, backward and
    `optimizer.step()`, and writes the loss sum to a fixed buffer.  The
    model's parameters, BN buffers and Adam state are the fixed tensors
    it updates in place; the gradients live in the pool, and nothing
    outside the graph keeps them.  The validation program packs the
    current weights (`ae_pack`, its buffers in the pool) and sums the
    eval-mode loss through the FC kernel in the windows' dtype; with
    `fused`, it also picks the best model in fp32 and writes the epoch's
    two means into device histories, at a device count of the epochs run.
    With `mesh`, both passes are `train_epoch(mesh=)` and
    `eval_epoch(mesh=)`: each rank its shard of every batch, the
    collectives recorded in the graphs; the sums they all-reduce or gather
    are every rank's, so every rank selects the same best model.

    Per epoch: `stage` (host draws into the epoch's slot, after that
    slot's last launch), `launch` (both passes, between CUDA events);
    after the first epoch's launch, eager as the warm-up, `capture`; then
    `sums` (per-epoch mode) or, after the last epoch, `fetch` (fused).

    Captured programs serve a later job of the same shapes (`ProgramCache`):
    `end_job` gives the job's model and optimizer copies of their values and
    lets them go, and `rebind` gives the fixed tensors the next job's
    initial values, so every epoch of that job replays."""

    def __init__(self, model: AutoEncoder, optimizer: torch.optim.Adam,
                 train_x: torch.Tensor, valid_x: torch.Tensor, seed: int,
                 batch: int, n_epochs: int, fused: bool,
                 mesh: Optional[Mesh] = None):
        self.model, self.optimizer, self.mesh = model, optimizer, mesh
        self.train_x, self.valid_x = train_x, valid_x
        self.seed, self.batch, self.fused = seed, batch, fused
        self.n, self.n_valid = train_x.shape[0], valid_x.shape[0]
        self.n_full = self.n // batch
        self.device = train_x.device
        self._vib = model.distribution is not None
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" else None)
        self.train_sum = torch.zeros((), device=self.device)
        self.train = graphs.Program(
            self._train_pass, [((self.n,), torch.int64),
                               ((self.n_full + 1, 2), torch.int64)],
            self.device, slots=2, pool=pool, stateful=True)
        self.valid = graphs.Program(self._valid_pass, [], self.device,
                                    pool=pool, stateful=True)
        self._marks: list = []
        self.captured = False
        #: the model's parameters and buffers, the tensors the graphs update
        self._kept = {k: v.detach()
                      for k, v in model.state_dict(keep_vars=True).items()}
        #: Adam's state per parameter, in order, once a job has ended
        self._adam: List[dict] = []
        if fused:
            self.epochs_run = torch.zeros(1, dtype=torch.int64,
                                          device=self.device)
            self.history = torch.zeros(2, n_epochs, device=self.device)
            self.best_loss = torch.full((), np.inf, device=self.device)
            self.best = _snapshot(model)
            live = model.state_dict()
            self._select = [(live[k], v) for k, v in self.best.items()]

    def _train_pass(self, perm: torch.Tensor,
                    keys: torch.Tensor) -> torch.Tensor:
        total = _train_batches(self.model, self.optimizer, self.train_x,
                               perm, self.batch, keys if self._vib else None,
                               self.mesh)
        return self.train_sum.copy_(total)

    def _valid_pass(self) -> torch.Tensor:
        total = eval_epoch(self.model, self.valid_x, self.batch, self.mesh)
        if self.fused:
            # JAX's train_all_epochs: fp32 means and a select on the
            # device, the snapshot written in place
            mean = total / max(self.n_valid, 1)
            better = mean < self.best_loss
            self.best_loss.copy_(torch.where(better, mean, self.best_loss))
            for live, snap in self._select:
                snap.copy_(torch.where(better, live, snap))
            means = torch.stack([self.train_sum / max(self.n, 1), mean])
            self.history.index_copy_(1, self.epochs_run, means[:, None])
            self.epochs_run += 1
        return total

    def stage(self, epoch: int) -> None:
        """Draw the epoch's order and VIB keys into its slot."""
        perm, keys = self.train.staging(epoch % 2)
        perm[:] = epoch_permutation(self.seed, epoch, self.n).numpy()
        if self._vib:
            keys[:] = jax_prng.split(vib_epoch_key(self.seed, epoch),
                                     self.n_full + 1)

    def _mark(self):
        if self.device.type == "cpu":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def launch(self, epoch: int) -> None:
        """The epoch's train pass, then its validation pass."""
        start = self._mark()
        self.train.launch(epoch % 2)
        mid = self._mark()
        self.valid.launch()
        self._marks.append((start, mid, self._mark()))

    def capture(self) -> None:
        self.train.capture()
        self.valid.capture()
        self.captured = True

    @torch.no_grad()
    def end_job(self) -> None:
        """After a job: the fixed tensors and Adam state stay with the
        programs, and the job's model and optimizer go on with copies of
        their values, so that no later job's rebind reaches them."""
        self._adam = [self.optimizer.state[p]
                      for p in self.model.parameters()]
        for k, t in self.model.state_dict(keep_vars=True).items():
            t.data = self._kept[k].clone()
        for p, st in zip(self.model.parameters(), self._adam):
            self.optimizer.state[p] = {k: v.clone() for k, v in st.items()}
        self.model = self.optimizer = None

    @torch.no_grad()
    def rebind(self, model: AutoEncoder, optimizer: torch.optim.Adam,
               train_x: torch.Tensor, valid_x: torch.Tensor,
               seed: int) -> None:
        """Ready the captured programs for a new job from `model`'s values,
        a fresh `optimizer` over its parameters, these windows and `seed`,
        as a new build would start it: the initial parameters and BN
        buffers and the windows copied into the fixed tensors, Adam's state
        zeroed, the fused mode's best loss, snapshot and epoch count
        reset.  For the job, `model`'s parameters and buffers hold the
        fixed tensors themselves and `optimizer` their Adam state
        (`end_job` parts them again)."""
        for k, t in model.state_dict(keep_vars=True).items():
            self._kept[k].copy_(t)
            t.data = self._kept[k]
        torch._foreach_zero_([v for st in self._adam for v in st.values()])
        for p, st in zip(model.parameters(), self._adam):
            optimizer.state[p] = st
        self.train_x.copy_(train_x)
        self.valid_x.copy_(valid_x)
        if self.fused:
            self.best_loss.fill_(np.inf)
            self.epochs_run.zero_()  # the history is written from 0
            for live, snap in self._select:
                snap.copy_(live)
        self.model, self.optimizer, self.seed = model, optimizer, seed
        self._marks = []

    def release(self) -> None:
        """Destroy both graphs and drop every buffer, once the card has
        finished with them: the pool, Adam's state and the windows are
        freed now, not by the collector, which might run during a later
        capture."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.train.release()
        self.valid.release()
        self.__dict__.clear()

    def sums(self, epoch: int) -> Tuple[float, float]:
        """The epoch's (train, validation) loss sums, once its validation
        pass has finished (the host's wait of per-epoch mode)."""
        self.valid.wait()
        return (float(self.train.output(epoch % 2)),
                float(self.valid.output()))

    def fetch(self) -> Tuple[List[float], List[float]]:
        """Fused mode, after the last epoch: the (train, validation)
        histories in one copy to the host, and the best snapshot loaded
        into the model in place."""
        history = self.history[:, :len(self._marks)].cpu()
        self.model.load_state_dict(self.best)
        return history[0].tolist(), history[1].tolist()

    def times_ms(self) -> Tuple[List[float], List[float]]:
        """Each epoch's (train, validation) pass ms, once every launch has
        finished: device time between the events on CUDA, host time on the
        CPU (where each launch runs its pass)."""
        if self.device.type == "cpu":
            ms = [((b - a) * 1e3, (c - b) * 1e3) for a, b, c in self._marks]
        else:
            torch.cuda.current_stream(self.device).synchronize()
            ms = [(a.elapsed_time(b), b.elapsed_time(c))
                  for a, b, c in self._marks]
        return [t for t, _ in ms], [v for _, v in ms]


class ProgramCache:
    """The captured epoch programs of the last cached job on each device,
    kept for the next job of the same `programs_key`, as JAX's jit cache
    keeps an epoch program per static arguments and shapes (the JAX
    package caches `optax.adam` by learning rate so that repeated trainings
    in one process hit it).  `take` is a hit, which the job rebinds
    (`EpochPrograms.rebind`) and replays from its first epoch, or a miss,
    which releases the device's entry before the job builds, runs its
    first epoch eagerly and captures its own; `keep` makes a job's
    programs the entry.  `hits` and `misses` count the jobs."""

    def __init__(self):
        self._entries: Dict[torch.device, Tuple[tuple, EpochPrograms]] = {}
        self.hits = self.misses = 0

    def take(self, key: tuple, replay: bool = True
             ) -> Optional[EpochPrograms]:
        """The entry's programs, out of the cache, where they were kept
        under `key` and the job may `replay` its first epoch; else None,
        the device's entry released."""
        device = key[0]
        entry = self._entries.pop(device, None)
        if replay and entry is not None and entry[0] == key:
            self.hits += 1
            return entry[1]
        if entry is not None:
            entry[1].release()
        self.misses += 1
        return None

    def keep(self, key: tuple, progs: EpochPrograms) -> None:
        progs.end_job()
        self._entries[key[0]] = (key, progs)

    def clear(self) -> None:
        """Release every entry and zero the counts."""
        while self._entries:
            self._entries.popitem()[1][1].release()
        self.hits = self.misses = 0


#: the process's kept epoch programs (`train_all_epochs`)
PROGRAMS = ProgramCache()


def programs_key(model: AutoEncoder, optimizer: torch.optim.Adam,
                 train_x: torch.Tensor, valid_x: torch.Tensor, batch: int,
                 n_epochs: int, fused: bool) -> Optional[tuple]:
    """What a job's captured programs are specialized to: the device, the
    model's architecture (each module's type and activation, each
    parameter's and buffer's name, shape and dtype, the VIB head), the
    windows' dtype and shapes, the batch, the epochs, the mode, the
    optimizer's kind and hyper-parameters, and the float32 math mode that
    picks the captured cuBLAS and cuDNN kernels (the TF32 switches and
    `torch.get_float32_matmul_precision`, as JAX's jit keys on its matmul
    precision).  None where the optimizer has state already or is not over
    exactly the model's parameters: no kept programs can stand in for
    it."""
    groups = optimizer.param_groups
    if (optimizer.state or len(groups) != 1 or [id(p) for p in groups[0][
            "params"]] != [id(p) for p in model.parameters()]):
        return None
    return (train_x.device,
            tuple((name, type(m), getattr(m, "act", None))
                  for name, m in model.named_modules()),
            tuple((k, tuple(v.shape), v.dtype)
                  for k, v in model.state_dict().items()),
            (model.distribution, model.k, model.stochastic_inference),
            train_x.dtype, tuple(train_x.shape), valid_x.dtype,
            tuple(valid_x.shape), batch, n_epochs, fused, type(optimizer),
            tuple(sorted((k, repr(v)) for k, v in groups[0].items()
                         if k != "params")),
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision()))


def _watched(optimizer: torch.optim.Adam) -> bool:
    """Whether step hooks, the optimizer's own or global, watch its steps:
    a replay runs no Python and would call none of them."""
    return bool(optimizer._optimizer_step_pre_hooks
                or optimizer._optimizer_step_post_hooks
                or optim_hooks._global_optimizer_pre_hooks
                or optim_hooks._global_optimizer_post_hooks)


def _end_epoch(epoch: int, train_loss: float, valid_loss: float, best: dict,
               model: AutoEncoder, optimizer: torch.optim.Adam, run: dict
               ) -> dict:
    """The host's work after an epoch of per-epoch mode (JAX's loop,
    train.py:473-505): the histories, the best model by the float64 mean,
    the progress line and the mid-run checkpoint (rank 0 of a mesh).
    Returns the best."""
    run["train_history"].append(train_loss)
    run["valid_history"].append(valid_loss)
    if valid_loss < best["loss"]:
        best = {"loss": valid_loss, "state_dict": _snapshot(model)}
    if run["verbose"] >= 1:
        print(f"Epoch {epoch + 1} - loss={train_loss:.4e} "
              f"valid={valid_loss:.4e} lowest={best['loss']:.4e}")
    mesh, path, every = run["mesh"], run["checkpoint_path"], run[
        "checkpoint_every"]
    if (path and every > 0 and (epoch + 1) % every == 0
            and (mesh is None or mesh.rank == 0)):
        save_train_checkpoint(path, epoch + 1, model, optimizer, best,
                              run["train_history"], run["valid_history"])
    return best


def train_all_epochs(model: AutoEncoder, optimizer: torch.optim.Adam,
                     train_x: torch.Tensor, valid_x: torch.Tensor, seed: int,
                     batch: int, n_epochs: int, start_epoch: int = 0,
                     best: Optional[dict] = None,
                     train_history: Optional[List[float]] = None,
                     valid_history: Optional[List[float]] = None,
                     checkpoint_path: Optional[str] = None,
                     checkpoint_every: int = 0,
                     verbose: int = 0,
                     mesh: Optional[Mesh] = None,
                     fused: bool = False) -> TrainResult:
    """The training loop from `start_epoch` to `n_epochs` on the epoch
    programs (`EpochPrograms`), per-epoch or `fused` (the module's note):
    per-epoch shuffle, train pass, validation pass and best-model selection
    (novelty_detection.py:92-125); per-epoch mode writes a mid-run
    checkpoint every `checkpoint_every` epochs.  Restores the best weights
    into `model`.  With a `mesh`, every rank passes the same inputs; a mesh
    that is not `capturable` (gloo on a card) runs the eager loop instead,
    per-epoch (`train_all_epochs_eager`).

    A job from epoch 0 of two or more epochs on one device, with no
    checkpoint, a fresh optimizer over the model's parameters and no mesh,
    goes through `PROGRAMS`: where the kept programs match its
    `programs_key` it rebinds them and replays every epoch, the first
    included; else it builds, runs its first epoch eagerly, captures, and
    its programs, on windows of their own, become the entry.  A job whose
    optimizer's steps are watched by hooks never replays its first epoch.
    Resumed, checkpointing and meshed jobs neither use nor change the
    cache.

    Spans (`utils/profiling.span`, recorded only while a profiler runs;
    the eager loop has none): `train.setup` (the best snapshot, the cache's
    lookup and the programs' buffers), `train.rebind` on a hit,
    `train.stage` for each epoch's staging, `train.eager_epoch` for the
    first launch of programs not yet captured and `train.launch` for each
    replayed one, `train.capture`, per-epoch mode's `train.sums` (the host
    blocked on the card) and `train.end_epoch`, and `train.finish`."""
    run = dict(train_history=list(train_history or []),
               valid_history=list(valid_history or []), verbose=verbose,
               checkpoint_path=checkpoint_path,
               checkpoint_every=checkpoint_every, mesh=mesh)
    if mesh is not None and not mesh.capturable:
        return train_all_epochs_eager(model, optimizer, train_x, valid_x,
                                      seed, batch, n_epochs, start_epoch,
                                      best, **run)
    if fused and (start_epoch or best is not None):
        raise ValueError("the fused mode trains a whole run from epoch 0, "
                         "as JAX's train_all_epochs")
    n, n_valid = train_x.shape[0], valid_x.shape[0]
    key = None
    if (mesh is None and not start_epoch and best is None
            and not (train_history or valid_history) and n_epochs > 1
            and not (checkpoint_path and checkpoint_every > 0)):
        key = programs_key(model, optimizer, train_x, valid_x, batch,
                           n_epochs, fused)
    with span("train.setup"):
        if best is None and not fused:
            best = {"loss": np.inf, "state_dict": _snapshot(model)}
        progs = None if key is None else PROGRAMS.take(
            key, replay=not _watched(optimizer))
        if progs is None:
            if key is not None:  # the entry's windows are its own
                train_x, valid_x = train_x.clone(), valid_x.clone()
            progs = EpochPrograms(model, optimizer, train_x, valid_x, seed,
                                  batch, n_epochs - start_epoch, fused, mesh)
    if progs.captured:
        with span("train.rebind"):
            progs.rebind(model, optimizer, train_x, valid_x, seed)
    with span("train.stage"):
        progs.stage(start_epoch)
    for epoch in range(start_epoch, n_epochs):
        eager = not progs.captured
        with span("train.eager_epoch" if eager else "train.launch"):
            progs.launch(epoch)
        if epoch + 1 < n_epochs:
            if eager:
                with span("train.capture"):
                    progs.capture()
            with span("train.stage"):
                progs.stage(epoch + 1)
        if not fused:
            with span("train.sums"):
                total, vtotal = progs.sums(epoch)
            with span("train.end_epoch"):
                best = _end_epoch(epoch, total / max(n, 1),
                                  vtotal / max(n_valid, 1), best, model,
                                  optimizer, run)
    with span("train.finish"):
        if fused:
            train_means, valid_means = progs.fetch()
            run["train_history"] += train_means
            run["valid_history"] += valid_means
        else:
            model.load_state_dict(best["state_dict"])
        # the last replay's gradients live in the programs' pool
        optimizer.zero_grad(set_to_none=True)
        train_ms, eval_ms = progs.times_ms()
        if key is not None:
            PROGRAMS.keep(key, progs)
    return TrainResult(model=model.eval(), train_history=run["train_history"],
                       valid_history=run["valid_history"], train_ms=train_ms,
                       eval_ms=eval_ms)


def train_all_epochs_eager(model: AutoEncoder, optimizer: torch.optim.Adam,
                           train_x: torch.Tensor, valid_x: torch.Tensor,
                           seed: int, batch: int, n_epochs: int,
                           start_epoch: int = 0,
                           best: Optional[dict] = None,
                           train_history: Optional[List[float]] = None,
                           valid_history: Optional[List[float]] = None,
                           checkpoint_path: Optional[str] = None,
                           checkpoint_every: int = 0,
                           verbose: int = 0,
                           mesh: Optional[Mesh] = None) -> TrainResult:
    """The eager loop, per-epoch, every launch issued from the host: the
    reference of the epoch programs and the route of a mesh that is not
    `capturable`.  Its train and eval ms are host times."""
    n, n_valid = train_x.shape[0], valid_x.shape[0]
    run = dict(train_history=list(train_history or []),
               valid_history=list(valid_history or []), verbose=verbose,
               checkpoint_path=checkpoint_path,
               checkpoint_every=checkpoint_every, mesh=mesh)
    if best is None:
        best = {"loss": np.inf, "state_dict": _snapshot(model)}
    train_ms, eval_ms = [], []
    for epoch in range(start_epoch, n_epochs):
        t0 = time.perf_counter()
        total = train_epoch(model, optimizer, train_x,
                            epoch_permutation(seed, epoch, n), batch,
                            vib_epoch_key(seed, epoch), mesh)
        train_loss = float(total) / max(n, 1)
        t1 = time.perf_counter()
        valid_loss = (float(eval_epoch(model, valid_x, batch, mesh))
                      / max(n_valid, 1))
        train_ms.append((t1 - t0) * 1e3)
        eval_ms.append((time.perf_counter() - t1) * 1e3)
        best = _end_epoch(epoch, train_loss, valid_loss, best, model,
                          optimizer, run)
    model.load_state_dict(best["state_dict"])
    return TrainResult(model=model.eval(), train_history=run["train_history"],
                       valid_history=run["valid_history"], train_ms=train_ms,
                       eval_ms=eval_ms)


class NoveltyDetecter:
    """Train/test orchestration (novelty_detection.py:10-127) on `device`,
    the card unless the caller asks for the CPU, or data-parallel over
    `mesh` on each rank's device (`parallel.mesh.get_mesh`)."""

    def __init__(self, config: Config, mesh: Optional[Mesh] = None,
                 device="cuda"):
        self.config = config
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)

    def _data(self, x, dtype=torch.float32) -> torch.Tensor:
        x = torch.as_tensor(x)
        x = x.reshape(x.shape[0], -1).to(self.device, torch.float32)
        return x.to(dtype)

    def train(self, model: AutoEncoder, train_x, valid_x,
              fused: Optional[bool] = None,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 0,
              resume: bool = False) -> TrainResult:
        """Train `model` in place and return it at its best validation
        loss, on the epoch programs (`train_all_epochs`).  `fused` picks
        the mode as JAX does: by default fused with verbose < 1 and no
        checkpointing, and never with checkpointing.  With `resume`, an
        existing npz checkpoint at `checkpoint_path` restores the weights,
        Adam's state, the best snapshot and the histories, and training
        continues at its epoch.  A job of the same shapes, dtype, lr and
        mode as the process's last on the device replays that job's
        captured programs from its first epoch (`train_all_epochs`).  The
        whole job is the span `train.job`; its windows to the device,
        optimizer and restore are `train.setup`."""
        with span("train.job"):
            cfg = self.config
            checkpointing = bool(checkpoint_path) and (checkpoint_every > 0
                                                       or resume)
            if fused is None:
                fused = cfg.verbose < 1
            fused = fused and not checkpointing
            train_dtype = getattr(cfg, "train_dtype", "float32")
            if train_dtype not in ("float32", "bfloat16"):
                raise ValueError(f"train_dtype must be 'float32' or "
                                 f"'bfloat16', got {train_dtype!r}")
            dtype = getattr(torch, train_dtype)
            with span("train.setup"):
                train_x = self._data(train_x, dtype)
                valid_x = self._data(valid_x, dtype)
                batch = min(cfg.batch_size, train_x.shape[0])
                if self.mesh is not None:
                    replicate(self.mesh, model)  # rank 0's initial weights
                optimizer = make_optimizer(model, cfg.lr)
                loaded = {}
                if resume and checkpoint_path:
                    ckpt = (checkpoint_path
                            if checkpoint_path.endswith(".npz")
                            else checkpoint_path + ".npz")
                    if os.path.exists(ckpt):
                        loaded = load_train_checkpoint(ckpt, model,
                                                       optimizer)
                        if cfg.verbose >= 1:
                            print(f"resumed from {ckpt} at epoch "
                                  f"{loaded['epoch']}")
            return train_all_epochs(
                model, optimizer, train_x, valid_x, cfg.seed, batch,
                cfg.n_epochs, start_epoch=loaded.get("epoch", 0),
                best=loaded.get("best"),
                train_history=loaded.get("train_history"),
                valid_history=loaded.get("valid_history"),
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, verbose=cfg.verbose,
                mesh=self.mesh, fused=fused)

    def test(self, model: AutoEncoder, train_x, valid_x, test_x, test_y,
             save_stats_path: Optional[str] = None):
        """BASE/SAP/NAP evaluation (novelty_detection.py:15-85); returns
        (base_report, sap_report, nap_report).  One pack of the model's
        weights serves the three diff extractions.  With a mesh every rank
        passes the same inputs and gets the same reports."""
        cfg = self.config
        label = binarize_labels(cfg, test_y)
        pack = ae_pack(model)
        bs = cfg.batch_size
        train_diffs, valid_diffs, test_diffs = (
            get_diffs(self._data(x), model, batch_size=bs, mesh=self.mesh,
                      pack=pack)
            for x in (train_x, valid_x, test_x))
        end = cfg.n_layers + 1 - cfg.end_layer_index
        base = get_recon_loss(valid_diffs[0], test_diffs[0], label)
        sap = get_d_loss(
            train_diffs, valid_diffs, test_diffs, label,
            start_layer_index=cfg.start_layer_index, end_layer_index=end)
        nap = get_d_norm_loss(
            train_diffs, valid_diffs, test_diffs, label, config=cfg,
            start_layer_index=cfg.start_layer_index, end_layer_index=end,
            save_stats_path=save_stats_path, mesh=self.mesh)
        return base, sap, nap


def binarize_labels(config: Config, test_y) -> np.ndarray:
    """Anomaly-label binarization (novelty_detection.py:31-34): positive
    where the label equals target_class, inverted under unimodal_normal."""
    test_y = np.asarray(test_y)
    target = _coerce_like(config.target_class, test_y)
    label = np.isin(test_y, [target])
    return ~label if config.unimodal_normal else label


def _coerce_like(target, labels: np.ndarray):
    """The CLI passes target_class as str; labels are numeric (the reference
    relies on json labels [0,1] and re-assignment at data_loaders.py:64-66)."""
    if isinstance(target, str):
        try:
            target = type(labels.ravel()[0].item())(float(target))
        except (ValueError, TypeError):
            pass
    return target


REPORT_COLUMNS = (
    "base_auroc", "sap_auroc", "nap_auroc",
    "base_f1score", "sap_f1score", "nap_f1score",
    "base_precision", "sap_precision", "nap_precision",
    "base_recalls", "sap_recalls", "nap_recalls",
    "base_aupr", "sap_aupr", "nap_aupr",
)


def report_dataframe(base: ScoreReport, sap: ScoreReport,
                     nap: ScoreReport) -> List[dict]:
    """One result row in the reference's column layout
    (novelty_detection.py:75-83), as a list of one dict."""
    fields = {"auroc": "auroc", "f1score": "f1", "precision": "precision",
              "recalls": "recall", "aupr": "aupr"}
    reports = {"base": base, "sap": sap, "nap": nap}
    row = {}
    for col in REPORT_COLUMNS:
        name, metric = col.split("_")
        row[col] = getattr(reports[name], fields[metric])
    return [row]


def write_report_csv(path: str, rows: List[dict]) -> str:
    """Write report rows as the JAX package's `DataFrame.to_csv` does: an
    unnamed index column, then the report columns, NaN as an empty field."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["", *REPORT_COLUMNS])
        for i, row in enumerate(rows):
            writer.writerow([i, *("" if math.isnan(row[c]) else float(row[c])
                                  for c in REPORT_COLUMNS)])
    return path
