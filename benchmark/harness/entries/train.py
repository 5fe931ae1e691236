"""Training: whole `NoveltyDetecter.train` jobs, each from the seeded
initial weights, as a sweep runs one per grid point.

Set-up draws the initial weights and the train and validation windows,
builds the detector and runs one job, the programs' warm-up and the
check's first steps: a hook on the optimizer's steps, which runs in the
job's eager first epoch, copies Adam's first moments after step 1 (the
first gradient, times 1 - beta1) and the weights after step 3; the job's
progress line for its second epoch, which the card ran as a graph replay,
copies the weights that replay left.  The window runs
whole jobs back to back, the model reset to the initial weights before
each; the trainer's per-epoch prints go to standard error.  The check holds the set-up job's
first steps and its weights after the first replayed epoch, the last
job's first three epochs' means and the model it kept against one float64
job of the reference.
"""

from __future__ import annotations

import contextlib
import io
import sys
import time

import numpy as np
import torch

from benchmark.harness import counts, inputs
from benchmark.harness.clock import SetupSpans
from benchmark.harness.port import launch_counts, port_config, port_model
from benchmark.reference import ae as ref_ae
from benchmark.reference.compare import (
    Check,
    leaf_norm_gap,
    moving,
)
from benchmark.reference.precision import precision

BETA1 = 0.9


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from icra2021_multimodal_ad_tpu_torch.train import NoveltyDetecter

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.setup = SetupSpans(device)
        self.cfg = port_config(config, verbose=int(traffic["verbose"]),
                               seed=seed)
        width = int(config["input_size"])
        with self.setup.span("inputs"):
            self.weights = inputs.ae_weights(config, seed, device,
                                             trained=False)
            self.model = port_model(config, self.weights, device)
            self.start = {k: v.detach().clone()
                          for k, v in self.model.state_dict().items()}
            self.train_x, _ = inputs.fused_windows(
                int(traffic["train_windows"]), width, seed, "train", device)
            self.valid_x, _ = inputs.fused_windows(
                int(traffic["valid_windows"]), width, seed, "valid", device)
        self.detector = NoveltyDetecter(self.cfg, device=self.device)
        self._refs = {}
        with self.setup.span("warm_up"):
            self.first_steps = self._observed_job()
        self.results = []

    def _job(self, out=None):
        """One whole job from the initial weights; its prints go to `out`,
        standard error unless given."""
        self.model.load_state_dict(self.start)
        with contextlib.redirect_stdout(out or sys.stderr):
            return self.detector.train(self.model, self.train_x,
                                       self.valid_x)

    def _observed_job(self) -> dict:
        from torch.optim.optimizer import register_optimizer_step_post_hook

        params = list(self.model.parameters())
        start = [p.detach().clone() for p in params]
        seen = {"steps": 0}
        cuda = self.device.type == "cuda"

        def hook(optimizer, args, kwargs):
            if cuda and torch.cuda.is_current_stream_capturing():
                return
            seen["steps"] += 1
            if seen["steps"] == 1:
                seen["first_grad"] = [
                    optimizer.state[p]["exp_avg"].detach().clone()
                    / (1 - BETA1) for p in params]
            elif seen["steps"] == 3:
                seen["change3"] = [p.detach().clone() - s
                                   for p, s in zip(params, start)]

        def second_epoch():
            # the line comes once the epoch's passes have finished and
            # before the next epoch's launch: the weights its replay left
            seen["change_e2"] = [p.detach().clone() - s
                                 for p, s in zip(params, start)]

        handle = register_optimizer_step_post_hook(hook)
        try:
            self._job(EpochTap(2, second_epoch))
        finally:
            handle.remove()
        if "change3" not in seen:
            raise ValueError("the check reads the first three steps, which "
                             "the job's first (eager) epoch must take")
        if "change_e2" not in seen:
            raise ValueError("the check reads the weights after the second "
                             "epoch, whose progress line never came")
        return seen

    def window(self, seconds: float) -> dict:
        before = launch_counts()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            self.results.append(self._job())
        self.elapsed = time.perf_counter() - t0
        after = launch_counts()
        jobs = len(self.results)
        epochs = int(self.config["n_epochs"])
        self.launches = {k: (after[k] - before[k]) / (jobs * epochs)
                         for k in after if after[k] != before[k]}
        n = jobs * self.train_x.shape[0] * epochs
        failed = sum(not np.isfinite(r.train_history + r.valid_history).all()
                     for r in self.results)
        return {"train_windows_per_s": n / self.elapsed, "attempted": jobs,
                "failed": int(failed)}

    def traced(self) -> dict:
        n = int(self.traffic["trace_jobs"])
        for _ in range(n):
            self.traced_result = self._job()
        return {"jobs": n}

    def readings(self) -> dict:
        epochs = int(self.config["n_epochs"])
        # the first epoch of a job runs eagerly, before the capture
        return {"train_ms": [ms for r in self.results
                             for ms in r.train_ms[1:]],
                "eval_ms": [ms for r in self.results for ms in r.eval_ms[1:]],
                "window_s": self.elapsed, "jobs": len(self.results),
                "model_flops": len(self.results) * counts.train_model_flops(
                    self.config, self.train_x.shape[0],
                    self.valid_x.shape[0], epochs),
                "valid_rows": self.valid_x.shape[0],
                "batch": int(self.config["batch_size"]),
                "launches_per_epoch": self.launches,
                "setup_spans_s": self.setup.seconds}

    def release(self) -> None:
        last = self.results[-1]
        state = last.model.state_dict()
        self.last = {"train_history": list(last.train_history),
                     "valid_history": list(last.valid_history),
                     "kept": port_state_weights(state, self.weights)}
        del self.detector, self.results, self.model

    def reference(self, name: str = "float64", fault=None) -> dict:
        """One job of the reference in precision `name`, with `fault`
        planted (`reference.ae.train_job`)."""
        if (name, fault) in self._refs:
            return self._refs[name, fault]
        with precision(name) as dtype:
            self._refs[name, fault] = ref_ae.train_job(
                self.weights, self.train_x, self.valid_x, self.seed,
                int(self.config["batch_size"]), int(self.config["n_epochs"]),
                float(self.config["lr"]), dtype, fault)
        return self._refs[name, fault]

    def gaps(self, prog: dict, first_steps: dict) -> dict:
        """The training cell's numbers against the reference's float64 job:
        the first step's gradient and the change after three steps (the
        eager first epoch), the change after the second epoch (the first
        replayed one), each leaving out what the reference's first gradient
        moves by rounding alone; the first epoch's train and validation
        means, and those of the next two (replays); the kept model's
        validation loss, worked out by the reference, against the least
        validation mean the job reported."""
        ref = self.reference()
        keep = moving(ref["first_grad"])

        def loss_gap(epochs):
            return max(abs(prog[k][e] - ref[k][e]) / ref[k][e]
                       for k in ("train_history", "valid_history")
                       for e in epochs)

        kept = ref_ae.valid_mean(prog["kept"], self.valid_x,
                                 int(self.config["batch_size"]),
                                 torch.float64)
        replays = range(1, min(3, len(ref["train_history"])))
        return {
            "first_grad_gap": leaf_norm_gap(first_steps["first_grad"],
                                            ref["first_grad"]),
            "change3_gap": leaf_norm_gap(first_steps["change3"],
                                         ref["change3"], keep),
            "replay_change_gap": leaf_norm_gap(first_steps["change_e2"],
                                               ref["change_e2"], keep),
            "epoch1_loss_gap": loss_gap([0]),
            "replay_loss_gap": loss_gap(replays),
            "kept_valid_gap": abs(kept - min(prog["valid_history"])) / kept,
        }

    def check(self, limits: dict) -> list:
        got = self.gaps(self.last, self.first_steps)
        return [Check(k, v, limits[k]) for k, v in got.items() if k in limits]

    def control(self, limits: dict, what: str) -> list:
        """The reference put in the program's place: in the TF32 control's
        precision (`what` "tf32"), or in fp32 with a fault planted
        (`what` "fault:<name>")."""
        name, fault = ("float32", what[6:]) if what.startswith(
            "fault:") else (what, None)
        low = self.reference(name, fault)
        prog = {"train_history": low["train_history"],
                "valid_history": low["valid_history"],
                "kept": ref_ae.with_state(self.weights, low["best"],
                                          low["best_buffers"])}
        got = self.gaps(prog, low)
        return [Check(k, v, limits[k]) for k, v in got.items() if k in limits]


class EpochTap(io.TextIOBase):
    """Standard error for the trainer's prints, which calls `then()` when
    the progress line of epoch `epoch` (counted from 1) is written."""

    def __init__(self, epoch: int, then):
        self._mark, self._then, self._line = f"Epoch {epoch} ", then, ""

    def writable(self) -> bool:
        return True

    def write(self, text: str) -> int:
        self._line += text
        *done, self._line = self._line.split("\n")
        for line in done:
            if line.startswith(self._mark):
                self._then()
        return sys.stderr.write(text)


def port_state_weights(state: dict, template: list) -> list:
    """The port model's state (`state_dict`) in the layout of the drawn
    weights: the trained leaves and BN statistics the job kept."""
    out = []
    for l in template:
        base = f"{l['module']}.net.{l['index']}"
        layer = {**l, "w": state[f"{base}.layer.weight"].detach().clone(),
                 "b": state[f"{base}.layer.bias"].detach().clone()}
        if l["bn"] is not None:
            layer["bn"] = {"weight": state[f"{base}.bn.weight"],
                           "bias": state[f"{base}.bn.bias"],
                           "mean": state[f"{base}.bn.running_mean"],
                           "var": state[f"{base}.bn.running_var"]}
            layer["bn"] = {k: v.detach().clone()
                           for k, v in layer["bn"].items()}
        out.append(layer)
    return out
