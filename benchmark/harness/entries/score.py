"""Offline scoring: `ServingModel.score_nap_windows_with_loss` over a test
set that stays on the card, in the CLI's chunks.

Set-up draws the autoencoder, the fit and test windows (fused features
from the seed, the test set with its anomalous share), fits the NAP
whitening with the program's `ops/rapp.get_diffs` and `ops/scoring.nap_fit`,
builds the fp32 serving bundle and scores the test set `warmup_passes`
times.  The window scores it again and again, every pass ending with the
scores and per-window losses on the host, as the CLI's report reads them;
CUDA events around each chunk time it on the device.  The check compares
every pass's losses with the reference's, the program's whitening with the
one the reference fits itself from the same fit windows, and every pass's
scores with the reference's diffs scored through the program's whitening
and, by their median, through the reference's own.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import counts, inputs
from benchmark.harness.clock import Marks, SetupSpans
from benchmark.harness.port import launch_counts, port_config, port_model
from benchmark.reference import ae as ref_ae
from benchmark.reference import nap
from benchmark.reference.compare import Check, median_rel_gap, widest_rel_gap
from benchmark.reference.precision import precision


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from icra2021_multimodal_ad_tpu_torch.ops.rapp import get_diffs
        from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
            concat_diffs,
            nap_fit,
        )
        from icra2021_multimodal_ad_tpu_torch.ops.serving import make_serving

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.setup = SetupSpans(device)
        cfg = port_config(config)
        width = int(config["input_size"])
        with self.setup.span("inputs"):
            self.weights = inputs.ae_weights(config, seed, device,
                                             trained=True)
            model = port_model(config, self.weights, device)
            self.fit_x, _ = inputs.fused_windows(
                int(config["nap_fit_rows"]), width, seed, "fit", device)
            self.test_x, self.labels = inputs.fused_windows(
                int(traffic["test_windows"]), width, seed, "test", device,
                inputs.TEST_ANOMALY_SHARE)
        with self.setup.span("nap_fit"):
            stats = nap_fit(concat_diffs(get_diffs(
                self.fit_x, model, batch_size=int(config["batch_size"]))),
                method=config["nap_fit_method"])
        self.k, self.j = stats.rotater.v.shape
        self.fit_var = stats.standardizer.var
        self.floor = float(config.get("nap_var_floor_rel", 0.0))
        n, chunk = self.test_x.shape[0], int(traffic["chunk"])
        self.chunks = [(a, min(a + chunk, n)) for a in range(0, n, chunk)]
        self.passes, self._refs = [], {}
        with self.setup.span("warm_up"):
            self.serving = make_serving(cfg, model, nap_stats=stats,
                                        nap_var_floor_rel=self.floor or None,
                                        device=self.device)
            for _ in range(int(traffic["warmup_passes"])):
                self._pass()
        self.passes = []

    def _pass(self, marks=None) -> None:
        """Score the test set once, chunk by chunk, and bring the scores
        and losses to the host."""
        scores, losses = [], []
        for a, b in self.chunks:
            if marks is not None:
                marks.mark()
            s, l = self.serving.score_nap_windows_with_loss(
                self.test_x[a:b])
            if marks is not None:
                marks.mark()
            scores.append(s)
            losses.append(l)
        self.passes.append((torch.cat(scores).cpu(), torch.cat(losses).cpu()))

    def window(self, seconds: float) -> dict:
        marks = Marks(self.device)
        before = launch_counts()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            self._pass(marks)
        self.elapsed = time.perf_counter() - t0
        after = launch_counts()
        n_chunks = len(self.passes) * len(self.chunks)
        self.chunk_ms = marks.spans_ms([(2 * i, 2 * i + 1)
                                        for i in range(n_chunks)])
        self.launches = {k: (after[k] - before[k]) / n_chunks for k in after
                         if after[k] != before[k]}
        n = len(self.passes) * self.test_x.shape[0]
        failed = sum(int((~torch.isfinite(s)).sum() + (~torch.isfinite(l))
                         .sum()) for s, l in self.passes)
        return {"score_windows_per_s": n / self.elapsed, "attempted": n,
                "failed": failed}

    def traced(self) -> dict:
        n = int(self.traffic["trace_passes"])
        for _ in range(n):
            self._pass()
        return {"passes": n, "chunks": n * len(self.chunks)}

    def readings(self) -> dict:
        rows = [b - a for a, b in self.chunks]
        full = [ms for i, ms in enumerate(self.chunk_ms)
                if rows[i % len(rows)] == max(rows)]
        n = len(self.passes) * self.test_x.shape[0]
        return {"chunk_rows": rows, "k": self.k, "j": self.j,
                "passes": len(self.passes),
                "chunk_ms_full": float(np.median(full)),
                "window_s": self.elapsed,
                "model_flops": counts.score_model_flops(self.config, n,
                                                        self.j),
                "launches_per_chunk": self.launches,
                "setup_spans_s": self.setup.seconds}

    def release(self) -> None:
        st = self.serving.nap_stats
        self.prog_stats = {"mu": st.rotater.mu, "v": st.rotater.v,
                           "std_mu": st.standardizer.mu,
                           "var": st.standardizer.var,
                           "raw_var": self.fit_var}
        del self.serving

    @torch.no_grad()
    def reference(self, name: str = "float64") -> dict:
        """The reference in precision `name`: its whitening fitted from the
        fit windows ("fit"), the test set's diffs, scores and losses."""
        if name in self._refs:
            return self._refs[name]
        with precision(name) as dtype:
            model = ref_ae.Ae(self.weights, dtype, self.device)
            x = self.test_x.to(dtype)
            fit = nap.fit(ref_ae.concat_diffs(model, self.fit_x.to(dtype)),
                          self.floor)
            diffs = ref_ae.concat_diffs(model, x)
            self._refs[name] = {"fit": fit, "diffs": diffs,
                                "scores": nap.score(fit, diffs),
                                "losses": ref_ae.base_losses(model, x)}
        return self._refs[name]

    def gaps(self, answers, stats: dict) -> dict:
        """The numbers of `answers` (a list of passes' (scores, losses)) and
        of the whitening `stats` they were scored with, against the
        float64 reference: the fit held to the one the reference makes
        itself, its centring mean and its whitening (`nap.whiten_gap`,
        over the directions where fp32 can hold a fit); every score
        against the reference's diffs of the same window scored through
        `stats` in float64, which checks the diffs and the score's
        arithmetic past that fit (an independent fit differs from any fp32
        one in the few directions next to the variance floor, PERF.md
        section 6); the scores' median gap to the reference's own scores,
        which such a direction moves by ~1/J; every loss."""
        ref = self.reference()
        through = nap.score({k: v.double() for k, v in stats.items()},
                            ref["diffs"]).cpu()
        own, losses = ref["scores"].cpu(), ref["losses"].cpu()
        return {
            "nap_score_gap": max(widest_rel_gap(s.cpu(), through)
                                 for s, _ in answers),
            "nap_refit_gap": max(median_rel_gap(s.cpu(), own)
                                 for s, _ in answers),
            "fit_mean_gap": nap.mean_gap(stats, ref["fit"]),
            "fit_whiten_gap": nap.whiten_gap(stats, ref["fit"]),
            "base_loss_gap": max(widest_rel_gap(l.cpu(), losses)
                                 for _, l in answers)}

    def check(self, limits: dict) -> list:
        got = self.gaps(self.passes, self.prog_stats)
        return [Check(k, v, limits[k]) for k, v in got.items() if k in limits]

    def control(self, limits: dict, what: str) -> list:
        """The reference in `what` precision put in the program's place."""
        low = self.reference(what)
        got = self.gaps([(low["scores"], low["losses"])], low["fit"])
        return [Check(k, v, limits[k]) for k, v in got.items() if k in limits]
