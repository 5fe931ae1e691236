"""The robot's tick: `StreamingDetector.run`, one robot in a closed loop.

The traffic's `nap` picks the score: NAP, or BASE (the mean squared
reconstruction error, the robot's default); its `compute_dtype`, where it
has one, the serving bundle's type (bf16: the streaming CLI's
`--compute_dtype bfloat16`, which floors the NAP whitening at 1e-6 of its
largest variance as the configuration does).  Set-up draws the autoencoder
and the fusion projection; for NAP it fits the whitening with the
program's own path (its realtime frontend fuses `nap_fit_rows` windows from
simulated steps, `ops/rapp.get_diffs` and `ops/scoring.nap_fit` fit them),
which BASE needs none of.  Then it builds the detector, fills its rings and
runs `warmup_ticks` ticks, which capture its programs.  In the window every
tick's `tick_hook` pushes the next pre-drawn robot step into the rings (the
steps cycle through a pool of `pool_steps`), and each tick is timed from
the hook's return to its `on_tick` call, its scores in host memory: two
CUDA events on the idle stream, so the card's clock reads the host's
interval.  The check recomputes a seeded sample of the window's ticks,
the last one with them, from the same steps: MFCC, normalization, fusion
and RaPP diffs, scored through the program's whitening; and holds that
whitening against the one the reference fits itself.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.harness import counts, inputs
from benchmark.harness.clock import SetupSpans, Stopwatch
from benchmark.harness.port import (
    launch_counts,
    port_config,
    port_fusion,
    port_model,
)
from benchmark.reference import ae as ref_ae
from benchmark.reference import frontend, nap
from benchmark.reference.compare import Check, median_rel_gap, widest_rel_gap
from benchmark.reference.precision import part, precision

#: int16 samples of one 0.1 s MFCC window
MIC_WINDOW = 4410


def mic_chunks_held(b: int, chunk_samples: int) -> int:
    """How many of the newest mic chunks a filled ring holds: the ring
    keeps at least (b + 2) windows of samples and drops its oldest chunk
    whenever the rest still hold them (the port's `MicRing`, whose rule
    this restates)."""
    return math.ceil(MIC_WINDOW * (b + 2) / chunk_samples)


class _Stop(Exception):
    """The window's time is up."""


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from icra2021_multimodal_ad_tpu_torch.data.streaming import (
            SensorSource,
            StreamingDetector,
        )

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.b = b = int(traffic["batch"])
        self.nap = bool(traffic["nap"])
        self.setup = SetupSpans(device)
        # the traffic's serving type, which only the detector's serving
        # bundle reads; the weights and the NAP fit stay in the
        # configuration's type, as the streaming CLI loads them
        cfg = port_config(config, batch_size=b,
                          compute_dtype=counts.compute_dtype(config, traffic))
        with self.setup.span("inputs"):
            self.weights = inputs.ae_weights(config, seed, device,
                                             trained=True)
            self.fusion = inputs.fusion_weights(seed, device)
            model = port_model(config, self.weights, device)
            fusion_params = port_fusion(self.fusion)
            self.held = mic_chunks_held(b, inputs.SensorSteps.CHUNK_SAMPLES)
            self.steps = inputs.SensorSteps(int(traffic["pool_steps"]), seed,
                                            "ticks", inputs.DROPS, device)
        stats = self._fit_nap(cfg, model, fusion_params) if self.nap else None
        with self.setup.span("warm_up"):
            self.detector = StreamingDetector(cfg, model, fusion_params,
                                              nap_stats=stats,
                                              device=self.device)
            self.source = SensorSource(b)
            self.cursor = 0
            for _ in range(b):
                self._push()
            self._ticks(int(traffic["warmup_ticks"]))
        self.window_ticks, self.refs = [], {}

    def _fit_nap(self, cfg, model, fusion_params):
        """NAP's whitening, fitted by the program's own path on ticks of
        normal steps, each from rings filled afresh."""
        from icra2021_multimodal_ad_tpu_torch.data.streaming import (
            hsr_window_batch,
        )
        from icra2021_multimodal_ad_tpu_torch.ops.mfcc import (
            mfcc_from_int16_chunks_device,
        )
        from icra2021_multimodal_ad_tpu_torch.ops.rapp import get_diffs
        from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
            concat_diffs,
            nap_effective_stats,
            nap_fit,
        )

        b, n_fit = self.b, int(self.config["nap_fit_rows"])
        with self.setup.span("fit_windows"):
            fit_steps = inputs.SensorSteps(-(-n_fit // b) * b, self.seed,
                                           "fit", device=self.device)
            self.fit_ticks = [self._snapshot(fit_steps, (j + 1) * b)
                              for j in range(fit_steps.n // b)]
            x_fit = torch.cat([hsr_window_batch(
                cfg, fusion_params, t["force"], t["hand"], t["depth"],
                mfcc_from_int16_chunks_device(
                    [c.tobytes() for c in t["chunks"]], cfg,
                    length=b / 10.0, device=self.device))
                for t in self.fit_ticks])[:n_fit]
        with self.setup.span("nap_fit"):
            stats = nap_fit(concat_diffs(get_diffs(x_fit, model)),
                            method=self.config["nap_fit_method"])
        self.k, self.j = stats.rotater.v.shape
        self.fit_var = stats.standardizer.var
        self.floor = float(self.config.get("nap_var_floor_rel", 0.0))
        return nap_effective_stats(stats, self.floor) if self.floor else stats

    def _snapshot(self, steps, cursor: int) -> dict:
        """The rings after `cursor` steps: the last b steps' force, frames,
        and the newest `held` mic chunks."""
        idx = [(cursor - self.b + i) % steps.n for i in range(self.b)]
        return {"force": [float(steps.force[i]) for i in idx],
                "hand": [steps.hand[i] for i in idx],
                "depth": [steps.depth[i] for i in idx],
                "chunks": [steps.chunk(c) for c in range(
                    cursor * steps.CHUNKS - self.held, cursor * steps.CHUNKS)]}

    def _push(self) -> None:
        """One robot step into the rings, as a robot's subscribers would."""
        s, i = self.steps, self.cursor % self.steps.n
        self.source.force_q.append(float(s.force[i]))
        self.source.hand_q.append(s.hand[i])
        self.source.depth_q.append(s.depth[i])
        for j in range(s.CHUNKS):
            self.source.mic_q.append(s.mic[i, j].tobytes())
        self.cursor += 1

    def _ticks(self, n: int) -> None:
        self.detector.run(self.source, n_ticks=n, nap=self.nap,
                          tick_hook=lambda k: self._push())

    def window(self, seconds: float) -> dict:
        watch = Stopwatch(self.device)
        lat_ms, pending = [], [False]
        deadline = time.perf_counter() + seconds

        def hook(k):
            if pending[0]:
                lat_ms.append(watch.read_ms())
                pending[0] = False
            self._push()
            watch.start()

        def on_tick(j, scores):
            watch.stop()
            pending[0] = True
            self.window_ticks.append((self.cursor, scores))
            if time.perf_counter() >= deadline:
                raise _Stop

        before = launch_counts()
        t0 = time.perf_counter()
        try:
            self.detector.run(self.source, n_ticks=1 << 40, nap=self.nap,
                              on_tick=on_tick, tick_hook=hook)
        except _Stop:
            pass
        elapsed = time.perf_counter() - t0
        lat_ms.append(watch.read_ms())
        after = launch_counts()
        n = len(lat_ms)
        self.lat_ms, self.elapsed = np.asarray(lat_ms), elapsed
        self.launches = {k: (after[k] - before[k]) / n for k in after
                         if after[k] != before[k]}
        failed = sum(not np.isfinite(s).all() for _, s in self.window_ticks)
        return {"tick_p95_ms": float(np.percentile(self.lat_ms, 95)),
                "tick_p50_ms": float(np.percentile(self.lat_ms, 50)),
                "attempted": n, "failed": int(failed)}

    def traced(self) -> dict:
        n = int(self.traffic["trace_ticks"])
        self._ticks(n)
        return {"ticks": n}

    def readings(self) -> dict:
        """The window's readings; the score (`nap`) decides the model FLOPs
        and, for NAP, the whitening's K and J."""
        if self.nap:
            flops = counts.score_model_flops(self.config, self.b, self.j)
            mode = {"nap": True, "k": self.k, "j": self.j}
        else:
            flops = counts.base_model_flops(self.config, self.b)
            mode = {"nap": False}
        return {"tick_mean_ms": float(self.lat_ms.mean()),
                "ticks": len(self.lat_ms), "window_s": self.elapsed,
                "model_flops": flops * len(self.lat_ms),
                "batch": self.b, **mode,
                "launches_per_tick": self.launches,
                "setup_spans_s": self.setup.seconds}

    def release(self) -> None:
        st = self.detector.nap_stats
        self.prog_stats = None if st is None else {
            "mu": st.rotater.mu, "v": st.rotater.v,
            "std_mu": st.standardizer.mu, "var": st.standardizer.var,
            "raw_var": self.fit_var}
        del self.detector, self.source

    def _sample(self):
        """A seeded sample of the window's ticks, the last one with them:
        their ring snapshots and the program's scores."""
        n = len(self.window_ticks)
        rng = np.random.default_rng([inputs.stream(self.seed, "check")])
        pick = set(rng.choice(n, size=min(int(self.traffic["check_ticks"]),
                                          n), replace=False).tolist())
        pick = sorted(pick | {n - 1})
        ticks = [self._snapshot(self.steps, self.window_ticks[i][0])
                 for i in pick]
        prog = torch.from_numpy(np.stack([self.window_ticks[i][1]
                                          for i in pick]))
        return ticks, prog

    @torch.no_grad()
    def reference(self, name: str = "float64") -> dict:
        """The reference in precision `name` (a split control's for each
        part) on the sampled ticks: its whitening fitted from the fit ticks
        ("fit"), or the fit of the precision a split control names for it,
        cast to this one's type; the ticks' windows' diffs, and their
        scores (NAP through that fit, or BASE)."""
        if name in self.refs:
            return self.refs[name]
        ticks, _ = self._sample()
        dev, b = self.device, self.b
        n_fit = int(self.config["nap_fit_rows"])
        # a split control may take its fit from another precision's run
        own_fit = part(name, "fit") == name
        other_fit = (None if own_fit or not self.nap
                     else self.reference(part(name, "fit"))["fit"])
        with precision(part(name, "frontend")) as dtype:
            x = frontend.tick_windows(self.fusion, ticks, b, dtype, dev)
            if self.nap and own_fit:
                x_fit = frontend.tick_windows(self.fusion, self.fit_ticks, b,
                                              dtype, dev)[:n_fit]
        with precision(part(name, "ae")) as dtype:
            model = ref_ae.Ae(self.weights, dtype, dev)
            if not self.nap:
                out = {"scores": ((model.forward(x) - x) ** 2).mean(dim=1)}
            else:
                if own_fit:
                    fit = nap.fit(ref_ae.concat_diffs(model, x_fit),
                                  self.floor)
                    del x_fit
                else:
                    fit = {k: v.to(dtype) for k, v in other_fit.items()}
                diffs = ref_ae.concat_diffs(model, x)
                out = {"fit": fit, "diffs": diffs,
                       "scores": nap.score(fit, diffs)}
        self.refs[name] = out
        return out

    def gaps(self, scores: torch.Tensor, stats) -> dict:
        """The numbers of the sampled ticks' `scores` and of the whitening
        `stats` they were scored with, against the float64 reference: the
        fit held to the one the reference makes itself, its centring mean
        and its whitening (`nap.whiten_gap`, over the directions where fp32
        can hold a fit); every score against the reference's diffs of the
        same window scored through `stats` in float64, which checks the
        frontend, the diffs and the score past that fit (an independent
        fit differs from any fp32 one in the few directions next to the
        variance floor, PERF.md section 6); the scores' median gap to the
        reference's own scores, which such a direction moves by ~1/J."""
        ref = self.reference()
        scores = scores.reshape(-1).cpu()
        if not self.nap:
            return {"base_score_gap": widest_rel_gap(scores, ref["scores"])}
        through = nap.score({k: v.double() for k, v in stats.items()},
                            ref["diffs"]).cpu()
        return {"nap_score_gap": widest_rel_gap(scores, through),
                "nap_refit_gap": median_rel_gap(scores, ref["scores"]),
                "fit_mean_gap": nap.mean_gap(stats, ref["fit"]),
                "fit_whiten_gap": nap.whiten_gap(stats, ref["fit"])}

    def check(self, limits: dict) -> list:
        _, prog = self._sample()
        got = self.gaps(prog, self.prog_stats)
        return [Check(k, v, limits[k]) for k, v in got.items() if k in limits]

    def control(self, limits: dict, what: str) -> list:
        """The reference in `what` precision put in the program's place, on
        the same sample of ticks."""
        low = self.reference(what)
        got = self.gaps(low["scores"], low.get("fit"))
        return [Check(k, v, limits[k]) for k, v in got.items() if k in limits]
