"""Realtime streaming inference: ring buffers, the simulated robot, the fused
window batch and the latency-instrumented scoring loop.

PyTorch counterpart of `icra2021_multimodal_ad_tpu/data/streaming.py` (the
reference's test_file/realtime_tester.py and the realtime half of
utils/data_loaders.py:601-737):

  * `RingBuffer` (deques of maxlen batch_size, with a lock) and `MicRing`
    (bounded by int16 samples, not chunks);
  * `SensorSource`, where a robot's subscribers plug in, and
    `SimulatedSensors`, whose numpy draws are JAX's, so a seed gives the
    same payloads byte for byte;
  * `get_realtime_dataloader`: mic chunks -> MFCC (the last batch_size
    frames), fixed-range normalization on the device, fusion -> (B, 1728);
  * `StreamingDetector`: each tick fuses the ring snapshots on the device
    and scores them (BASE, or NAP against persisted whitening stats)
    through the serving bundle of `ops/serving.py`, so every module pass
    launches the FC kernel and every NAP score the NAP kernel, or with
    `nap_quant="int8"` the int8 whitening product.

On the card each tick is two CUDA graph replays (`utils/graphs.Program`),
as JAX runs it as two compiled programs: the MFCC of the mic ring, one
program per floored wave length, writes its frames into a fixed device
buffer that the tick's program (normalize -> fuse -> forward -> score, one
per mode, serving bundle and payload shapes) reads; the ring snapshots go
to the card through pinned staging and the scores come back into a pinned
slot, both inside the graph.  The pipelined mode replays tick i into slot
i mod 2 on the one stream while tick i-1 is collected from its own slot;
the trace is the sequential one, bit for bit.  `score_rings_eager` issues
the same tick op by op, the reference the captured one is held against.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from icra2021_multimodal_ad_tpu_torch.models.autoencoder import AutoEncoder
from icra2021_multimodal_ad_tpu_torch.ops import frontend_kernel, serving
from icra2021_multimodal_ad_tpu_torch.ops.fusion import FusionParams
from icra2021_multimodal_ad_tpu_torch.ops.mfcc import (
    N_MFCC,
    floored_wave,
    mfcc_from_int16_chunks,
    mfcc_from_int16_chunks_device,
    mfcc_program,
)
from icra2021_multimodal_ad_tpu_torch.ops.scoring import NapStats
from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils.device import resolve_device
from icra2021_multimodal_ad_tpu_torch.utils.graphs import Program
from icra2021_multimodal_ad_tpu_torch.utils.profiling import span

#: slots of each program: a pipelined tick replays into one while the tick
#: before it is collected from the other
SLOTS = 2
#: ticks `latency_stats` drops: the first carries the programs' capture
WARMUP_TICKS = 1


class RingBuffer:
    """Fixed-capacity FIFO with an atomic snapshot (the deque handoff of
    realtime_tester.py:83,124-130,189, with explicit locking)."""

    def __init__(self, maxlen: int, clock=None):
        self._q = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._clock = clock if clock is not None else time.monotonic
        self.last_append = self._clock()  # liveness for the timeout checks

    def append(self, item) -> None:
        with self._lock:
            self._q.append(item)
            self.last_append = self._clock()

    def snapshot(self) -> list:
        with self._lock:
            return list(self._q)

    def __len__(self):
        with self._lock:
            return len(self._q)

    @property
    def full(self) -> bool:
        with self._lock:
            return len(self._q) == self._q.maxlen


class MicRing(RingBuffer):
    """Mic chunk ring bounded by TOTAL int16 samples, not chunk count:
    publishers push any chunk size, so a chunk-count cap either starves
    readiness or hoards memory.  Eviction keeps at least `budget_samples`;
    memory is bounded by the budget plus one chunk.  `full` reports against
    `ready_samples` (default: the budget)."""

    def __init__(self, budget_samples: int, clock=None,
                 ready_samples: Optional[int] = None):
        super().__init__(maxlen=None, clock=clock)
        self._budget = int(budget_samples)
        self._ready_samples = (int(ready_samples) if ready_samples
                               is not None else self._budget)
        self._samples = 0

    def append(self, item) -> None:
        with self._lock:
            self._q.append(item)
            self._samples += len(item) // 2  # int16 bytes -> samples
            while self._q and (
                self._samples - len(self._q[0]) // 2 >= self._budget
            ):
                self._samples -= len(self._q.popleft()) // 2
            self.last_append = self._clock()

    def sample_count(self) -> int:
        """Total int16 samples held, the counter kept under the lock."""
        with self._lock:
            return self._samples

    @property
    def full(self) -> bool:
        """Readiness in samples, not chunks."""
        with self._lock:
            return self._samples >= self._ready_samples


class SensorSource:
    """Anything that fills the four ring buffers: a robot's subscribers to
    the HSR topics (realtime_tester.py:48-49,104-111,169-175), or the
    simulator below."""

    #: MFCC window length in int16 samples (0.1 s at 44.1 kHz; the raw
    #: interleaved stream is one wave, as the reference's frombuffer at
    #: data_loaders.py:683 reads it)
    _MIC_WINDOW_SAMPLES = 4410

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.force_q = RingBuffer(batch_size)
        self.hand_q = RingBuffer(batch_size)
        self.depth_q = RingBuffer(batch_size)
        # ready() needs (batch_size + 1) windows of audio; one spare window
        # keeps a racing eviction from dipping below readiness
        self.mic_q = MicRing(
            self._MIC_WINDOW_SAMPLES * (batch_size + 2),
            ready_samples=self._MIC_WINDOW_SAMPLES * (batch_size + 1),
        )

    def ready(self) -> bool:
        """Every ring holds a full batch, the mic enough audio for
        batch_size MFCC frames."""
        return (self.force_q.full and self.hand_q.full
                and self.depth_q.full and self.mic_q.full)

    def stale_topics(self, timeout_s: float, now: Optional[float] = None):
        """Queues silent for longer than timeout_s (the reference's 10 s
        connection checks, realtime_tester.py:52-57)."""
        if now is None:
            now = time.monotonic()
        queues = {"force": self.force_q, "hand_camera": self.hand_q,
                  "depth": self.depth_q, "microphone": self.mic_q}
        return [name for name, q in queues.items()
                if now - q.last_append > timeout_s]


class SimulatedSensors(SensorSource):
    """Deterministic fake robot: each `tick()` pushes one 0.1 s step of all
    four modalities; `anomaly=True` injects the drop signature.  The draws
    are the JAX package's, in its order."""

    CHUNKS_PER_TICK = 5  # ~0.116 s of stereo 44.1 kHz audio, 1024-frame chunks

    def __init__(self, batch_size: int, seed: int = 0):
        super().__init__(batch_size)
        self._rng = np.random.default_rng(seed)

    def tick(self, anomaly: bool = False) -> None:
        rng = self._rng
        weight = 40.0 if anomaly else 210.0
        self.force_q.append(round(weight + rng.normal(0, 2), 1))
        bright = 180 if anomaly else 120
        self.hand_q.append(
            np.clip(rng.normal(bright, 25, (32, 32, 3)), 0, 255).astype(np.uint8)
        )
        # uint8, like a camera's payload: 1 byte per pixel to the card
        self.depth_q.append(
            np.clip(rng.normal(bright * 0.6, 20, (32, 32)), 0, 255).astype(
                np.uint8
            )
        )
        scale = 8000 if anomaly else 300
        for _ in range(self.CHUNKS_PER_TICK):
            chunk = rng.normal(0, scale, 1024 * 2).astype(np.int16)
            self.mic_q.append(chunk.tobytes())

    def fill(self, n_ticks: Optional[int] = None, anomaly_after: int = 10**9):
        n = n_ticks if n_ticks is not None else self.force_q._q.maxlen
        for i in range(n):
            self.tick(anomaly=i >= anomaly_after)


def _payload_dtype(frame) -> np.dtype:
    """A camera payload's staging type: uint8 frames go to the card at 1
    byte per pixel (the fixed-range normalization there is exact); other
    payloads become fp32."""
    dtype = np.asarray(frame).dtype
    return dtype if dtype == np.uint8 else np.dtype(np.float32)


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.float32): torch.float32}


def _check_rows(config, force_q, hand_q, depth_q, mic_frames) -> None:
    counts = {"force": len(force_q), "hand": len(hand_q),
              "depth": len(depth_q), "mic": len(mic_frames)}
    if any(c != config.batch_size for c in counts.values()):
        raise ValueError(
            f"modality row counts {counts} != batch_size "
            f"{config.batch_size} — wait for source.ready() before scoring"
        )


def _stack_host_inputs(config, force_q, hand_q, depth_q, mic_frames,
                       out=None):
    """Ring snapshots -> stacked host arrays, with the row-count guard: r
    (B, H, W, 3) as the camera publishes it (`_normalize_and_fuse` reads
    it so on the device), d with a channel dim, t and m as
    columns.  Camera frames keep their staging type (`_payload_dtype`).
    Device MFCC frames stay on the device.  `out`: the (r, d, t) arrays to
    stack into, a tick program's pinned staging; m is then the caller's."""
    _check_rows(config, force_q, hand_q, depth_q, mic_frames)
    if out is not None:
        r, d, t = out
        np.stack(hand_q, out=r)
        np.stack(depth_q, out=d[:, 0])
        t[:, 0] = force_q
        return r, d, t, None
    r, d = np.stack(hand_q), np.stack(depth_q)[:, None]
    r, d = (a.astype(_payload_dtype(a), copy=False) for a in (r, d))
    t = np.asarray(force_q, dtype=np.float32)[:, None]
    if isinstance(mic_frames, torch.Tensor):
        m = mic_frames.float()[:, None, :]
    else:
        m = np.array(mic_frames, dtype=np.float32)[:, None, :]
    return r, d, t, m


def _normalize_and_fuse(fusion_params: FusionParams, r, d, t, m
                        ) -> torch.Tensor:
    """Device side of the window batch: payloads go to the fusion params'
    device (a no-op for a program's device inputs), then the fixed-range
    normalization (images [0, 255], force [0, 400], mic by its batch
    min-max; HsrDataset, data_loaders.py:714-731) and the fusion, in fp32:
    on the card one launch of `ops/frontend_kernel.frontend_fuse` on the
    payloads as it reads them (`frontend_kernel.stage`), on the CPU its
    plain version, the stock ops."""
    dev = fusion_params.rgb1["w"].device
    r, d, t, m = (torch.as_tensor(v, device=dev) for v in (r, d, t, m))
    if dev.type != "cuda":
        return frontend_kernel.frontend_fuse_plain(fusion_params, r, d, t, m)
    return frontend_kernel.frontend_fuse(fusion_params,
                                         *frontend_kernel.stage(r, d, t, m))


def hsr_window_batch(config, fusion_params: FusionParams,
                     force_q, hand_q, depth_q, mic_frames) -> torch.Tensor:
    """Normalized, fused (batch_size, 1728) windows on the fusion params'
    device (HsrDataset, data_loaders.py:714-731)."""
    return _normalize_and_fuse(fusion_params, *_stack_host_inputs(
        config, force_q, hand_q, depth_q, mic_frames))


def get_realtime_dataloader(config, fusion_params: FusionParams,
                            force_q, hand_q, depth_q, mic_q) -> torch.Tensor:
    """(data_loaders.py:734-737) queues -> fused (batch_size, 1728) windows,
    the MFCC computed on the fusion params' device."""
    mic_frames = mfcc_from_int16_chunks(
        mic_q, config, length=config.batch_size / 10.0,
        device=fusion_params.rgb1["w"].device)
    return hsr_window_batch(config, fusion_params, force_q, hand_q, depth_q,
                            mic_frames)


# -- the ticks ---------------------------------------------------------------
# JAX compiles each tick (realtime_tester.py:291-309) into one program; here
# a tick is captured once per (BASE or NAP, serving bundle, payload shapes
# and types) as a CUDA graph (`utils/graphs.Program`), and the MFCC once per
# wave length.  The serving bundle's precision decides the score: fp32
# exact diffs and whitening on the un-floored stats, or bf16 diffs and
# whitening on the variance-floored ones; an int8 bundle (nap_quant)
# whitens the fp32 diffs of either with the int8 product.  The functions
# below are the tick's device work, eager or captured.


def _tick_base(bundle: serving.ServingModel, fusion_params: FusionParams,
               r, d, t, m) -> torch.Tensor:
    return bundle.score_fused(_normalize_and_fuse(fusion_params, r, d, t, m))


def _tick_nap(bundle: serving.ServingModel, fusion_params: FusionParams,
              r, d, t, m) -> torch.Tensor:
    return bundle.score_nap_windows(
        _normalize_and_fuse(fusion_params, r, d, t, m))


class _Tick(NamedTuple):
    """An issued tick: the slot of the program it replayed into, its start
    on the host clock, and the host clock when its first work was queued
    behind the slot's `issued` event (None for a tick issued alone)."""

    program: Program
    slot: int
    start_s: Optional[float] = None
    issued_s: Optional[float] = None


class StreamingDetector:
    """Tick loop: ring snapshots -> fuse -> score (BASE or NAP), with
    per-tick latency (realtime_tester.py:291-309), on `device`, the card
    unless the caller asks for the CPU.

    `config.compute_dtype` 'bfloat16' selects the serving bundle's bf16
    path for both scores (the NAP one on variance-floored stats, the path
    `ops/serving.nap_accuracy_guard` certifies); fp32 is the exact path.
    `config.nap_quant` 'int8' whitens the NAP score with the int8 product,
    independently of the compute dtype: an fp32 + int8 config feeds exact
    fp32 diffs into it."""

    def __init__(self, config, model: AutoEncoder,
                 fusion_params: FusionParams,
                 nap_stats: Optional[NapStats] = None, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.model = model
        self.fusion_params = fusion_params.to(self.device)
        self.nap_stats = nap_stats
        self.latencies_s: list = []
        self._serving_cache = None
        # the tick's MFCC frames: the MFCC programs write them, the tick
        # programs read them
        self._mic = torch.zeros(config.batch_size, N_MFCC,
                                device=self.device)
        self._mfcc_programs: Dict[int, Program] = {}
        # per slot, the event queued before a tick's first work: with the
        # slot's program event it times the tick on the device
        self._issued = ([torch.cuda.Event(enable_timing=True)
                         for _ in range(SLOTS)]
                        if self.device.type == "cuda" else None)

    def _bundle_and_programs(self) -> Tuple[serving.ServingModel, dict]:
        """The serving bundle every tick scores with and the tick programs
        captured on it, built once and again when the caller swaps
        `self.nap_stats`."""
        if (self._serving_cache is None
                or self._serving_cache[0] is not self.nap_stats):
            bundle = serving.make_serving(self.config, self.model,
                                          nap_stats=self.nap_stats,
                                          device=self.device)
            self._serving_cache = (self.nap_stats, bundle, {})
        return self._serving_cache[1:]

    def _serving(self) -> serving.ServingModel:
        return self._bundle_and_programs()[0]

    def _check_nap(self, nap: bool) -> None:
        if nap and self.nap_stats is None:
            raise ValueError("NAP streaming needs persisted NapStats")

    def score_batch(self, x, nap: bool = False) -> np.ndarray:
        """Scores of already-fused windows, on the host."""
        self._check_nap(nap)
        bundle = self._serving()
        x = torch.as_tensor(x, device=self.device)
        scores = bundle.score_nap_windows(x) if nap else bundle.score_fused(x)
        return scores.cpu().numpy()

    def _tick_program(self, nap: bool, hand_q, depth_q) -> Program:
        """The tick's program for (BASE or NAP, the current bundle, the
        camera payloads' shapes and types), captured at first use."""
        bundle, programs = self._bundle_and_programs()
        r0, d0 = np.asarray(hand_q[0]), np.asarray(depth_q[0])
        rt, dt = _payload_dtype(r0), _payload_dtype(d0)
        key = (nap, r0.shape, rt, d0.shape, dt)
        if key not in programs:
            tick = _tick_nap if nap else _tick_base
            fusion_params, mic = self.fusion_params, self._mic

            def fn(r, d, t):
                return tick(bundle, fusion_params, r, d, t, mic[:, None, :])

            b = self.config.batch_size
            programs[key] = Program(
                fn, [((b, *r0.shape), _TORCH_DTYPES[rt]),
                     ((b, 1, *d0.shape), _TORCH_DTYPES[dt]),
                     ((b, 1), torch.float32)], self.device, slots=SLOTS)
        return programs[key]

    def dispatch_queues(self, force_q, hand_q, depth_q, mic_frames,
                        nap: bool = False, slot: int = 0) -> _Tick:
        """Issue one tick into `slot` of its program, one replay, without
        waiting for it: the ring snapshots are stacked straight into the
        slot's pinned staging, and MFCC frames other than the detector's
        own (an MFCC program's output) are copied there first."""
        with span("tick.stage"):
            _check_rows(self.config, force_q, hand_q, depth_q, mic_frames)
            self._check_nap(nap)
            program = self._tick_program(nap, hand_q, depth_q)
            _stack_host_inputs(self.config, force_q, hand_q, depth_q,
                               mic_frames, out=program.staging(slot))
            if mic_frames is not self._mic:
                self._mic.copy_(
                    mic_frames if isinstance(mic_frames, torch.Tensor)
                    else torch.from_numpy(np.array(mic_frames,
                                                   dtype=np.float32)))
        program.launch(slot)
        return _Tick(program, slot)

    @staticmethod
    def _scores(tick: _Tick) -> np.ndarray:
        with span("tick.wait"):
            tick.program.wait(tick.slot)
        return tick.program.output(tick.slot).numpy().copy()

    def score_queues(self, force_q, hand_q, depth_q, mic_frames,
                     nap: bool = False) -> np.ndarray:
        """One tick: ring snapshots (and MFCC frames) -> normalize -> fuse
        -> forward -> score, on the host.  The same numbers as
        hsr_window_batch + score_batch."""
        return self._scores(self.dispatch_queues(force_q, hand_q, depth_q,
                                                 mic_frames, nap=nap))

    def _issue(self, slot: int, force_q, hand_q, depth_q, mic_chunks,
               nap: bool, start_s: Optional[float] = None) -> _Tick:
        """A whole tick into `slot`: the mic's floored wave into its MFCC
        program's staging, that program's replay, then the tick's.  The
        host stages the tick program's inputs while the MFCC replay runs,
        so that staging's span (`tick.stage`) nests inside `tick.launch`,
        which runs from the first replay's launch to the second's."""
        if self._issued is not None:
            self._issued[slot].record(torch.cuda.current_stream(self.device))
        issued_s = time.perf_counter()
        with span("tick.mfcc_stage"):
            wave = floored_wave(mic_chunks, self.config,
                                length=self.config.batch_size / 10.0)
            if len(wave) not in self._mfcc_programs:
                self._mfcc_programs[len(wave)] = mfcc_program(
                    len(wave), self.config.batch_size, self._mic,
                    slots=SLOTS)
            mfcc = self._mfcc_programs[len(wave)]
            mfcc.staging(slot)[0][:] = wave
        with span("tick.launch"):
            mfcc.launch(slot)
            tick = self.dispatch_queues(force_q, hand_q, depth_q, self._mic,
                                        nap=nap, slot=slot)
        return tick._replace(start_s=start_s, issued_s=issued_s)

    def score_rings(self, force_q, hand_q, depth_q, mic_chunks,
                    nap: bool = False) -> np.ndarray:
        """One whole tick from the four ring snapshots, the mic's raw int16
        chunks included, as `run` scores it: on the card two replays, the
        MFCC program and the tick program."""
        return self._scores(self._issue(0, force_q, hand_q, depth_q,
                                        mic_chunks, nap))

    def score_rings_eager(self, force_q, hand_q, depth_q, mic_chunks,
                          nap: bool = False) -> np.ndarray:
        """`score_rings` issued op by op, without a program: the reference
        that the captured tick is held against, bit for bit, on the card."""
        self._check_nap(nap)
        mic = mfcc_from_int16_chunks_device(
            mic_chunks, self.config, length=self.config.batch_size / 10.0,
            device=self.device)
        tick = _tick_nap if nap else _tick_base
        return tick(self._serving(), self.fusion_params, *_stack_host_inputs(
            self.config, force_q, hand_q, depth_q, mic)).cpu().numpy()

    def _guard_live(self, source: SensorSource, mic_frames,
                    nap: bool, tol: float) -> Optional[float]:
        """Deploy guard on live data: fuse the first ready snapshot and hold
        the low-precision bundle (bf16, or int8 NAP) against fp32 on the same
        variance floor before any score is trusted.  Raises ValueError above
        tol; returns the measured relative error, or None for a
        configuration without a low-precision path."""
        int8 = nap and getattr(self.config, "nap_quant", None) == "int8"
        if (getattr(self.config, "compute_dtype", "float32") != "bfloat16"
                and not int8):
            return None
        self._check_nap(nap)
        x = hsr_window_batch(self.config, self.fusion_params,
                             source.force_q.snapshot(),
                             source.hand_q.snapshot(),
                             source.depth_q.snapshot(), mic_frames)
        if nap:
            # certifies the very bundle the ticks score with
            rel = serving.nap_accuracy_guard(
                self.config, self.model, self.nap_stats, x, tol=tol,
                fast_serving=self._serving())
            print(f"serving guard ({'int8' if int8 else 'bf16'} NAP vs "
                  f"fp32, live batch): rel err {rel:.4f} <= tol {tol}")
        else:
            rel = serving.bf16_accuracy_guard(self.config, self.model, x,
                                              tol=tol, device=self.device)
            print(f"serving guard (bf16 BASE vs fp32, live batch): "
                  f"rel err {rel:.4f} <= tol {tol}")
        return rel

    def _collect(self, tick: _Tick, traces: list,
                 on_tick: Optional[Callable]) -> None:
        """Wait for a tick's scores, note its latency and hand them on.  On
        the card the arrival is read off the device's clock: `run` issues a
        tick onto an idle stream (the tick before it has left the device in
        either mode), so its `issued` event fired at its host issue time,
        and its program's event when the scores were in pinned host
        memory."""
        with span("tick.collect"):
            scores = self._scores(tick)
            if self._issued is None:
                done_s = time.perf_counter()
            else:
                issued = self._issued[tick.slot]
                done_s = tick.issued_s + issued.elapsed_time(
                    tick.program.events[tick.slot]) / 1e3
            self.latencies_s.append(done_s - tick.start_s)
            traces.append(scores)
            if on_tick is not None:
                on_tick(len(traces) - 1, scores)

    def run(self, source: SensorSource, n_ticks: int = 300,
            nap: bool = False,
            on_tick: Optional[Callable] = None,
            tick_hook: Optional[Callable] = None,
            connection_timeout_s: Optional[float] = None,
            guard_tol: Optional[float] = None,
            pipelined: bool = False) -> np.ndarray:
        """Returns the (n_ticks, batch_size) score trace.

        Each tick is two replays on the card (`_issue`): the MFCC program
        and the tick program.  A tick's latency runs from its start to the
        moment its scores are on the host.  pipelined: tick i starts once
        tick i-1 has left the device, replays into slot i mod 2, and tick
        i-1 is collected from its own slot (its scores read, its latency
        noted, on_tick called) while tick i runs, as is the next tick_hook;
        a slot's staging is rewritten only once its last tick has
        finished.  on_tick(j, scores_j) therefore fires during tick j+1,
        and the last tick's scores after the loop.  A tick never queues
        behind another on the device, so its latency is the sequential
        one, and the host's work around it overlaps it.  The trace is the
        sequential one, bit for bit: the same programs, another schedule.

        guard_tol: run _guard_live on the first ready snapshot, eagerly,
        before the first tick (a no-op on the exact fp32 configuration).
        connection_timeout_s: every tick raises SensorTimeout when a queue
        has been silent that long.  Cold start: a tick is scored only once
        `source.ready()`; the wait aborts when a queue goes silent for
        connection_timeout_s (default CONNECTION_TIMEOUT_S), never for a
        slow fill.  tick_hook(k) sees each invocation index once, warm-up
        iterations included.

        Spans (`utils/profiling.span`, recorded only while a profiler
        runs): `run.hook` around each tick_hook call; `tick` around each
        iteration that issues a tick, through the collect that follows it
        (pipelined: tick i-1's, so the last tick's collect lies outside any
        `tick`); inside it `tick.snapshot` (the four ring snapshots),
        `tick.mfcc_stage`, `tick.launch` (which holds `tick.stage`) and
        `tick.collect` (which holds `tick.wait`, the host blocked on the
        card)."""
        from icra2021_multimodal_ad_tpu_torch.data.acquisition import (
            CONNECTION_TIMEOUT_S,
        )
        from icra2021_multimodal_ad_tpu_torch.data.orchestration import (
            SensorTimeout,
        )

        warmup_silence_s = (connection_timeout_s if connection_timeout_s
                            is not None else CONNECTION_TIMEOUT_S)
        traces = []
        pending = None  # pipelined mode: tick i-1
        # per-run accounting: latency_stats describes the latest run
        self.latencies_s = []
        i = 0
        hook_i = 0
        while i < n_ticks:
            if tick_hook is not None:
                with span("run.hook"):
                    tick_hook(hook_i)  # simulator advance / rate limiting
                hook_i += 1
            if connection_timeout_s is not None:
                dead = source.stale_topics(connection_timeout_s)
                if dead:
                    raise SensorTimeout.for_topics(dead, connection_timeout_s)
            if not source.ready():
                dead = source.stale_topics(warmup_silence_s)
                if dead:
                    raise SensorTimeout.for_topics(dead, warmup_silence_s)
                time.sleep(0.01 if tick_hook is None else 0.001)
                continue
            with span("tick"):
                if pending is not None:
                    pending.program.wait(pending.slot)
                start = time.perf_counter()
                with span("tick.snapshot"):
                    chunks = source.mic_q.snapshot()
                    rings = (source.force_q.snapshot(),
                             source.hand_q.snapshot(),
                             source.depth_q.snapshot())
                if guard_tol is not None and i == 0:
                    self._guard_live(source, mfcc_from_int16_chunks_device(
                        chunks, self.config,
                        length=self.config.batch_size / 10.0,
                        device=self.device), nap, guard_tol)
                tick = self._issue(i % SLOTS if pipelined else 0, *rings,
                                   chunks, nap, start)
                if pipelined:
                    if pending is not None:
                        self._collect(pending, traces, on_tick)
                    pending = tick
                else:
                    self._collect(tick, traces, on_tick)
            i += 1
        if pending is not None:  # the last pipelined tick
            self._collect(pending, traces, on_tick)
        if not traces:
            return np.empty((0, 0))
        return np.stack(traces)

    def latency_stats(self) -> dict:
        """Percentiles over the latest run's per-tick latencies, its warm-up
        ticks dropped."""
        if not self.latencies_s:
            return {"p50_ms": float("nan"), "p95_ms": float("nan"),
                    "mean_ms": float("nan"), "ticks": 0}
        lat = np.asarray(self.latencies_s[WARMUP_TICKS:]
                         or self.latencies_s)
        return {
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "mean_ms": float(lat.mean() * 1e3),
            "ticks": int(len(self.latencies_s)),
        }
