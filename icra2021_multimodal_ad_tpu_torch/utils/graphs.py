"""Captured programs: the port's stand-in for `jax.jit` on the realtime tick,
the score server and the trainer's epochs.

The JAX package runs each streaming tick as one compiled device program
(`icra2021_multimodal_ad_tpu/data/streaming.py`, the `_tick_*` programs, and
`ops/mfcc._mfcc_wave_one_program`), each served request as one program per
(op, bucket) (`ops/score_server.py`), and each training epoch as one program
(`train.py`'s `train_epoch`, `eval_epoch`, `train_all_epochs`).  PyTorch
runs eagerly, so a tick of the port is ~80 small launches issued one by one
from the host.  A `Program` captures such a function once as a CUDA graph
and replays it as one launch:

  * it owns fixed buffers: for each slot, pinned host staging that the
    caller writes the next launch's inputs into; one set of device inputs;
    and, for a program whose output goes to the host, a pinned host output
    per slot.  Each slot's graph copies its staging to the device inputs,
    runs `fn`, and copies the output to the slot's host output, all inside
    the graph; each launch records the slot's event after the replay;
  * it warms `fn` up on a side stream before capturing, as
    `torch.cuda.graph`'s recipe does: the first calls build and load the
    kernel libraries, fill their per-device caches (`sm90::device_info`,
    `allow_smem`, `resident_blocks`), plan the FFT and make the cuBLAS and
    cuDNN handles, none of which may happen under capture.  A `stateful`
    program's function changes state that outlives it (an epoch's Adam
    steps and BN statistics), so it runs no warm-up passes of its own:
    until the caller calls `capture`, each launch calls `fn` once on the
    side stream, real work that is counted, and the caller's first launch
    is the warm-up;
  * every replay goes to the current stream, in order, so a cooperative
    kernel inside a graph never shares the card with another tick's work;
  * `fn` may issue the collectives of an NCCL mesh (the trainer's meshed
    epochs).  A collective's first call creates the communicator, which no
    capture may do: a stateful program's eager launches come before its
    capture and issue each collective once, and the graphs then record
    them on that communicator.  Every rank must capture and launch the
    same programs in the same order.  The capture is thread_local, so
    ProcessGroupNCCL's watchdog thread may query its events meanwhile.

Launch counts.  The kernels' wrappers count their launches (`counted`), but
a replay does not run the wrappers: a capture records what the wrappers
added while it ran (`recorded`), and each launch adds that again
(`add_counts`).  The warm-up passes are set-up, as a build is, and are not
counted; a stateful program's eager launches are counted as they run.

On the CPU, which only the tests use, a program calls `fn` eagerly on the
same staging, because the caller asked for the CPU.  On CUDA there is no
fallback: a capture or replay that fails raises.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401

#: warm-up passes over every slot before the capture
WARMUP_PASSES = 2

#: (function, attribute) of every launch count a replay adds to
COUNTERS: List[Tuple[object, str]] = []


def counted(fn, *attrs: str):
    """Give `fn` the launch counts `attrs`, each 0, and register them, so
    that a captured program replays what its capture added to them."""
    for attr in attrs:
        setattr(fn, attr, 0)
        COUNTERS.append((fn, attr))
    return fn


def _counts() -> List[int]:
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _set_counts(values: Sequence[int]) -> None:
    for (fn, attr), v in zip(COUNTERS, values):
        setattr(fn, attr, v)


def recorded(fn: Callable[[], object]) -> Tuple[object, List[int]]:
    """(fn's result, what fn added to every registered count), the counts
    put back as they were: a capture launches nothing, and what it added
    is what one replay launches."""
    before = _counts()
    out = fn()
    after = _counts()
    _set_counts(before)
    return out, [a - b for a, b in zip(after, before)]


def add_counts(delta: Sequence[int]) -> None:
    """Add one replay's launches to the registered counts."""
    _set_counts([c + d for c, d in zip(_counts(), delta)])


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


class Program:
    """`fn(*inputs) -> output` over fixed buffers, one CUDA graph per slot.

    inputs: (shape, dtype) of each input the host stages.  `fn` may read
    other fixed device tensors it closes over (another program's output).
    to_host: the output is copied to the slot's pinned host output inside
    the graph; else `output(slot)` is the graph's own device output.
    pool: a memory pool (`torch.cuda.graph_pool_handle()`) the graphs share
    with other programs' graphs; only for programs that never run at the
    same time and, being to_host, keep no device tensor of the pool alive
    between launches (None: a private pool per graph).
    stateful: no warm-up passes and no capture in the constructor; the
    launches before `capture` run `fn` eagerly on a side stream (above).
    A slot's staging may be rewritten once its last launch has finished:
    `staging` waits for that.  Capture and launches run on `device`, from
    whichever thread calls them."""

    def __init__(self, fn: Callable[..., torch.Tensor],
                 inputs: Sequence[Tuple[tuple, torch.dtype]],
                 device: torch.device, slots: int = 1,
                 to_host: bool = True, pool=None, stateful: bool = False):
        self.device = torch.device(device)
        self.fn = fn
        self.slots = slots
        self.to_host = to_host
        self.pool = pool
        self._cuda = self.device.type == "cuda"
        self._staging = [[torch.zeros(shape, dtype=dtype,
                                      pin_memory=self._cuda)
                          for shape, dtype in inputs]
                         for _ in range(slots)]
        self._outputs: List[Optional[torch.Tensor]] = [None] * slots
        self.launch_counts: Optional[List[int]] = None
        self._graphs: Optional[List[torch.cuda.CUDAGraph]] = None
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots
        if self._cuda:
            self._inputs = [torch.zeros(shape, dtype=dtype,
                                        device=self.device)
                            for shape, dtype in inputs]
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(slots)]
            self._side = torch.cuda.Stream(self.device)
            if not stateful:
                with torch.cuda.device(self.device):
                    self._warm_up()
                self.capture()

    def _body(self, slot: int) -> None:
        for dst, src in zip(self._inputs, self._staging[slot]):
            dst.copy_(src, non_blocking=True)
        out = self.fn(*self._inputs)
        if not self.to_host:
            self._outputs[slot] = out
            return
        if self._outputs[slot] is None:
            self._outputs[slot] = _pinned_like(out)
        self._outputs[slot].copy_(out, non_blocking=True)

    def _on_side(self, slots: Sequence[int], passes: int = 1) -> None:
        """`passes` calls of the body of each of `slots` on the side
        stream, after the current stream's work and before its next."""
        stream = torch.cuda.current_stream(self.device)
        self._side.wait_stream(stream)
        with torch.cuda.stream(self._side):
            for _ in range(passes):
                for slot in slots:
                    self._body(slot)
        stream.wait_stream(self._side)

    def _warm_up(self) -> None:
        recorded(lambda: self._on_side(range(self.slots), WARMUP_PASSES))

    def capture(self) -> None:
        """Capture every slot's graph (a stateful program's, once the
        caller's eager launches have warmed `fn` up); no-op on the CPU."""
        if not self._cuda:
            return
        if self.to_host:  # pinned memory cannot be allocated under capture
            done = next(o for o in self._outputs if o is not None)
            self._outputs = [_pinned_like(done) if o is None else o
                             for o in self._outputs]
        graphs = []
        with torch.cuda.device(self.device):
            for slot in range(self.slots):
                graph = torch.cuda.CUDAGraph()

                def capture():
                    # thread_local: a thread waiting on another tick's
                    # event, or NCCL's watchdog querying its own, while
                    # this one captures is no fault of the capture
                    with torch.cuda.graph(graph, pool=self.pool,
                                          capture_error_mode="thread_local"):
                        self._body(slot)

                _, delta = recorded(capture)
                graphs.append(graph)
        self.launch_counts = delta
        self._graphs = graphs

    def staging(self, slot: int = 0) -> List[np.ndarray]:
        """The slot's host staging as numpy arrays, for the next launch's
        inputs; waits first for the slot's last launch, which reads them."""
        self.wait(slot)
        return [t.numpy() for t in self._staging[slot]]

    def launch(self, slot: int = 0) -> None:
        """Replay the slot's graph on the current stream, record its event
        and add its launches to the counts; a stateful program not yet
        captured calls fn once on the side stream instead; on the CPU,
        call fn."""
        if not self._cuda:
            self._outputs[slot] = self.fn(*self._staging[slot])
            return
        with torch.cuda.device(self.device):
            if self._graphs is None:
                self._on_side([slot])
            else:
                self._graphs[slot].replay()
                add_counts(self.launch_counts)
            self.events[slot].record(torch.cuda.current_stream(self.device))

    def wait(self, slot: int = 0) -> None:
        """Until the slot's last launch has finished."""
        if self.events[slot] is not None:
            self.events[slot].synchronize()

    def output(self, slot: int = 0) -> torch.Tensor:
        """The slot's output: on the host once `wait(slot)` returned (a
        to_host program), or the graph's device output."""
        return self._outputs[slot]

    def release(self) -> None:
        """Destroy the graphs and drop `fn` and the buffers, once no launch
        is pending (the caller synchronizes): a program whose `fn` is a
        method of its owner is a cycle that only the collector would free
        otherwise, at a time of its own choosing."""
        for graph in self._graphs or ():
            graph.reset()
        self._graphs = None
        self.fn = None
        self._staging, self._outputs, self._inputs = [], [], []
