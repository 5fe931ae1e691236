"""Network scoring service around ops/serving: PyTorch counterpart of
`icra2021_multimodal_ad_tpu/ops/score_server.py`, with the same wire
protocol byte for byte (so `native/score_client.cpp` and the JAX package's
ScoreClient are served unchanged).

The reference scored its own ring buffers in-process
(test_file/realtime_tester.py:260-309).  This module serves the same
scorers over a socket, so a robot host or any client scores window batches
against one resident process on the card: the checkpoint and the NAP stats
load once, the kernels build once.

    server = ScoreServer(config, model, nap_stats=stats)
    port = server.start()                      # background threads
    client = ScoreClient(("127.0.0.1", port))
    scores = client.score(windows, op="score_nap")   # (B,) fp32
    client.close(); server.stop()

Design points:
  * **Bucketed padding**: a request's rows are padded with zeros to the
    next power of two (capped at max_batch) and the pad scores sliced off;
    eval-mode BN couples no rows, so a ragged request scores as its rows
    alone.  In JAX the buckets bound the compiles; here they keep the same
    contract, and a padded batch may take another kernel variant than its
    unpadded rows would.
  * **One program per request**: on the card every (op, bucket, payload
    shapes) is one CUDA graph (`ops/serving.ServingPrograms`), captured at
    its first request or by warmup(), as JAX compiles one program per
    bucket: a chunk of a request is one replay, its rows staged in pinned
    memory and its scores copied back inside the graph.  The eager path
    (`_score_eager`, `_score_sensor_op_eager`) is the reference the
    programs are held against, bit for bit.
  * **One card, one scorer**: device work runs under the score lock, on
    the current stream, and the scores reach the host before the lock is
    released; the accept loop is threaded, so slow clients do not block
    handshakes.
  * **Dynamic batching**: concurrent requests for the same op coalesce into
    ONE scoring call (rows concatenated, scores split back per request).
    No linger timer: the batcher drains whatever queued while the previous
    call ran, so an idle server adds no latency.
  * **Deploy guard at startup**, not per request: serve_guard() runs the
    ops/serving accuracy guards on a probe batch before the socket opens,
    so a server that would stream uncertified low-precision scores never
    comes up.
  * Wire format: 4-byte big-endian length frames; request = one JSON
    header line + raw little-endian float32 row-major array bytes.  Bad
    requests get an {"ok": false, "error": ...} frame; a malformed FRAME
    (garbage length prefix, invalid JSON) gets the error frame and then a
    closed connection, since the stream position can no longer be trusted.

Ops: score_base | score_sap | score_nap (fused (B, input) windows ->
(B,) fp32 scores), score_base_sensor | score_sap_sensor |
score_nap_sensor (NATIVE payloads, uint8 camera/depth frames, newtons,
MFCC frames, fused and normalized SERVER-side; see SENSOR_OPS), and info
(JSON metadata: input size, dtype, quant, guard measurement).

The module imports numpy and the stdlib only; ScoreServer imports torch
when it is built, so a robot-side client needs no torch.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Optional, Tuple

import numpy as np

_HDR = struct.Struct(">I")
#: absolute frame-size ceiling (guards the server against a garbage length
#: prefix allocating gigabytes): 1 GiB covers 16384 x 8192 fp32 windows
_MAX_FRAME = 1 << 30


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def _send_frame(sock: socket.socket, header: dict,
                payload: bytes = b"") -> None:
    head = json.dumps(header).encode() + b"\n"
    sock.sendall(_HDR.pack(len(head) + len(payload)) + head + payload)


def _recv_frame(sock: socket.socket) -> Tuple[dict, bytes]:
    (n,) = _HDR.unpack(_read_exact(sock, _HDR.size))
    if n > _MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds the 1 GiB ceiling")
    blob = _read_exact(sock, n)
    head, _, payload = blob.partition(b"\n")
    return json.loads(head.decode()), payload


def _next_bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


class _Pending:
    """One enqueued scoring request awaiting the batcher."""

    __slots__ = ("op", "x", "scores", "error", "done")

    def __init__(self, op: str, x: np.ndarray):
        self.op = op
        self.x = x
        self.scores: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.done = threading.Event()


class ScoreServer:
    """Serve a ServingModel's window and sensor scorers over TCP (loopback
    by default) from `device`, the card unless the caller asks for the
    CPU, each request through the bundle's captured programs.
    start() binds, spawns the accept thread, and returns the port; stop()
    shuts it down.  Thread-safe for many clients; device work is
    serialized (one card)."""

    OPS = ("score_base", "score_sap", "score_nap")
    #: raw-sensor ops: the client ships NATIVE payloads (uint8 camera/depth
    #: frames, force in newtons, fp32 MFCC frames) and the SERVER fuses —
    #: thin clients need no fusion convs, and the image bytes on the wire
    #: drop 4x vs fp32 fused windows.  Normalization is per REQUEST (the
    #: reference's ring-snapshot semantics: the mic frames take a batch-
    #: global min-max), so these ops are never coalesced across requests
    #: and never chunked — a request IS the normalization window.
    SENSOR_OPS = ("score_base_sensor", "score_sap_sensor",
                  "score_nap_sensor")

    def __init__(self, config, model, nap_stats=None,
                 max_batch: int = 16384, host: str = "127.0.0.1",
                 batching: bool = True, device="cuda"):
        from icra2021_multimodal_ad_tpu_torch.ops.fusion import fusion_init
        from icra2021_multimodal_ad_tpu_torch.ops.serving import (
            ServingPrograms,
            make_serving,
        )
        from icra2021_multimodal_ad_tpu_torch.utils.device import (
            resolve_device,
        )

        dev = resolve_device(device)
        self.config = config
        fusion_params = None
        if getattr(config, "sensor", None) == "All":
            # the fusion frontend is a SEEDED fixed random projection
            # (ops/fusion.py): the server rebuilds it from config.seed
            # exactly like the CLIs (realtime_tester.py:102)
            fusion_params = fusion_init(config.seed, dev)
        self.serving = make_serving(config, model, nap_stats=nap_stats,
                                    fusion_params=fusion_params, device=dev)
        self.programs = ServingPrograms(self.serving)
        self.max_batch = int(max_batch)
        self.host = host
        self.batching = bool(batching)
        self.input_size = int(config.input_size)
        self.guard_rel: Optional[float] = None
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._batch_thread: Optional[threading.Thread] = None
        self._score_lock = threading.Lock()
        self._stopping = threading.Event()
        # accepted client connections, so stop() can close them: a handler
        # blocked in _recv_frame (600 s timeout) would otherwise survive
        # stop() and be silently revived by the next start()'s
        # _stopping.clear() — 'stopped' clients kept being served by the
        # new server generation
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._queue: list = []
        self._queue_cond = threading.Condition()
        #: dynamic-batching observability: dispatches that served >1
        #: request, requests so coalesced, and the largest coalesced group
        self.batch_stats = {"requests": 0, "coalesced_dispatches": 0,
                            "coalesced_requests": 0, "max_group": 0}
        # model and stats for the startup guard
        self._guard_args = (model, nap_stats)

    # -- deploy guard -------------------------------------------------------

    def serve_guard(self, probe: np.ndarray, tol: float) -> Optional[float]:
        """Run the ops/serving accuracy guard for this bundle's precision
        on a probe batch of fused windows; raises above tol.  Returns the
        measured rel err, or None for exact-fp32 bundles (nothing to
        guard).  Call before start() — the eval CLIs' --guard_tol
        contract, applied to the server."""
        from icra2021_multimodal_ad_tpu_torch.ops.serving import (
            run_precision_guard,
        )

        model, nap_stats = self._guard_args
        self.guard_rel = run_precision_guard(
            self.config, model, nap_stats, probe, tol,
            serving=self.serving)
        return self.guard_rel

    # -- scoring ------------------------------------------------------------

    def _to_device(self, a: np.ndarray):
        import torch

        # a request's arrays view its read-only frame: torch wants them
        # writable and contiguous (a copy only where they are not)
        return torch.from_numpy(np.require(a, requirements="CW")).to(
            self.serving.device)

    def _chunked(self, x: np.ndarray, score_chunk) -> np.ndarray:
        """score_chunk(rows, bucket) on each max_batch chunk of x's rows,
        under the score lock: requests larger than max_batch score in
        max_batch chunks, each padded to its bucket."""
        n = x.shape[0]
        out = np.empty(n, np.float32)
        for done in range(0, n, self.max_batch):
            rows = x[done:done + self.max_batch]
            with self._score_lock:
                out[done:done + len(rows)] = score_chunk(
                    rows, _next_bucket(len(rows), self.max_batch))
        return out

    def _score(self, op: str, x: np.ndarray) -> np.ndarray:
        """Scores of fused windows: one replay of (op, bucket)'s program
        per chunk, finished and its scores on the host before the lock
        goes (the next replay overwrites them)."""
        return self._chunked(x, lambda rows, bucket: self.programs.score(
            op, bucket, np.asarray(rows, np.float32)))

    def _score_eager(self, op: str, x: np.ndarray) -> np.ndarray:
        """`_score` op by op, without a program: the reference."""
        from icra2021_multimodal_ad_tpu_torch.ops.serving import SERVED_OPS

        def score_chunk(rows, bucket):
            xb = np.zeros((bucket, x.shape[1]), np.float32)
            xb[:len(rows)] = rows
            s = SERVED_OPS[op][0](self.serving, self._to_device(xb))
            # on the host before the lock goes: the next call may not
            # overlap this one's work on the card
            return s.cpu().numpy()[:len(rows)]

        return self._chunked(x, score_chunk)

    #: wire dtypes of the sensor-op payload segments, in payload order
    _SENSOR_FIELDS = (("r", np.uint8, 4), ("d", np.uint8, 4),
                      ("t", "<f4", 2), ("m", "<f4", 3))

    def _sensor_bucket(self, n: int) -> int:
        if n > self.max_batch:
            raise ValueError(
                f"sensor requests are capped at max_batch={self.max_batch} "
                f"rows (got {n}): a request is the normalization window — "
                "chunk client-side to choose the windows explicitly")
        return _next_bucket(n, self.max_batch)

    def _score_sensor_op(self, op: str, r: np.ndarray, d: np.ndarray,
                         t: np.ndarray, m: np.ndarray) -> np.ndarray:
        """Score one raw-sensor request by one replay of (op, bucket,
        payload shapes)'s program.  Pad rows to the bucket by EDGE
        REPLICATION: the mic normalization is batch-global min-max
        (ops/fusion.normalize_mods), so zero rows would shift the range
        and perturb real rows' scores; replicated real rows cannot."""
        bucket = self._sensor_bucket(r.shape[0])
        with self._score_lock:
            return self.programs.score(op, bucket, r, d, t, m)

    def _score_sensor_op_eager(self, op: str, r: np.ndarray, d: np.ndarray,
                               t: np.ndarray, m: np.ndarray) -> np.ndarray:
        """`_score_sensor_op` op by op, without a program: the reference."""
        from icra2021_multimodal_ad_tpu_torch.ops.serving import SERVED_OPS

        n = r.shape[0]
        bucket = self._sensor_bucket(n)

        def pad(a):
            if bucket == n:
                return a
            reps = np.broadcast_to(a[:1], (bucket - n,) + a.shape[1:])
            return np.concatenate([a, reps], axis=0)

        with self._score_lock:
            s = SERVED_OPS[op][0](self.serving, *(
                self._to_device(pad(a)) for a in (r, d, t, m)))
            return s.cpu().numpy()[:n]

    def _score_batched(self, op: str, x: np.ndarray) -> np.ndarray:
        """Enqueue for the dynamic batcher and wait; exact per-request
        scores (row-independent scorers — see the module docstring)."""
        req = _Pending(op, x)
        with self._queue_cond:
            self._queue.append(req)
            self._queue_cond.notify()
        while not req.done.wait(timeout=1.0):
            # a dead batcher — stop(), a crash that escaped the per-group
            # except (BaseException), or never started — can no longer
            # complete this request: fail fast instead of polling forever
            if (self._batch_thread is None
                    or not self._batch_thread.is_alive()):
                raise ConnectionError(
                    "server stopped mid-request"
                    if self._stopping.is_set()
                    else "dynamic batcher is not running")
        if req.error is not None:
            raise req.error
        return req.scores

    def _batch_loop(self) -> None:
        """Drain-coalesce-dispatch: everything that queued while the last
        dispatch was in flight scores as one program per op."""
        while True:
            with self._queue_cond:
                while not self._queue and not self._stopping.is_set():
                    self._queue_cond.wait(timeout=0.5)
                if self._stopping.is_set() and not self._queue:
                    return
                pending, self._queue = self._queue, []
            groups: dict = {}
            for req in pending:
                groups.setdefault(req.op, []).append(req)
            for op, reqs in groups.items():
                self.batch_stats["requests"] += len(reqs)
                if len(reqs) > 1:
                    self.batch_stats["coalesced_dispatches"] += 1
                    self.batch_stats["coalesced_requests"] += len(reqs)
                    self.batch_stats["max_group"] = max(
                        self.batch_stats["max_group"], len(reqs))
                try:
                    if len(reqs) == 1:
                        reqs[0].scores = self._score(op, reqs[0].x)
                    else:
                        scores = self._score(
                            op, np.concatenate([r.x for r in reqs], axis=0))
                        at = 0
                        for r in reqs:
                            r.scores = scores[at:at + r.x.shape[0]]
                            at += r.x.shape[0]
                except Exception as e:  # noqa: BLE001 — delivered per request
                    for r in reqs:
                        r.error = e
                for r in reqs:
                    r.done.set()

    def warmup(self) -> list:
        """Capture every served op's program at the smallest and the
        largest bucket, on zero probes (the sensor ops on 32 x 32 frames),
        as JAX compiles them, so the first client requests do not pay the
        kernels' build and load, cuBLAS's and cuDNN's set-up or a capture.
        Other buckets and payload shapes are captured at their first
        request.  Returns the ops warmed.  Call before start()."""
        probe = np.zeros((self.max_batch, self.input_size), np.float32)
        has_nap = self.serving.nap_stats is not None
        ops = [op for op in self.OPS if has_nap or op != "score_nap"]
        for op in ops:
            self._score(op, probe[:1])  # smallest bucket
            self._score(op, probe)      # largest bucket
        if self.serving.fusion_params is not None:
            rr = np.zeros((self.max_batch, 3, 32, 32), np.uint8)
            dd = np.zeros((self.max_batch, 1, 32, 32), np.uint8)
            tt = np.zeros((self.max_batch, 1), np.float32)
            mm = np.zeros((self.max_batch, 1, 13), np.float32)
            sensor = [op for op in self.SENSOR_OPS
                      if has_nap or op != "score_nap_sensor"]
            for op in sensor:
                for sl in (slice(0, 1), slice(None)):
                    self._score_sensor_op(op, rr[sl], dd[sl], tt[sl], mm[sl])
            ops = ops + sensor
        return ops

    def info(self) -> dict:
        """Server metadata (the `info` op's payload): input size,
        precision, guard measurement, batching stats, op list."""
        return {
            "input_size": self.input_size,
            "max_batch": self.max_batch,
            "compute_dtype": str(self.serving.compute_dtype).replace(
                "torch.", ""),
            "nap_quant": ("int8" if self.serving.nap_int8 is not None
                          else None),
            "has_nap_stats": self.serving.nap_stats is not None,
            "guard_rel_err": self.guard_rel,
            "batching": self.batching,
            "batch_stats": dict(self.batch_stats),
            "ops": (list(self.OPS)
                    + (list(self.SENSOR_OPS)
                       if self.serving.fusion_params is not None else [])
                    + ["info"]),
        }

    def _handle_sensor(self, op: str, head: dict,
                       payload: bytes) -> np.ndarray:
        """Parse + score one raw-sensor request (SENSOR_OPS wire format:
        header carries `sensor_shapes` = {r, d, t, m: [dims...]}, payload
        is the four arrays' bytes concatenated in that order — r/d uint8,
        t/m little-endian float32)."""
        if self.serving.fusion_params is None:
            raise ValueError(
                f"{op} needs a sensor='All' server (fusion frontend)")
        if op == "score_nap_sensor" and self.serving.nap_stats is None:
            raise ValueError(
                "score_nap_sensor needs the server started with NAP stats "
                "(--train_diffs)")
        shapes = head.get("sensor_shapes")
        if (not isinstance(shapes, dict)
                or set(shapes) != {"r", "d", "t", "m"}):
            raise ValueError(
                "sensor_shapes must be {r, d, t, m: [dims...]}, got "
                f"{shapes}")
        arrs, at = {}, 0
        n = None
        for name, dtype, ndim in self._SENSOR_FIELDS:
            shape = shapes[name]
            if (not isinstance(shape, list) or len(shape) != ndim
                    or any((not isinstance(s, int)) or s <= 0
                           for s in shape)):
                raise ValueError(
                    f"sensor_shapes[{name!r}] must be {ndim} positive "
                    f"dims, got {shape}")
            if n is None:
                n = shape[0]
            elif shape[0] != n:
                raise ValueError(
                    f"sensor_shapes[{name!r}] rows {shape[0]} != {n}")
            count = int(np.prod(shape))
            nbytes = count * np.dtype(dtype).itemsize
            if at + nbytes > len(payload):
                raise ValueError(
                    f"payload is {len(payload)} bytes, shorter than the "
                    f"sensor_shapes total")
            arrs[name] = np.frombuffer(
                payload, dtype, count=count, offset=at).reshape(shape)
            at += nbytes
        if at != len(payload):
            raise ValueError(
                f"payload is {len(payload)} bytes, expected {at} for "
                f"{shapes}")
        return self._score_sensor_op(op, arrs["r"], arrs["d"],
                                     arrs["t"], arrs["m"])

    # -- wire loop ----------------------------------------------------------

    def _handle(self, conn: socket.socket) -> None:
        with self._conns_lock:
            self._conns.add(conn)
        try:
            conn.settimeout(600.0)
            while not self._stopping.is_set():
                try:
                    head, payload = _recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                except Exception as e:  # noqa: BLE001 — malformed frame
                    # garbage length prefix / bad UTF-8 / invalid JSON:
                    # reply with the documented error frame so hand-rolled
                    # clients see WHY, then drop the connection — after a
                    # malformed frame the stream position can't be trusted
                    try:
                        _send_frame(conn, {
                            "ok": False,
                            "error": f"{type(e).__name__}: {e}"[:500],
                        })
                    except OSError:
                        pass
                    return
                try:
                    op = head.get("op")
                    if op == "info":
                        _send_frame(conn, {"ok": True, **self.info()})
                        continue
                    if op in self.SENSOR_OPS:
                        scores = self._handle_sensor(op, head, payload)
                        _send_frame(conn, {"ok": True,
                                           "shape": [len(scores)],
                                           "dtype": "float32"},
                                    scores.astype("<f4").tobytes())
                        continue
                    if op not in self.OPS:
                        raise ValueError(
                            f"unknown op {op!r}; have "
                            f"{list(self.OPS) + list(self.SENSOR_OPS) + ['info']}")
                    if op == "score_nap" and self.serving.nap_stats is None:
                        raise ValueError(
                            "score_nap needs the server started with NAP "
                            "stats (--train_diffs)")
                    shape = head.get("shape")
                    if (not isinstance(shape, list) or len(shape) != 2
                            or shape[1] != self.input_size):
                        raise ValueError(
                            f"shape must be [n, {self.input_size}], got "
                            f"{shape}")
                    n, d = int(shape[0]), int(shape[1])
                    if head.get("dtype", "float32") != "float32":
                        raise ValueError("payload dtype must be float32")
                    if len(payload) != n * d * 4:
                        raise ValueError(
                            f"payload is {len(payload)} bytes, expected "
                            f"{n * d * 4} for shape {shape}")
                    x = np.frombuffer(payload, "<f4").reshape(n, d)
                    scores = (self._score_batched(op, x) if self.batching
                              else self._score(op, x))
                    _send_frame(conn, {"ok": True, "shape": [n],
                                       "dtype": "float32"},
                                scores.astype("<f4").tobytes())
                except Exception as e:  # noqa: BLE001 — sent to the client
                    try:
                        _send_frame(conn, {
                            "ok": False,
                            "error": f"{type(e).__name__}: {e}"[:500],
                        })
                    except OSError:
                        return  # client gone before the error reply
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()

    def start(self, port: int = 0) -> int:
        """Bind and serve in a daemon thread; returns the bound port.
        Restartable: a stop()/start() sequence brings up a fresh accept
        loop and batcher."""
        self._stopping.clear()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, port))
        self._sock.listen(16)
        if self.batching and (self._batch_thread is None
                              or not self._batch_thread.is_alive()):
            # spawn only when no batcher is live: stop() keeps the reference
            # to a batcher that outlived its join timeout (a long scoring
            # call can outlast it), and _stopping.clear() above already
            # revived it — a second loop would race it for the queue
            self._batch_thread = threading.Thread(target=self._batch_loop,
                                                  daemon=True)
            self._batch_thread.start()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()
        return self._sock.getsockname()[1]

    def stop(self) -> None:
        self._stopping.set()
        with self._queue_cond:
            self._queue_cond.notify_all()
        if self._sock is not None:
            # shutdown wakes an accept() blocked in the accept thread (a
            # close alone does not on Linux, and stop() would wait out its
            # join bound)
            for close in (lambda: self._sock.shutdown(socket.SHUT_RDWR),
                          self._sock.close):
                try:
                    close()
                except OSError:
                    pass
        # close accepted client connections: handlers blocked in _recv_frame
        # (600 s timeout) exit on the resulting OSError instead of surviving
        # into — and being revived by — the next start() generation
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._batch_thread is not None:
            self._batch_thread.join(timeout=5.0)
            if not self._batch_thread.is_alive():
                # null only on a CONFIRMED exit: a batcher mid-call
                # outlives the join — keep the reference so its
                # waiters in _score_batched don't see "batcher not running"
                # for requests it will still complete, and so start() won't
                # spawn a rival loop next to the revived orphan
                self._batch_thread = None


class ScoreClient:
    """Blocking client for ScoreServer's frame protocol."""

    def __init__(self, addr: Tuple[str, int], timeout_s: float = 600.0):
        self._sock = socket.create_connection(addr, timeout=timeout_s)

    def info(self) -> dict:
        _send_frame(self._sock, {"op": "info"})
        head, _ = _recv_frame(self._sock)
        if not head.get("ok"):
            raise RuntimeError(head.get("error", "info failed"))
        return head

    def _send_sensor(self, r, d, t, m, op: str) -> None:
        r = np.ascontiguousarray(np.asarray(r, np.uint8))
        d = np.ascontiguousarray(np.asarray(d, np.uint8))
        t = np.ascontiguousarray(np.asarray(t, "<f4"))
        m = np.ascontiguousarray(np.asarray(m, "<f4"))
        if not (r.ndim == 4 and d.ndim == 4 and t.ndim == 2 and m.ndim == 3):
            raise ValueError(
                f"expected r(n,c,h,w) d(n,1,h,w) t(n,1) m(n,1,13); got "
                f"{r.shape} {d.shape} {t.shape} {m.shape}")
        shapes = {"r": list(r.shape), "d": list(d.shape),
                  "t": list(t.shape), "m": list(m.shape)}
        _send_frame(self._sock, {"op": op, "sensor_shapes": shapes},
                    r.tobytes() + d.tobytes() + t.tobytes() + m.tobytes())

    def score_sensor(self, r: np.ndarray, d: np.ndarray, t: np.ndarray,
                     m: np.ndarray,
                     op: str = "score_base_sensor") -> np.ndarray:
        """Score NATIVE sensor payloads server-side (SENSOR_OPS): uint8
        camera frames (n,3,H,W), uint8 depth frames (n,1,H,W), force in
        newtons (n,1) fp32, MFCC frames (n,1,13) fp32.  The server
        normalizes (fixed ranges; mic per-request min-max), fuses, and
        scores — the client needs no fusion convs and ships 4x fewer
        image bytes than fp32 fused windows."""
        self._send_sensor(r, d, t, m, op)
        return self._recv_scores()

    def _send_score(self, x: np.ndarray, op: str) -> None:
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2:
            raise ValueError(f"x must be (n, input_size), got {x.shape}")
        _send_frame(self._sock,
                    {"op": op, "shape": list(x.shape), "dtype": "float32"},
                    x.astype("<f4").tobytes())

    def _recv_scores(self) -> np.ndarray:
        head, payload = _recv_frame(self._sock)
        if not head.get("ok"):
            raise RuntimeError(head.get("error", "scoring failed"))
        return np.frombuffer(payload, "<f4").reshape(head["shape"])

    def score(self, x: np.ndarray, op: str = "score_base") -> np.ndarray:
        self._send_score(x, op)
        return self._recv_scores()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PipelinedScoreClient(ScoreClient):
    """ScoreClient with request pipelining on ONE connection — the
    network twin of `StreamingDetector.run(pipelined=True)`.

    The server's per-connection loop is strictly sequential
    (`_handle`: recv -> process -> send), so replies arrive in submission
    order and frames submitted early simply queue in the TCP buffer:
    `submit()` writes the request and returns immediately; `collect()`
    reads the OLDEST outstanding reply.  A robot host streaming window
    batches at a fixed tick rate submits tick i+1 before collecting tick
    i: the CLIENT->SERVER link round trip overlaps the server's
    processing of the queued request, so the stream rate is bounded by
    max(link RTT, server processing) instead of their sum
    (tests/test_torch_score_server.py pins the FIFO semantics and parity
    with the blocking client).

    Scope: the win needs a real network between client and server.  On
    loopback the only latency is the server's own work, which pipelining
    on one connection cannot overlap.  Use the plain ScoreClient for
    co-located callers; use this when the robot host is remote.

    Depth is the caller's to manage: keep it small (1-2 outstanding) —
    each outstanding request holds server-side buffer space, and scores
    arrive correspondingly late.  Errors are delivered by collect() for
    the request that failed, preserving order."""

    def __init__(self, addr: Tuple[str, int], timeout_s: float = 600.0):
        super().__init__(addr, timeout_s=timeout_s)
        self._outstanding = 0

    @property
    def outstanding(self) -> int:
        return self._outstanding

    def submit(self, x: np.ndarray, op: str = "score_base") -> None:
        """Send one scoring request without waiting for its reply."""
        self._send_score(x, op)
        self._outstanding += 1

    def submit_sensor(self, r, d, t, m,
                      op: str = "score_base_sensor") -> None:
        """Send one NATIVE-payload scoring request (score_sensor wire
        format — the remote robot host's streaming form: uint8 frames +
        newtons + MFCC per tick, next tick submitted before this tick's
        scores are collected)."""
        self._send_sensor(r, d, t, m, op)
        self._outstanding += 1

    def collect(self) -> np.ndarray:
        """Block for the oldest outstanding reply (FIFO; raises the
        server's error for that request if it failed).

        Accounting is tied to REPLY CONSUMPTION: a server-side error
        reply consumes one frame (outstanding decrements, then raises),
        but a transport failure inside the recv leaves the count
        untouched — decrementing eagerly would let a caller who catches
        a socket timeout retry collect() and mis-attribute request i's
        reply to request i+1 for the life of the connection."""
        if self._outstanding <= 0:
            raise RuntimeError("collect() with no outstanding request — "
                               "call submit() first")
        head, payload = _recv_frame(self._sock)  # transport errors
        # propagate with the count unchanged (no reply was consumed)
        self._outstanding -= 1
        if not head.get("ok"):
            raise RuntimeError(head.get("error", "scoring failed"))
        return np.frombuffer(payload, "<f4").reshape(head["shape"])
