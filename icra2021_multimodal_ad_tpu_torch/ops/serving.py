"""Serving: BASE, SAP and NAP scores of fused windows, on one device or
sharded over a data mesh.

PyTorch counterpart of `icra2021_multimodal_ad_tpu/ops/serving.py`:

    serving = make_serving(cfg, model, nap_stats=stats,
                           fusion_params=fusion_init(cfg.seed))
    base = serving.score_fused(x)          # reconstruction error
    nap = serving.score_nap_windows(x)     # diffs + whitening (CUDA kernel)
    nap = serving.score_nap_sensor(r, d, t, m)   # native sensor payloads

fp32 bundles run the exact path: fp32 diff extraction and fp32 whitening.
bf16 bundles stream bf16 operands into fp32 accumulation, keep bias,
activation and BN in fp32, and floor the whitening variances at
NAP_VAR_FLOOR_REL_BF16.  Every module pass goes through the fused FC-module
kernel of `ops/mlp_kernel.py` and every NAP score through the kernel of
`ops/nap_kernel.py`; both kernels' operands are packed once, here.

`nap_quant="int8"` bundles whiten with an int8 product instead
(`NapInt8Pack`, `_nap_score_int8`): JAX runs that product on XLA, not in a
Pallas kernel, and the port runs it on the card's int8 GEMM
(`torch._int_mm`, cuBLASLt), with a bf16 tail of the noisiest columns.

The sensor-payload scorers fuse at the serving dtype: a bf16 bundle runs
the fusion convs on bf16 params and inputs (cuDNN), as JAX's does.  The
deploy guards hold a low-precision bundle's scores against fp32 on a probe
batch, both on the same variance floor, and raise above a tolerance.

With `mesh` (parallel/mesh.py), every rank receives the same request,
scores its padded shard of the rows through the kernels and all-gathers
the scores.  The sensor-payload scorers
normalize the whole request first (the mic's min-max is batch-global),
then shard.  JAX's mesh serving leaves the whitening product to XLA; the
port's shards run the same kernels as one device.

`ServingPrograms` is the counterpart of JAX's jitted scorers for the score
server: one CUDA graph per (op, bucket, payload shapes and dtypes), so a
served request is one replay over pinned staging (`utils/graphs.Program`).

The `export_*` functions serialize a bundle's scorers with `torch.export`:
plain torch ops with the weights, NAP stats and fusion projection baked in
as constants, loadable by torch alone (`load_scorer`).
"""

from __future__ import annotations

import copy
import functools
import io
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from icra2021_multimodal_ad_tpu_torch.models.autoencoder import (
    AePack,
    AutoEncoder,
    ae_pack,
    packed_forward,
)
from icra2021_multimodal_ad_tpu_torch.ops.fusion import (
    FusionParams,
    fuse,
    normalize_mods,
)
from icra2021_multimodal_ad_tpu_torch.ops.mlp_kernel import (
    fused_mlp_layer_plain_pair,
)
from icra2021_multimodal_ad_tpu_torch.ops.nap_kernel import (
    NapPack,
    nap_pack,
    nap_score,
    nap_score_plain,
)
from icra2021_multimodal_ad_tpu_torch.ops.rapp import diffs_batch
from icra2021_multimodal_ad_tpu_torch.ops.scoring import (
    NapStats,
    nap_effective_stats,
)
from icra2021_multimodal_ad_tpu_torch.parallel.mesh import Mesh, map_rows
from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils import graphs
from icra2021_multimodal_ad_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: default whitening-variance floor (relative to the max column variance)
#: for bf16 NAP serving: un-floored near-null directions amplify bf16
#: rounding into garbage scores (see ops/scoring.nap_effective_stats)
NAP_VAR_FLOOR_REL_BF16 = 1e-6


def cast_floats(model: AutoEncoder, dtype: torch.dtype) -> AutoEncoder:
    """A copy of `model` with every floating parameter (w, b, bn_scale,
    bn_bias) cast to `dtype`; the buffers, BN running stats included, stay
    as they are (fp32: tiny and accuracy-relevant)."""
    out = copy.deepcopy(model)
    for p in out.parameters():
        p.data = p.data.to(dtype)
    return out.eval()


def _row_sharded(method):
    """A scorer of row-independent inputs, sharded when the bundle has a
    mesh: every rank runs `method` on its shard of each input, on a copy
    of the bundle without the mesh, and the outputs are gathered in row order."""

    @functools.wraps(method)
    def scorer(self, *xs):
        if self.mesh is None:
            return method(self, *xs)
        xs = [self._input(x) for x in xs]
        local = self._replace(mesh=None)
        return map_rows(self.mesh, lambda *s: method(local, *s), *xs)

    return scorer


class ServingModel(NamedTuple):
    """A cast eval-mode model, fitted NAP stats, the cast fusion projection
    and both kernels' packs, all on one device, and the mesh its requests
    are sharded over (None: one device).  Build with make_serving."""

    model: AutoEncoder
    nap_stats: Optional[NapStats]
    compute_dtype: torch.dtype
    device: torch.device
    nap_pack: Optional[NapPack]
    ae_pack: AePack
    fusion_params: Optional[FusionParams] = None
    nap_int8: Optional["NapInt8Pack"] = None
    mesh: Optional[Mesh] = None

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _diffs(self, x):
        x = self._input(x).to(self.compute_dtype)
        return diffs_batch(self.model, x, self.ae_pack)

    @_row_sharded
    def score_fused(self, x) -> torch.Tensor:
        """BASE score (mean squared reconstruction error) of fused windows."""
        x = self._input(x).to(self.compute_dtype)
        x_hat = packed_forward(self.ae_pack, x)
        d = x_hat.float() - x.float()
        return (d * d).mean(dim=-1)

    @_row_sharded
    def score_nap(self, x_cat) -> torch.Tensor:
        """NAP score of concat diffs through the fused kernel; a bf16 bundle
        streams x and V as bf16, accumulation and scores stay fp32.  An
        int8 bundle quantizes the fp32 concat and whitens it with the int8
        product (`_nap_score_int8`)."""
        if self.nap_stats is None:
            raise ValueError("score_nap needs nap_stats")
        if self.nap_int8 is not None:
            return _nap_score_int8(self.nap_int8, self._input(x_cat))
        return nap_score(self.nap_pack, self._input(x_cat))

    @_row_sharded
    def nap_diffs(self, x) -> torch.Tensor:
        """Concat RaPP diffs of fused windows at the serving precision."""
        return torch.cat(self._diffs(x), dim=-1)

    def score_nap_windows(self, x) -> torch.Tensor:
        """Diff extraction + whitened score of fused windows."""
        return self.score_nap_windows_with_loss(x)[0]

    @_row_sharded
    def score_nap_windows_with_loss(self, x):
        """(NAP scores, per-window BASE MSE-sum) from one diff extraction:
        diffs[0] IS x_hat - x, so the loss costs no second forward.  The
        whitening goes through score_nap and so through the kernel."""
        if self.nap_stats is None:
            raise ValueError("score_nap_windows needs nap_stats")
        d = self._diffs(x)
        loss = (d[0].float() ** 2).sum(dim=-1)
        return self.score_nap(torch.cat(d, dim=-1)), loss

    @_row_sharded
    def score_sap_windows(self, x) -> torch.Tensor:
        """SAP score: mean square over the concat diffs of fused windows."""
        cat = torch.cat(self._diffs(x), dim=-1)
        return (cat * cat).mean(dim=-1)

    def _need_fusion(self, name: str) -> None:
        if self.fusion_params is None:
            raise ValueError(f"{name} needs fusion_params")

    def _fuse_raw(self, r, d, t, m) -> torch.Tensor:
        mods = {k: self._input(v).to(self.compute_dtype)
                for k, v in dict(r=r, d=d, t=t, m=m).items()}
        return fuse(self.fusion_params, sensor="All", **mods)

    def score_raw(self, r, d, t, m) -> torch.Tensor:
        """Fusion convs + AE forward + BASE score of modality tensors (the
        r/d/t/m keywords of ops/fusion.fuse), all at the serving dtype."""
        self._need_fusion("score_raw")
        return self._score_rows(ServingModel._fuse_raw, False, r, d, t, m)

    def score_nap_raw(self, r, d, t, m) -> torch.Tensor:
        """Modality tensors -> fusion convs -> RaPP diffs -> NAP score, all
        at the serving precision."""
        self._need_fusion("score_nap_raw")
        return self._score_rows(ServingModel._fuse_raw, True, r, d, t, m)

    def _normalized(self, name: str, r, d, t, m):
        """Native sensor payloads (uint8 camera and depth frames, force in
        newtons, fp32 MFCC frames) normalized on the device with the
        fixed-range realtime semantics (ops/fusion.normalize_mods), over
        the whole request."""
        self._need_fusion(name)
        return normalize_mods(*(self._input(v) for v in (r, d, t, m)))

    @_row_sharded
    def _fuse_normalized(self, rn, dn, tn, mn) -> torch.Tensor:
        c = self.compute_dtype
        return fuse(self.fusion_params, sensor="All", r=rn.to(c), d=dn.to(c),
                    t=tn.to(c), m=mn.to(c))

    def fuse_sensor(self, r, d, t, m) -> torch.Tensor:
        """Native sensor payloads normalized on the device, then fused at
        the serving dtype."""
        return self._fuse_normalized(
            *self._normalized("fuse_sensor", r, d, t, m))

    def score_sensor(self, r, d, t, m) -> torch.Tensor:
        """BASE score of native sensor payloads (fuse_sensor + score_fused)."""
        return self._score_rows(
            ServingModel._fuse_normalized, False,
            *self._normalized("score_sensor", r, d, t, m))

    def score_nap_sensor(self, r, d, t, m) -> torch.Tensor:
        """NAP score of native sensor payloads (fuse_sensor +
        score_nap_windows)."""
        return self._score_rows(
            ServingModel._fuse_normalized, True,
            *self._normalized("score_nap_sensor", r, d, t, m))

    def _score_rows(self, fuse_fn, nap: bool, *mods) -> torch.Tensor:
        """fuse_fn(bundle, *mods) -> windows, then their BASE or NAP score,
        sharded with the bundle: a rank fuses only its own rows."""

        @_row_sharded
        def score(sm, *mods):
            x = fuse_fn(sm, *mods)
            return sm.score_nap_windows(x) if nap else sm.score_fused(x)

        return score(self, *mods)


def make_serving(config, model: AutoEncoder,
                 nap_stats: Optional[NapStats] = None,
                 nap_var_floor_rel="auto", mesh=None, nap_quant="auto",
                 fusion_params=None, device="cuda") -> ServingModel:
    """Build the serving bundle on `device`; `config.compute_dtype`
    ('float32' | 'bfloat16') selects the operand dtype.

    `nap_var_floor_rel`: whitening-variance floor of the NAP scores.
    "auto" is NAP_VAR_FLOOR_REL_BF16 for bf16 or int8 NAP and no floor for
    fp32 (exact parity); a float overrides it, None or 0 disables it.

    `nap_quant`: 'int8' whitens with the int8 product (`NapInt8Pack`);
    diff extraction stays at the compute dtype.  "auto" reads
    config.nap_quant; None disables it.

    `fusion_params`: the fusion projection the sensor-payload scorers
    fuse with, cast to the compute dtype here.

    `mesh`: a data mesh (parallel/mesh.get_mesh); every scorer then shards
    its rows over the ranks, and the bundle lives on this rank's device."""
    if mesh is not None:
        device = mesh.device
    if nap_quant == "auto":
        nap_quant = getattr(config, "nap_quant", None)
    if nap_quant not in (None, "int8"):
        raise ValueError(f"unknown nap_quant: {nap_quant!r}")
    dev = resolve_device(device)
    dtype = _DTYPES[getattr(config, "compute_dtype", "float32")]
    if nap_var_floor_rel == "auto":
        # int8 needs the floor as bf16 does: near-null directions amplify
        # its rounding as well
        nap_var_floor_rel = (NAP_VAR_FLOOR_REL_BF16
                             if dtype == torch.bfloat16 or nap_quant
                             else None)
    pack = int8 = None
    if nap_stats is not None:
        nap_stats = nap_stats.to(dev)
        if nap_var_floor_rel:
            nap_stats = nap_effective_stats(nap_stats, nap_var_floor_rel)
        # packed once here: a request never re-casts or re-lays-out V
        if nap_quant == "int8":
            int8 = nap_int8_pack(nap_stats)
        else:
            pack = nap_pack(nap_stats, dtype)
    cast = cast_floats(model, dtype).to(dev)
    if fusion_params is not None:
        fusion_params = FusionParams(*({k: v.to(dev, dtype)
                                        for k, v in p.items()}
                                       for p in fusion_params))
    return ServingModel(model=cast, nap_stats=nap_stats, compute_dtype=dtype,
                        device=dev, nap_pack=pack,
                        ae_pack=ae_pack(cast, dtype),
                        fusion_params=fusion_params, nap_int8=int8,
                        mesh=mesh)


# ---------------------------------------------------------------------------
# One program per served request
# ---------------------------------------------------------------------------


def _score_sap_sensor(serving: ServingModel, r, d, t, m) -> torch.Tensor:
    return serving.score_sap_windows(serving.fuse_sensor(r, d, t, m))


#: the score server's ops: (the bundle's scorer, whether the op takes native
#: sensor payloads (r, d, t, m) rather than fused (B, input) windows)
SERVED_OPS = {"score_base": (ServingModel.score_fused, False),
              "score_sap": (ServingModel.score_sap_windows, False),
              "score_nap": (ServingModel.score_nap_windows, False),
              "score_base_sensor": (ServingModel.score_sensor, True),
              "score_sap_sensor": (_score_sap_sensor, True),
              "score_nap_sensor": (ServingModel.score_nap_sensor, True)}


class ServingPrograms:
    """A bundle's served ops as captured programs, the counterpart of JAX's
    jitted scorers (`icra2021_multimodal_ad_tpu/ops/serving.py`, one
    program per bucket): one `utils/graphs.Program` per (op, bucket,
    payload shapes and dtypes), captured at its first request, each
    request one replay.  A program runs the eager scorer's kernels in the
    same order on inputs of the same layout, so its scores are the eager
    ones bit for bit.

    Not thread-safe: the caller serializes requests (the score server's
    lock).  So the programs never run at once, and, their scores going to
    pinned host memory inside the graph, keep no device tensor alive
    between replays: they share one memory pool."""

    def __init__(self, serving: ServingModel):
        if serving.mesh is not None:
            raise ValueError(
                "ServingPrograms captures one device's programs; the "
                "programs of a bundle with a mesh (rows sharded through "
                "parallel/mesh.map_rows) wait for a caller that serves "
                "one: score it through the ServingModel's own methods")
        self.serving = serving
        self.programs: Dict[tuple, graphs.Program] = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if serving.device.type == "cuda" else None)

    def program(self, op: str, bucket: int,
                *payloads: np.ndarray) -> graphs.Program:
        """The program of `op` at `bucket` rows of the payloads' shapes and
        dtypes, captured now if it is new."""
        inputs = tuple(((bucket, *a.shape[1:]),
                        torch.from_numpy(np.empty(0, a.dtype)).dtype)
                       for a in payloads)
        key = (op, inputs)
        if key not in self.programs:
            fn = functools.partial(SERVED_OPS[op][0], self.serving)
            self.programs[key] = graphs.Program(
                fn, inputs, self.serving.device, pool=self._pool)
        return self.programs[key]

    def score(self, op: str, bucket: int, *payloads: np.ndarray) -> np.ndarray:
        """The (n,) fp32 scores of the n <= bucket rows of `payloads`, by
        one replay.  The rows go into the program's pinned staging and the
        pad rows up to `bucket` are written anew on every request: zeros
        for fused windows, copies of row 0 for sensor payloads (the mic's
        min-max spans the whole request, ops/fusion.normalize_mods, so a
        pad row must not widen it)."""
        program = self.program(op, bucket, *payloads)
        n = payloads[0].shape[0]
        for staged, rows in zip(program.staging(), payloads):
            staged[:n] = rows
            staged[n:] = rows[:1] if SERVED_OPS[op][1] else 0
        program.launch()
        program.wait()
        return program.output().numpy()[:n].copy()


# ---------------------------------------------------------------------------
# int8 NAP whitening
# ---------------------------------------------------------------------------


class NapInt8Pack(NamedTuple):
    """int8 whitening operands, built once by make_serving.

    The scheme is the JAX package's (its `NapInt8Pack`): static per-feature
    scales `sk` (the train diffs' per-feature abs-max, `NapStats.
    feat_absmax`, or 1 for stats saved without it) folded into V, V' =
    sk^T * V quantized per column (`sv`), dynamic per-row scales of the
    normalized x at score time (row abs-max / 127, no clipping), an exact
    int32 product and an fp32 epilogue.  The NAP_INT8_TAIL_FRAC columns
    with the largest sv * inv_std, where quantization noise is amplified
    most, are whitened in bf16 from the original V instead.

    The int8 block is padded for cuBLASLt's int8 GEMM, which takes K and
    the output width only in multiples of 8: `v8` has zero rows up to K8
    and zero columns up to a multiple of 8, where `sv` is 1 and `offset`
    and `inv_std` are 0.  Zeros add nothing to an int32 sum, so the padding
    is exact.  The int8 block is kept as its transpose `vt8`, so that `v8`
    is column-major, the layout of the GEMM's second operand."""

    vt8: torch.Tensor       # (J8p, K8) int8 of (sk^T * V)^T, int8-kept
    #                         columns
    sv: torch.Tensor        # (1, J8p) fp32 per-column scales of sk^T * V
    sk: torch.Tensor        # (1, K) fp32 static per-feature scales (or 1)
    offset: torch.Tensor    # (1, J8p) fp32 folded means rot_mu @ V + std_mu
    inv_std: torch.Tensor   # (1, J8p) fp32
    v16: Optional[torch.Tensor]        # (K, JT) bf16 tail columns of V
    offset16: Optional[torch.Tensor]   # (1, JT) fp32
    inv_std16: Optional[torch.Tensor]  # (1, JT) fp32
    k: int
    j: int                  # the whole whitened width J8 + JT, the mean's n

    @property
    def v8(self) -> torch.Tensor:
        """The (K8, J8p) int8 sk^T * V, a view of `vt8`."""
        return self.vt8.t()


#: the share of whitened directions the int8 path computes in bf16, by
#: descending sv * inv_std (JAX measured 5.6 % -> 1.3 % mean score error
#: for 1/8 on its bench fit)
NAP_INT8_TAIL_FRAC = 1 / 8
#: cuBLASLt's int8 GEMM takes more than 16 rows only: a score pads its
#: rows with zeros to at least this many
INT8_MIN_ROWS = 32


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def nap_precompute(stats: NapStats):
    """(offset, inv_std): the two means folded, rot_mu @ V + std_mu, and
    1 / std, 0 on floored (var = inf) columns."""
    offset = stats.rotater.mu.float() @ stats.rotater.v.float()
    return (offset + stats.standardizer.mu.float(),
            1.0 / torch.sqrt(stats.standardizer.var.float()))


def int8_tail_width(j: int, tail_frac: float = NAP_INT8_TAIL_FRAC) -> int:
    """The bf16 tail's column count: a multiple of 128 (at most J - 128)
    from J = 512, never J or more, 0 without a tail."""
    if not (tail_frac > 0 and j > 1):
        return 0
    jt = max(int(round(j * tail_frac)), 1)
    if j >= 512:
        jt = min(((jt + 127) // 128) * 128, j - 128)
    return min(jt, j - 1)


def nap_int8_pack(nap_stats: NapStats,
                  tail_frac: float = NAP_INT8_TAIL_FRAC) -> NapInt8Pack:
    """Quantize and lay out the whitening of `nap_stats` on its device."""
    offset, inv_std = nap_precompute(nap_stats)
    offset = offset.reshape(1, -1)
    inv_std = inv_std.reshape(1, -1)
    v_orig = nap_stats.rotater.v.float()
    k, j = v_orig.shape
    dev = v_orig.device
    am = nap_stats.feat_absmax
    if am is not None:
        sk = torch.where(am > 0, am, 1.0).float().reshape(1, -1)
        v = v_orig * sk.reshape(-1, 1)
    else:
        sk = torch.ones((1, k), device=dev)
        v = v_orig
    col_max = v.abs().amax(dim=0, keepdim=True)
    sv = torch.where(col_max > 0, col_max / 127.0, 1.0)

    jt = int8_tail_width(j, tail_frac)
    # the tail: the columns whose quantization step is amplified most; a
    # stable sort, as jnp.argsort, so ties send the same columns there
    order = (torch.argsort(-(sv[0] * inv_std[0]), stable=True) if jt
             else torch.arange(j, device=dev))
    tail_ix, main_ix = order[:jt], order[jt:]
    v8 = torch.round(v[:, main_ix] / sv[:, main_ix]).to(torch.int8)
    j8, j8p, k8 = j - jt, _ceil8(j - jt), _ceil8(k)
    vt8 = torch.zeros((j8p, k8), dtype=torch.int8, device=dev)
    vt8[:j8, :k] = v8.t()

    def padded(t: torch.Tensor, fill: float) -> torch.Tensor:
        return torch.cat([t[:, main_ix],
                          torch.full((1, j8p - j8), fill, device=dev)], 1)

    tail = (None, None, None) if not jt else (
        v_orig[:, tail_ix].to(torch.bfloat16), offset[:, tail_ix],
        inv_std[:, tail_ix])
    return NapInt8Pack(vt8, padded(sv, 1.0), sk, padded(offset, 0.0),
                       padded(inv_std, 0.0), *tail, k, j)


def int8_product(x8: torch.Tensor, v8: torch.Tensor) -> torch.Tensor:
    """(B, K) int8 x (K8, J8p) int8 -> (B, J8p) int32 through
    `torch._int_mm` (cuBLASLt's int8 GEMM on the card): x8's rows are
    padded with zeros to at least INT8_MIN_ROWS and its columns to K8, the
    same on the CPU, and the padded rows are sliced off.  `launches`
    counts the GEMMs run, not those traced into an exported artifact; a
    captured program's replays add theirs (`utils/graphs.py`)."""
    b, k = x8.shape
    x8 = torch.nn.functional.pad(
        x8, (0, v8.shape[0] - k, 0, max(b, INT8_MIN_ROWS) - b))
    if not torch.compiler.is_compiling():
        int8_product.launches += 1
    return torch._int_mm(x8, v8)[:b]


graphs.counted(int8_product, "launches")


def int8_product_plain(x8: torch.Tensor, v8: torch.Tensor) -> torch.Tensor:
    """The same product in float64, exact here (a sum of at most K8 terms
    of 127 * 127 stays far below 2**53), as int64."""
    return (x8.double() @ v8[: x8.shape[1]].double()).long()


def _bf16_product(x: torch.Tensor, v16: torch.Tensor) -> torch.Tensor:
    """bf16(x) @ v16 with fp32 accumulation: on the card one bf16 GEMM
    with an fp32 output; elsewhere (no such kernel) the bf16-rounded
    operands in an fp32 product, exact products and fp32 sums."""
    xb = x.to(torch.bfloat16)
    if x.device.type == "cuda":
        return torch.mm(xb, v16, out_dtype=torch.float32)
    return xb.float() @ v16.float()


def int8_quantize(pack: NapInt8Pack, x: torch.Tensor):
    """(x8, sx): x normalized by the static scales sk, then quantized per
    row with sx = row abs-max / 127 (round half to even, as jnp.round)."""
    y = x.float() / pack.sk
    row_max = y.abs().amax(dim=1, keepdim=True)
    sx = torch.where(row_max > 0, row_max / 127.0, 1.0)
    return torch.round(y / sx).to(torch.int8), sx


def _nap_score_int8(pack: NapInt8Pack, x: torch.Tensor,
                    product=int8_product) -> torch.Tensor:
    """NAP score of (B, K) concat diffs on an int8 pack -> (B,) fp32: x is
    quantized (`int8_quantize`) and multiplied in int8 with int32 sums; the
    epilogue (rescale, offset, standardize, square) and the bf16 tail are
    fp32.  The mean is over all J directions.  `product` is `int8_product`
    or its plain version."""
    x = x.float()
    x8, sx = int8_quantize(pack, x)
    rot = product(x8, pack.v8).float() * sx * pack.sv
    t = (rot - pack.offset) * pack.inv_std
    acc = (t * t).sum(dim=-1)
    if pack.v16 is not None:
        t16 = (_bf16_product(x, pack.v16) - pack.offset16) * pack.inv_std16
        acc = acc + (t16 * t16).sum(dim=-1)
    return acc / pack.j


def nap_score_int8_plain(pack: NapInt8Pack, x: torch.Tensor) -> torch.Tensor:
    """`_nap_score_int8` with the int8 product taken in float64."""
    return _nap_score_int8(pack, x, product=int8_product_plain)


# ---------------------------------------------------------------------------
# Deploy guards
# ---------------------------------------------------------------------------


def _rel_err(fast: torch.Tensor, exact: torch.Tensor) -> float:
    """Mean relative score error of a low-precision path against fp32."""
    s16, s32 = fast.cpu().numpy(), exact.cpu().numpy()
    return float(np.mean(np.abs(s16 - s32) / (np.abs(s32) + 1e-6)))


def bf16_accuracy_guard(config, model: AutoEncoder, x, tol: float = 5e-2,
                        device="cuda") -> float:
    """Mean relative BASE-score error of the bf16 serving path against fp32
    on a probe batch of fused windows; raises above `tol`."""
    fp32 = make_serving(config.replace(compute_dtype="float32"), model,
                        nap_quant=None, device=device)
    bf16 = make_serving(config.replace(compute_dtype="bfloat16"), model,
                        nap_quant=None, device=device)
    rel = _rel_err(bf16.score_fused(x), fp32.score_fused(x))
    if rel > tol:
        raise ValueError(f"bf16 serving rel err {rel:.4f} > tol {tol}")
    return rel


def _low_precision_kind(serving: ServingModel) -> Optional[str]:
    """"int8", "bf16" or None: the NAP path a bundle scores with."""
    if serving.nap_int8 is not None:
        return "int8"
    return "bf16" if serving.compute_dtype == torch.bfloat16 else None


def nap_accuracy_guard(config, model: AutoEncoder, nap_stats: NapStats, x,
                       tol: float = 5e-2,
                       nap_var_floor_rel=NAP_VAR_FLOOR_REL_BF16,
                       nap_quant="auto",
                       fast_serving: Optional[ServingModel] = None,
                       return_scores: bool = False, device="cuda"):
    """Mean relative NAP-score error of the low-precision serving path
    (bf16 diff extraction and whitening, or with nap_quant='int8' the int8
    whitening) against fp32 on a probe batch of fused windows; raises above
    `tol`.

    Both bundles take the SAME variance floor, so the guard measures the
    precision error alone.  `nap_quant` follows make_serving: "auto" reads
    config.nap_quant, so the guard certifies the path the config deploys.
    `fast_serving`: the bundle to certify, the one the caller scores with,
    instead of a fresh bf16 one; it must be the low-precision path that
    `nap_quant` names, on that floor (make_serving's "auto" default), and
    its device is the guard's.  `return_scores=True` returns (rel, its
    scores as numpy), so the caller reuses the certified scores."""
    if nap_quant == "auto":
        nap_quant = getattr(config, "nap_quant", None)
    if nap_quant not in (None, "int8"):
        raise ValueError(f"unknown nap_quant: {nap_quant!r}")
    if fast_serving is not None:
        # the bundle must BE the path nap_quant names, or the guard
        # certifies a path it never measured
        fast_kind = _low_precision_kind(fast_serving)
        want_kind = "int8" if nap_quant == "int8" else (
            "bf16" if fast_serving.compute_dtype == torch.bfloat16 else None)
        if fast_kind is None:
            raise ValueError("fast_serving has no low-precision path to "
                             "guard (fp32 compute_dtype, no nap_quant)")
        if fast_kind != want_kind:
            raise ValueError(
                f"fast_serving is the {fast_kind} path but the resolved "
                f"nap_quant asks the guard to certify {want_kind or 'bf16'}"
                " — build the bundle and the guard from the same config")
        device = fast_serving.device
    fp32 = make_serving(config.replace(compute_dtype="float32"), model,
                        nap_stats=nap_stats,
                        nap_var_floor_rel=nap_var_floor_rel, nap_quant=None,
                        device=device)
    fast = fast_serving if fast_serving is not None else make_serving(
        config.replace(compute_dtype="bfloat16"), model, nap_stats=nap_stats,
        nap_var_floor_rel=nap_var_floor_rel, nap_quant=nap_quant,
        device=device)
    s16 = fast.score_nap_windows(x)
    rel = _rel_err(s16, fp32.score_nap_windows(x))
    if rel > tol:
        kind = "int8" if nap_quant == "int8" else "bf16"
        raise ValueError(f"{kind} NAP serving rel err {rel:.4f} > tol {tol}")
    return (rel, s16.cpu().numpy()) if return_scores else rel


def run_precision_guard(config, model: AutoEncoder,
                        nap_stats: Optional[NapStats], probe, tol: float,
                        serving: Optional[ServingModel] = None,
                        device="cuda") -> Optional[float]:
    """The accuracy guard that matches a serving bundle's precision: int8
    or bf16 NAP when NAP stats exist and a low-precision path is on, bf16
    BASE otherwise, and None for an exact fp32 bundle (nothing to guard).
    One definition for every deployment surface: serve, export and
    ScoreServer.serve_guard.  Returns the measured mean relative score
    error."""
    if serving is None:
        serving = make_serving(config, model, nap_stats=nap_stats,
                               device=device)
    if nap_stats is not None and _low_precision_kind(serving):
        return float(nap_accuracy_guard(config, model, nap_stats, probe,
                                        tol=tol, fast_serving=serving))
    if serving.compute_dtype == torch.bfloat16:
        return float(bf16_accuracy_guard(config, model, probe, tol=tol,
                                         device=serving.device))
    return None


# ---------------------------------------------------------------------------
# Serialized scorers (torch.export)
# ---------------------------------------------------------------------------
# An artifact is plain torch ops, not the hand-written kernels, which load
# through ctypes and would need this package: as JAX ships XLA's form and
# not Pallas.  Each op is the kernel's plain version, which computes what
# the live kernel path computes (the same taps, the same unfolded NAP, the
# same bf16 halves), so an artifact carries the precision its bundle's
# accuracy guard certified.


def _base_plain(serving: ServingModel, x: torch.Tensor) -> torch.Tensor:
    """`score_fused`: against the dtype-rounded input, as the live path."""
    xc = x.to(serving.compute_dtype)
    d = (packed_forward(serving.ae_pack, xc, fused_mlp_layer_plain_pair)
         .float() - xc.float())
    return (d * d).mean(dim=-1)


def _nap_of_cat(serving: ServingModel, cat: torch.Tensor) -> torch.Tensor:
    """`score_nap`: int8 whitening, or the NAP kernel's plain version."""
    if serving.nap_int8 is not None:
        return _nap_score_int8(serving.nap_int8, cat)
    return nap_score_plain(serving.nap_pack, cat)


def _nap_from_fused(serving: ServingModel):
    """Closure: fused (B, input) windows -> NAP score at the bundle's
    precision (`score_nap_windows`); one definition for the window and the
    sensor artifacts."""
    if serving.nap_stats is None:
        raise ValueError("NAP export needs nap_stats")

    def fn(x):
        d = diffs_batch(serving.model, x.to(serving.compute_dtype),
                        serving.ae_pack, fused_mlp_layer_plain_pair)
        return _nap_of_cat(serving, torch.cat(d, dim=-1))

    return fn


def _own_storage(tree):
    """A copy of the packs' tensors, each in a storage of its own size:
    the kernels' operands are row-padded views, and an exported constant
    must not be a view into a larger buffer.  Dense tensors keep their
    strides (int8 `v8` stays column-major); modules and other leaves are
    kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _own_storage(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_own_storage(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


class _Scorer(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args, path: Optional[str]) -> bytes:
    """`torch.export` `fn` at the static shapes of `args` and serialize it;
    the tensors it reads become the artifact's constants."""
    with torch.no_grad():
        program = torch.export.export(_Scorer(fn), args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def _window_arg(serving: ServingModel, batch_size: int, width: int):
    return (torch.zeros((batch_size, width), dtype=torch.float32,
                        device=serving.device),)


def export_base_scorer(serving: ServingModel, batch_size: int,
                       input_size: int, path: Optional[str] = None) -> bytes:
    """Serialize the BASE scorer of fused (batch_size, input_size) fp32
    windows, weights baked in; loadable without this package."""
    serving = _own_storage(serving)
    return _export(lambda x: _base_plain(serving, x),
                   _window_arg(serving, batch_size, input_size), path)


def export_nap_scorer(serving: ServingModel, batch_size: int,
                      cat_size: int, path: Optional[str] = None) -> bytes:
    """Serialize the NAP score of (batch_size, cat_size) concat diffs at the
    bundle's precision (int8 whitening, bf16 halves or exact fp32), the
    whitening stats baked in."""
    if serving.nap_stats is None:
        raise ValueError("export_nap_scorer needs nap_stats")
    serving = _own_storage(serving)
    return _export(lambda x: _nap_of_cat(serving, x),
                   _window_arg(serving, batch_size, cat_size), path)


def export_nap_window_scorer(serving: ServingModel, batch_size: int,
                             input_size: int,
                             path: Optional[str] = None) -> bytes:
    """Serialize the whole streaming NAP path, fused windows -> RaPP diffs
    -> whitened score, with the weights and the whitening stats baked in:
    the deployable form of score_nap_windows."""
    serving = _own_storage(serving)
    return _export(_nap_from_fused(serving),
                   _window_arg(serving, batch_size, input_size), path)


def export_sensor_scorer(serving: ServingModel, batch_size: int,
                         op: str = "base", h: int = 32, w: int = 32,
                         path: Optional[str] = None) -> bytes:
    """Serialize the ingestion-native scorer: (B, 3, h, w) uint8 camera and
    (B, 1, h, w) uint8 depth frames, (B, 1) force in newtons and (B, 1, 13)
    fp32 MFCC frames -> the fixed-range normalization
    (ops/fusion.normalize_mods) -> fusion convs -> the BASE score
    (op="base") or on through the RaPP diffs to the NAP score (op="nap"),
    at the bundle's precision, the fusion projection baked in."""
    if serving.fusion_params is None:
        raise ValueError("export_sensor_scorer needs fusion_params "
                         "(a sensor='All' bundle)")
    if op not in ("base", "nap"):
        raise ValueError(f"op must be 'base' or 'nap', got {op!r}")
    serving = _own_storage(serving)
    nap_fn = _nap_from_fused(serving) if op == "nap" else None
    c = serving.compute_dtype

    def fn(r, d, t, m):
        rn, dn, tn, mn = normalize_mods(r, d, t, m)
        x = fuse(serving.fusion_params, sensor="All", r=rn.to(c),
                 d=dn.to(c), t=tn.to(c), m=mn.to(c))
        return nap_fn(x) if nap_fn is not None else _base_plain(serving, x)

    dev = serving.device
    args = (torch.zeros((batch_size, 3, h, w), dtype=torch.uint8,
                        device=dev),
            torch.zeros((batch_size, 1, h, w), dtype=torch.uint8,
                        device=dev),
            torch.zeros((batch_size, 1), dtype=torch.float32, device=dev),
            torch.zeros((batch_size, 1, 13), dtype=torch.float32,
                        device=dev))
    return _export(fn, args, path)


def load_scorer(blob_or_path):
    """Deserialize an exported scorer; returns a callable on tensors on the
    device it was exported on -> scores.  An artifact carries no backend
    flags, and cuDNN's convolutions default to TF32: the callable runs
    under the flags this module set on import (`utils/fp32.py`, TF32 off in
    cuBLAS and cuDNN), as the port's fp32 path does."""
    if isinstance(blob_or_path, (str, os.PathLike)):
        with open(blob_or_path, "rb") as f:
            blob_or_path = f.read()
    module = torch.export.load(io.BytesIO(blob_or_path)).module()

    def scorer(*args):
        with torch.no_grad():
            return module(*args)

    return scorer
