// One eval-mode FC layer for Hopper (sm_90a), GEMM plus fused epilogue:
//
//     out[b, n] = bn( act( sum_k y[b, k] * W[n, k] + bias[n] ) )
//     act(v)    = v >= 0 ? v : 0.2 * v        (LeakyReLU), or identity
//     bn(v)     = (v - mean[n]) / std[n] * weight[n] + beta[n],  or identity
//
// with std = sqrt(running_var + eps) computed once by the caller's pack.
// Replaces the TPU kernel `_make_mlp_kernel` of
// icra2021_multimodal_ad_tpu/ops/pallas_kernels.py (reached through
// `fused_module_forward`).  The caller loops over a module's layers; every
// launch writes the layer's fp32 output, the RaPP tap.
//
// The tile product is the shared mainloop of csrc/sm90_gemm.cuh; this file
// adds only the epilogue and the launches.  Four variants, picked by the
// caller (ops/mlp_kernel.py) by type and batch:
//
//   0  fp32, 64 x 64 blocks on the CUDA cores      (small batches)
//   1  fp32, 128 x 128 blocks on the CUDA cores    (large batches)
//   2  bf16, 64 x 64 blocks on wgmma + TMA         (small batches)
//   3  bf16, 128 x 128 blocks on wgmma + TMA       (large batches)
//
// Design, and what differs from the TPU kernel:
//   * One launch per layer, not per module.  The TPU kernel keeps a whole
//     module's weights resident in VMEM; one fp32 canonical encoder is about
//     20 MB of weights, against 227 KB of shared memory per SM, so here the
//     weights stream from device memory (and L2) once per row tile.  The
//     grid runs the N tiles fastest, so the blocks in flight share one
//     slab of x and the weights stay in L2.
//   * fp32 sums K in two levels, each 32-deep stage in its own FMA chain in
//     k order, added once into the running total: the order of the
//     single-tile kernel this replaces, so the outputs are bit-identical to
//     it.  A single chain over K missed the golden NAP column by 2.886e-3
//     against its 2e-3 contract on the card; two levels carry about
//     TK + K/TK terms' worth of rounding instead of K.
//   * bf16 operands meet in the tensor cores with fp32 accumulation.  TMA
//     reads them from memory as they are, so the input must already be
//     bf16: the bf16 variants write two outputs, the fp32 tap and its bf16
//     rounding (round to nearest even, the rounding the old kernel applied
//     on load), which the next layer reads.  Both have row strides padded
//     to 16 bytes (the caller allocates them so).
//   * The BN epilogue is not folded into one affine as the TPU kernel folds
//     it.  On the golden model's degenerate NAP stats, whitening amplifies
//     rounding by ~2e6, so the epilogue repeats the plain version's
//     operations one by one, each correctly rounded (__fadd_rn and friends
//     keep the compiler from contracting them into FMAs).
//
// Bound on an H100 SXM (67 TFLOP/s fp32 on the CUDA cores, 989 TFLOP/s
// bf16 on the tensor cores, 3.35 TB/s):
//   * B = 7000, 1728 -> 1402: 2*B*K*N = 33.9 GFLOP, compute-bound at
//     ~0.51 ms in fp32 and ~0.034 ms in bf16.
//   * B = 10: reading W (9.7 MB fp32, 4.8 MB bf16) dominates, memory-bound
//     at ~2.9 us and ~1.5 us; with at most 22 blocks (64-wide N tiles) the
//     per-layer small-batch variants reach neither.
//
// Variant 4, fp32 at small batches (B <= SMALL_MAX_B): a whole eval-mode
// module in one launch, the TPU kernel's own fusion (`fused_mlp_module`).
//   * A persistent cooperative kernel: one block per SM, launched with
//     cudaLaunchCooperativeKernel (a refused launch returns its error),
//     and a grid sync between layers.  Each block owns groups of output
//     columns (rows of W) of each layer.
//   * A producer warp fills a ring of chunks (spc 32-deep stages of k) by
//     bulk copies (cp.async.bulk) on full/empty mbarriers: the group's
//     weight rows and the layer's B input rows, each once per chunk.  The
//     ring runs across layers: weights do not depend on the activations,
//     so layer l + 1's stream into the slots layer l frees while l
//     computes and syncs; only its input rows wait for the grid sync.
//   * Eleven consumer warps take work items sized to B (RT rows, the
//     fewest groups of at most 8 rows, so B = 10 is 2 x 5 with no slot
//     masked) of one column and one stage, consecutive threads on
//     consecutive columns; every 32-deep stage is its own fmaf chain in k
//     order from 0, the stage totals go to shared memory, and the thread
//     that owns an output adds them with __fadd_rn in stage order into its
//     running total: the same order as variants 0 and 1, so the same bits.
//     The epilogue is fc_apply.  Only intrinsics, so ptxas can neither
//     contract nor reassociate.
//   * Every layer's output (the RaPP tap) goes to one fp32 buffer, rows
//     padded to 16 bytes; the layer table (pointers, K, N, strides, leaky,
//     BN vectors) is built once by the caller's pack.
//   * Bound at B = 10: one fp32 canonical encoder's 20.4 MB of weights,
//     ~6.1 us at 3.35 TB/s.  Measured, device ms at B = 1 / 10 / 32: 0.034
//     / 0.046 / 0.083, against 0.057 / 0.074 / 0.142 for the design before
//     it (PERF.md §6).  What holds it there
//     (scripts/torch_small_kernel_probe.py, PERF.md §5): that design
//     started each layer's weights after the grid sync (a 1.6-5.9 us
//     prologue a layer) and spent up to 11.5 us a chunk at B = 32 in
//     shared-memory reads; here a layer after the first waits ~1-2 us for
//     its inputs from L2 after the sync, the first layer ~4.5 us for its
//     first chunk, a chunk costs ~0.5-0.7 us of adds and barriers beside
//     its items (each group's epilogue vectors are loaded at its first
//     chunk, off that path), and every block reads all B input rows of
//     each layer from L2, as many bytes again as the weights at B = 10.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstring>

#include "probe.cuh"
#include "sm90_gemm.cuh"

namespace {

constexpr float LEAKY_SLOPE = 0.2f;

using FcNarrow = sm90::SimtTile<4, 4, 4, true>;
using FcWide = sm90::SimtTile<8, 8, 4, true>;
using FcNarrow16 = sm90::WgmmaTile<1, 64, 4>;
using FcWide16 = sm90::WgmmaTile<2, 128, 4>;

struct FcOut {
  const float* bias;
  const float* bn_mean;  // all four BN vectors null for a layer without BN
  const float* bn_std;
  const float* bn_weight;
  const float* bn_beta;
  float* out;            // (M, N) fp32, row stride ldo
  __nv_bfloat16* out16;  // (M, N) bf16 copy, row stride ldo16, or null
  int ldo, ldo16, M, N, leaky;
};

// One output column's epilogue operands, loaded once for all its rows.
struct FcCol {
  float bias, mean, std, weight, beta;
};

__device__ __forceinline__ FcCol fc_col(const FcOut& p, int n) {
  FcCol c{__ldg(p.bias + n), 0.f, 1.f, 1.f, 0.f};
  if (p.bn_mean != nullptr) {
    c.mean = __ldg(p.bn_mean + n);
    c.std = __ldg(p.bn_std + n);
    c.weight = __ldg(p.bn_weight + n);
    c.beta = __ldg(p.bn_beta + n);
  }
  return c;
}

// bias, activation and unfolded BN, one correctly rounded operation at a
// time
__device__ __forceinline__ float fc_apply(const FcOut& p, const FcCol& c,
                                          float acc) {
  float v = __fadd_rn(acc, c.bias);
  if (p.leaky && !(v >= 0.f)) v = __fmul_rn(v, LEAKY_SLOPE);
  if (p.bn_mean != nullptr)
    v = __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(v, c.mean), c.std),
                            c.weight),
                  c.beta);
  return v;
}

// one block per SM lets ptxas give the wide tile all the registers it
// needs (without it, the wide NAP tile got 224 registers instead of 254 and
// ran ~10 % slower on the H100)
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
fc_simt_kernel(const float* __restrict__ x, int ldx,
               const float* __restrict__ w, int ldw, FcOut p, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  float acc[T::TM][T::TN];
  sm90::simt_gemm<T>(x, ldx, w, ldw, p.M, p.N, K, m0, n0,
                     reinterpret_cast<float*>(smem_raw), acc);
  const sm90::SimtCoord c = sm90::SimtCoord::of<T>(threadIdx.x);
#pragma unroll
  for (int q = 0; q < T::TN; ++q) {
    const int n = n0 + c.col<T>(q);
    if (n >= p.N) continue;
    const FcCol col = fc_col(p, n);
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int m = m0 + c.row<T>(i);
      if (m < p.M)
        p.out[static_cast<size_t>(m) * p.ldo + n] =
            fc_apply(p, col, acc[i][q]);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(T::THREADS)
fc_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w, FcOut p, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  float acc[T::ACC];
  if (!sm90::wgmma_gemm<T>(&map_x, &map_w, K, 0, m0, n0, smem_raw, acc))
    return;
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  // accumulators 4c .. 4c + 3 are columns n, n + 1 of two rows 8 apart:
  // each column's operands are loaded once, the outputs stored as pairs
#pragma unroll
  for (int r = 0; r < T::ACC; r += 4) {
    const int n = n0 + sm90::wgmma_col(r, t);
    if (n >= p.N) continue;
    const bool pair = n + 1 < p.N;
    const FcCol c0 = fc_col(p, n);
    const FcCol c1 = pair ? fc_col(p, n + 1) : c0;
#pragma unroll
    for (int h = 0; h < 4; h += 2) {
      const int m = m0 + 64 * wg + sm90::wgmma_row(r + h, t);
      if (m >= p.M) continue;
      const size_t o = static_cast<size_t>(m) * p.ldo + n;
      const size_t o16 = static_cast<size_t>(m) * p.ldo16 + n;
      const float v0 = fc_apply(p, c0, acc[r + h]);
      if (pair) {
        const float v1 = fc_apply(p, c1, acc[r + h + 1]);
        *reinterpret_cast<float2*>(p.out + o) = make_float2(v0, v1);
        if (p.out16 != nullptr)
          *reinterpret_cast<__nv_bfloat162*>(p.out16 + o16) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        p.out[o] = v0;
        if (p.out16 != nullptr) p.out16[o16] = __float2bfloat16_rn(v0);
      }
    }
  }
}

template <class T>
int launch_simt(const void* x, int ldx, const void* w, int ldw,
                const FcOut& p, int K, cudaStream_t stream) {
  static cudaError_t attr = sm90::allow_smem(fc_simt_kernel<T>,
                                             T::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + T::BM - 1) / T::BM);
  fc_simt_kernel<T><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      static_cast<const float*>(x), ldx, static_cast<const float*>(w), ldw,
      p, K);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_wgmma(const void* x, int ldx, const void* w, int ldw,
                 const FcOut& p, int K, cudaStream_t stream) {
  static cudaError_t attr = sm90::allow_smem(fc_wgmma_kernel<T>,
                                             T::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap map_x, map_w;
  if (!sm90::tma_map_bf16(&map_x, x, p.M, K, ldx, T::BM) ||
      !sm90::tma_map_bf16(&map_w, w, p.N, K, ldw, T::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + T::BM - 1) / T::BM);
  fc_wgmma_kernel<T><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      map_x, map_w, p, K);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// variant 4: a whole fp32 module at small batches, one cooperative launch
// ---------------------------------------------------------------------------

constexpr int FM_THREADS = 352;   // the consumers: 11 warps
constexpr int FM_BLOCK = FM_THREADS + 32;  // and one producer warp
constexpr int FM_CG = 16;          // columns per group, at most
constexpr int FM_MAX_B = 64;       // KERNEL_MAX_B of ops/mlp_kernel.py
constexpr int FM_MAX_LAYERS = 32;  // MODULE_MAX_LAYERS of ops/mlp_kernel.py
constexpr int FM_MAX_SPC = 32;     // 32-deep stages per chunk, at most
constexpr int FM_MAX_RING = 8;     // chunks in flight, at most
constexpr int FM_RING_TARGET = 4;  // the ring the chunk depth leaves room for
// outputs a thread adds
constexpr int FM_OWNED = (FM_CG * FM_MAX_B + FM_THREADS - 1) / FM_THREADS;

// One layer of the table; ops/mlp_kernel.py's _FmLayer mirrors it.
struct FmLayer {
  const float* w;  // (N, K), row stride ldw
  const float* bias;
  const float* bn_mean;  // all four null for a layer without BN
  const float* bn_std;
  const float* bn_weight;
  const float* bn_beta;
  long long out_offset;  // the output starts at out + B * out_offset
  int ldw, K, N, ldo, leaky, pad;
};

struct FmParams {
  const float* x;  // (B, K0), row stride ldx
  float* out;      // every layer's output, B * sum(ldo) floats
  int ldx, B, n_layers;
  int ring;        // chunks in flight
  int spc;         // 32-deep stages per chunk
  FmLayer layers[FM_MAX_LAYERS];
};

// a shared row of one chunk: 32 * spc floats and 4 more, so that rows
// start in different 16-byte bank groups (row / 4 is odd)
__host__ __device__ constexpr int fm_row(int spc) { return 32 * spc + 4; }
// one ring slot: B input rows and FM_CG weight rows of one chunk
__host__ __device__ constexpr int fm_slot_floats(int B, int spc) {
  return (B + FM_CG) * fm_row(spc);
}
__host__ __device__ constexpr int fm_partial_floats(int B, int spc) {
  return FM_CG * spc * B;
}
// the slots, the stage totals and three mbarriers a slot (weights in,
// inputs in, slot free)
__host__ __device__ constexpr int fm_smem_floats(int B, int spc, int ring) {
  return (ring * fm_slot_floats(B, spc) + fm_partial_floats(B, spc) + 1) /
             2 * 2 + 6 * ring;
}

// Where one block is in its sequence of chunks over the module's layers:
// layer l, and chunk `it` of the layer's mine * chunks (column group
// it / chunks of this block's, k chunk it % chunks).
struct FmCursor {
  int l, it;
};

// the consumer warps' barrier (the producer warp runs on its own)
__device__ __forceinline__ void fm_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FM_THREADS) : "memory");
}

// RT rows per work item: item (n, rg, s) is the 32-deep stage s of output
// column n for rows rg + G r (r < RT, G = ceil(B / RT)), each its own fmaf
// chain in k order from 0; consecutive threads take consecutive columns,
// then row groups, so a warp reads few stages.  The consumer warps
// compute; one producer warp fills the ring by bulk copies.
template <int RT>
__global__ void __launch_bounds__(FM_BLOCK, 1)
fc_module_kernel(const __grid_constant__ FmParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, B = p.B, spc = p.spc;
  const int row = fm_row(spc), kc = 32 * spc;
  const int slot = fm_slot_floats(B, spc);
  float* part_s = smem + p.ring * slot;  // (FM_CG, spc, B) stage totals
  // full_w[s]: slot s's weight rows landed; full_x[s]: its inputs;
  // empty[s]: the consumers are done with it
  uint64_t* full_w = reinterpret_cast<uint64_t*>(
      smem + fm_smem_floats(B, spc, p.ring) - 6 * p.ring);
  uint64_t* full_x = full_w + p.ring;
  uint64_t* empty = full_x + p.ring;
  const int G = (B + RT - 1) / RT;
  const int blocks = gridDim.x, block = blockIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  PROBE_DECL;
  PROBE_MARK(1, 0);
  if (tid == 0) {
    for (int i = 0; i < p.ring; ++i) {
      sm90::mbar_init(&full_w[i], 1);
      sm90::mbar_init(&full_x[i], 1);
      sm90::mbar_init(&empty[i], FM_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto cg_of = [&](int l) {
    return min(FM_CG, (p.layers[l].N + blocks - 1) / blocks);
  };
  auto chunks_of = [&](int l) { return (p.layers[l].K + kc - 1) / kc; };
  // the chunks this block runs in layer l
  auto chunks_in = [&](int l) {
    const int n_groups = (p.layers[l].N + cg_of(l) - 1) / cg_of(l);
    const int mine = block < n_groups ? (n_groups - 1 - block) / blocks + 1
                                      : 0;
    return mine * chunks_of(l);
  };
  auto step = [&](FmCursor c) {
    ++c.it;
    while (c.l < p.n_layers && c.it >= chunks_in(c.l)) {
      ++c.l;
      c.it = 0;
    }
    return c;
  };

  if (warp == FM_THREADS / 32) {
    // The producer: `rows` rows of chunk c (k from its k0 up to K rounded
    // up to 4 floats: what lies past K is never read) into `dst` by bulk
    // copies counted on `bar`.  Weight rows past N are not copied (their
    // outputs are never stored).
    auto copy_rows = [&](FmCursor c, float* dst, const float* src, int ld,
                         int rows, uint64_t* bar) {
      const int K = p.layers[c.l].K, k0 = (c.it % chunks_of(c.l)) * kc;
      const int bytes = 4 * min(kc, (K + 3) / 4 * 4 - k0);
      if (lane == 0) sm90::mbar_expect_tx(bar, bytes * rows);
      __syncwarp();
      for (int r = lane; r < rows; r += 32)
        sm90::bulk_load(dst + r * row, src + static_cast<size_t>(r) * ld + k0,
                        bytes, bar);
    };
    auto load_w = [&](FmCursor c, int i) {
      const FmLayer& L = p.layers[c.l];
      const int n0 = (block + (c.it / chunks_of(c.l)) * blocks) * cg_of(c.l);
      copy_rows(c, smem + (i % p.ring) * slot + B * row,
                L.w + static_cast<size_t>(n0) * L.ldw, L.ldw,
                min(cg_of(c.l), L.N - n0), &full_w[i % p.ring]);
    };
    auto load_x = [&](FmCursor c, int i) {
      const float* x = c.l == 0 ? p.x
                                : p.out + B * p.layers[c.l - 1].out_offset;
      copy_rows(c, smem + (i % p.ring) * slot, x,
                c.l == 0 ? p.ldx : p.layers[c.l - 1].ldo, B,
                &full_x[i % p.ring]);
    };
    // chunk i (a sequence number over the whole module) goes to slot
    // i % ring once chunk i - ring is consumed: its weights at once, so
    // they run ahead across layers, its inputs once their layer's grid
    // sync is past.  In layer l the consumers free the slots of chunks
    // before `end` (the chunks of layers up to l), so the weights run at
    // most to end + ring - 1 before the producer joins the next sync.
    FmCursor cw{0, -1};
    cw = step(cw);
    FmCursor cx = cw;
    int iw = 0, ix = 0, end = 0;
    for (int l = 0; l < p.n_layers; ++l) {
      if (l > 0) grid.sync();
      end += chunks_in(l);
      for (; ix < iw && cx.l <= l; cx = step(cx)) load_x(cx, ix++);
      for (; cw.l < p.n_layers && iw < end + p.ring; cw = step(cw), ++iw) {
        if (iw >= p.ring)
          sm90::mbar_wait(&empty[iw % p.ring], (iw / p.ring - 1) & 1);
        load_w(cw, iw);
        if (ix == iw && cx.l <= l) {
          load_x(cx, ix++);
          cx = step(cx);
        }
      }
    }
    return;
  }

  int done = 0;  // chunks consumed
  for (int l = 0; l < p.n_layers; ++l) {
    if (l > 0) {
      // the previous layer's outputs are visible to every block, and come
      // before the copy engine's reads of them, before any of its inputs
      // are copied; its weights are already in flight
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      PROBE_MARK(3, l - 1);
      grid.sync();
      PROBE_MARK(4, l - 1);
    }
    const FmLayer& L = p.layers[l];
    const FcOut fo{L.bias, L.bn_mean, L.bn_std, L.bn_weight, L.bn_beta,
                   p.out + B * L.out_offset, nullptr, L.ldo, 0, B, L.N,
                   L.leaky};
    const int cg = cg_of(l), chunks = chunks_of(l), nk = (L.K + 31) / 32;
    const int total = chunks_in(l);
    float tot[FM_OWNED];
    FcCol col[FM_OWNED];
#pragma unroll
    for (int i = 0; i < FM_OWNED; ++i) tot[i] = 0.f;
    for (int it = 0; it < total; ++it, ++done) {
      const int s_ = done % p.ring, parity = (done / p.ring) & 1;
      const int n0 = (block + (it / chunks) * blocks) * cg;
      if (it % chunks == 0) {
        // the group's epilogue vectors, in flight while its chunks run
#pragma unroll
        for (int i = 0; i < FM_OWNED; ++i) {
          const int o = tid + i * FM_THREADS;
          if (o < cg * B && n0 + o / B < L.N) col[i] = fc_col(fo, n0 + o / B);
        }
      }
      sm90::mbar_wait(&full_w[s_], parity);
      sm90::mbar_wait(&full_x[s_], parity);
      // also frees the stage totals read last
      fm_consumers_sync();
      PROBE_MARK(2, (l << 16) | it);
      const float* xs = smem + s_ * slot;
      const float* ws = xs + B * row;
      const int st0 = (it % chunks) * spc;  // the chunk's first stage
      const int n_st = min(spc, nk - st0);
      for (int w = tid; w < cg * G * n_st; w += FM_THREADS) {
        const int n = w % cg, rg = (w / cg) % G, s = w / (cg * G);
        const float* wr = ws + n * row + 32 * s;
        const float* xr = xs + 32 * s;
        // the stage's depth: 32, or what is left of K in the last one
        const int lim = min(32, L.K - 32 * (st0 + s));
        float part[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) part[r] = 0.f;
        if (lim == 32) {
#pragma unroll 2
          for (int kk = 0; kk < 32; kk += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(wr + kk);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              // rows past B read row B - 1 and are never stored
              const float4 a = *reinterpret_cast<const float4*>(
                  xr + min(rg + G * r, B - 1) * row + kk);
              part[r] = fmaf(a.x, wv.x, part[r]);
              part[r] = fmaf(a.y, wv.y, part[r]);
              part[r] = fmaf(a.z, wv.z, part[r]);
              part[r] = fmaf(a.w, wv.w, part[r]);
            }
          }
        } else {
          // the last stage, k by k up to K: past K lie stale floats
          // (skipping a zero term leaves the chain's bits as variant 0's
          // zero-filled copy)
          for (int kk = 0; kk < lim; ++kk) {
            const float wv = wr[kk];
#pragma unroll
            for (int r = 0; r < RT; ++r)
              part[r] = fmaf(xr[min(rg + G * r, B - 1) * row + kk], wv,
                             part[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
          if (rg + G * r < B) part_s[(n * spc + s) * B + rg + G * r] = part[r];
      }
      fm_consumers_sync();
      PROBE_MARK(6, it);
      // the slot is read: the producer may refill it
      if (lane == 0) sm90::mbar_arrive(&empty[s_]);
      // each output's owner adds the chunk's stage totals in stage order
      const bool last = it % chunks == chunks - 1;
#pragma unroll
      for (int i = 0; i < FM_OWNED; ++i) {
        const int o = tid + i * FM_THREADS;
        if (o < cg * B) {
          const int n = o / B, b = o % B;
          const float* ps = part_s + n * spc * B + b;
          // eight loads ahead of their adds; the adds stay in stage order
          for (int s0 = 0; s0 < n_st; s0 += 8) {
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              v[u] = s0 + u < n_st ? ps[(s0 + u) * B] : 0.f;
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (s0 + u < n_st) tot[i] = __fadd_rn(tot[i], v[u]);
          }
          if (last) {
            if (n0 + n < L.N)
              fo.out[static_cast<size_t>(b) * fo.ldo + n0 + n] =
                  fc_apply(fo, col[i], tot[i]);
            tot[i] = 0.f;
          }
        }
      }
      PROBE_MARK(7, it);
    }
  }
  PROBE_MARK(5, 0);
}

// The chunk depth and ring at B rows for a module whose deepest layer has
// nk 32-deep stages: chunks as deep as FM_RING_TARGET fit in shared memory
// beside the stage totals, then as many in flight as fit, FM_MAX_RING at
// most.  The ring runs across layers: the next layer's weights stream in
// while this one computes and syncs.
void fm_shape(int B, int nk, int smem_optin, int* spc, int* ring) {
  const int floats = smem_optin / 4;
  *spc = 1;
  while (*spc < std::min(FM_MAX_SPC, nk) &&
         fm_smem_floats(B, *spc + 1, FM_RING_TARGET) <= floats)
    ++*spc;
  *ring = FM_RING_TARGET;
  while (*ring < FM_MAX_RING && fm_smem_floats(B, *spc, *ring + 1) <= floats)
    ++*ring;
}
int fm_smem_bytes(int B, int spc, int ring) {
  return fm_smem_floats(B, spc, ring) * 4;
}
// rows of a work item: the fewest row groups of at most 8 rows, evenly
__host__ __device__ constexpr int fm_rt(int B) {
  return (B + (B + 7) / 8 - 1) / ((B + 7) / 8);
}

template <int RT>
cudaError_t module_launch(FmParams& p, const sm90::DeviceInfo& d,
                          cudaStream_t stream) {
  const int smem = fm_smem_bytes(p.B, p.spc, p.ring);
  static cudaError_t attr =
      sm90::allow_smem(fc_module_kernel<RT>, d.smem_optin);
  if (attr != cudaSuccess) return attr;
  int per_sm = 0;
  cudaError_t err = sm90::resident_blocks(fc_module_kernel<RT>, d.dev,
                                          FM_BLOCK, smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorCooperativeLaunchTooLarge;
  // one block per SM, even where more fit: a grid sync costs more with
  // more blocks (a sweep of the launch shape on the H100, PERF.md §6)
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fc_module_kernel<RT>), dim3(d.sms),
      dim3(FM_BLOCK), args, static_cast<size_t>(smem), stream);
}
}  // namespace

extern "C" {

// One layer in variant 0-3 (above).  x (B, K) and W (N, K) row-major with
// unit column stride, row strides ldx and ldw in elements, rows 16-byte
// aligned: fp32 for variants 0-1, bf16 for 2-3.  bias (N,) fp32; the four
// BN vectors (N,) fp32, all four null for a layer without BN; out (B, N)
// fp32 with row stride ldo; out16 (B, N) bf16 with row stride ldo16, written
// by variants 2-3 when not null.  `leaky` is 1 for LeakyReLU(0.2), 0 for
// identity.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for an unknown variant or a
// tensor map the driver refuses).
int fused_mlp(int variant, const void* x, int ldx, const void* w, int ldw,
              const float* bias, const float* bn_mean, const float* bn_std,
              const float* bn_weight, const float* bn_beta, float* out,
              int ldo, void* out16, int ldo16, int B, int K, int N,
              int leaky, void* stream) {
  const FcOut p{bias, bn_mean, bn_std, bn_weight, bn_beta, out,
                static_cast<__nv_bfloat16*>(out16), ldo, ldo16, B, N,
                leaky};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_simt<FcNarrow>(x, ldx, w, ldw, p, K, s);
    case 1: return launch_simt<FcWide>(x, ldx, w, ldw, p, K, s);
    case 2: return launch_wgmma<FcNarrow16>(x, ldx, w, ldw, p, K, s);
    case 3: return launch_wgmma<FcWide16>(x, ldx, w, ldw, p, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Every layer of one fp32 module in one launch (variant 4).  `table` holds
// n_layers FmLayer entries (above); x (B, K0) fp32 with row stride ldx; out
// holds every layer's output, layer l's (B, N_l) at out + B * out_offset
// with row stride ldo.  Row strides are multiples of 4 floats and rows
// 16-byte aligned; 1 <= B <= 64.  Launches on `stream`, does not
// synchronise, and returns the cooperative launch's error (or
// cudaErrorInvalidValue for arguments it does not take).
int fused_mlp_module(const void* table, int n_layers, const float* x,
                     int ldx, float* out, int B, void* stream) {
  if (B < 1 || B > FM_MAX_B || n_layers < 1 || n_layers > FM_MAX_LAYERS ||
      ldx % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FmParams p{};
  p.x = x;
  p.out = out;
  p.ldx = ldx;
  p.B = B;
  p.n_layers = n_layers;
  std::memcpy(p.layers, table, sizeof(FmLayer) * n_layers);
  for (int l = 0; l < n_layers; ++l)
    if (p.layers[l].ldw % 4 != 0 || p.layers[l].ldo % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  sm90::DeviceInfo d;
  cudaError_t err = sm90::device_info(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nk = 1;
  for (int l = 0; l < n_layers; ++l)
    nk = std::max(nk, (p.layers[l].K + 31) / 32);
  fm_shape(B, nk, d.smem_optin, &p.spc, &p.ring);
  if (fm_smem_bytes(B, p.spc, p.ring) > d.smem_optin)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fm_rt(B)) {
    case 1: return static_cast<int>(module_launch<1>(p, d, s));
    case 2: return static_cast<int>(module_launch<2>(p, d, s));
    case 3: return static_cast<int>(module_launch<3>(p, d, s));
    case 4: return static_cast<int>(module_launch<4>(p, d, s));
    case 5: return static_cast<int>(module_launch<5>(p, d, s));
    case 6: return static_cast<int>(module_launch<6>(p, d, s));
    case 7: return static_cast<int>(module_launch<7>(p, d, s));
    default: return static_cast<int>(module_launch<8>(p, d, s));
  }
}

// Bytes of one FmLayer entry, for the caller's check of its mirror.
int fused_mlp_module_entry_bytes() { return sizeof(FmLayer); }

// Dynamic shared memory one block of `fused_mlp_module` launches with at
// B rows and K <= 32 * nk on the current device; -1 on an error.
int fused_mlp_module_smem_bytes(int B, int nk) {
  sm90::DeviceInfo d;
  if (sm90::device_info(&d) != cudaSuccess) return -1;
  int spc = 0, ring = 0;
  fm_shape(B, nk, d.smem_optin, &spc, &ring);
  return fm_smem_bytes(B, spc, ring);
}

// Dynamic shared memory one block of `variant` launches with; 0 if unknown.
int fused_mlp_smem_bytes(int variant) {
  switch (variant) {
    case 0: return FcNarrow::SMEM_BYTES;
    case 1: return FcWide::SMEM_BYTES;
    case 2: return FcNarrow16::SMEM_BYTES;
    case 3: return FcWide16::SMEM_BYTES;
    default: return 0;
  }
}

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
