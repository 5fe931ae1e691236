// Fused NAP score for Hopper (sm_90a):
//
//     score_b = (1/J) * sum_j ( ((x_b - mu) @ V)_j - std_mu_j )^2 * inv_std_j^2
//
// Replaces the TPU kernel `_nap_kernel` of
// icra2021_multimodal_ad_tpu/ops/pallas_kernels.py (reached through
// `nap_score_pallas`).  Like that kernel, the (B, J) rotated matrix never
// reaches device memory: each block keeps its product tile in registers,
// applies the standardize-square epilogue there, and writes one partial row
// sum per (J tile, row).
//
// The tile product is the shared mainloop of csrc/sm90_gemm.cuh, with the
// rotation packed as V^T (J, K), K-major like the FC weights; this file adds
// the centering pass, the epilogue and the launches.  Four variants, picked
// by the caller (ops/nap_kernel.py) by type and batch:
//
//   0  fp32, 64 x 64 blocks on the CUDA cores      (small batches)
//   1  fp32, 128 x 128 blocks on the CUDA cores    (large batches)
//   2  bf16, 64 x 64 blocks on wgmma + TMA         (small batches)
//   3  bf16, 128 x 256 blocks on wgmma + TMA       (large batches)
//
// Design, and what differs from the TPU kernel:
//   * Unfolded form.  The TPU kernel folds the rotation mean into one offset
//     (x @ V - (mu @ V + std_mu)).  With degenerate whitening stats (the
//     golden fit's smallest variance is 2.2e-13, so whitening amplifies
//     rounding by ~2e6) the fold cancels two large products and missed the
//     golden column by 1.855e-3 against its 2e-3 contract.  Here a first
//     pass writes the centred rows into a scratch with 16-byte row strides,
//     which the tile product reads; std_mu is subtracted after the product.
//     fp32: xc = x - mu, one fp32 subtraction per element.  bf16: the
//     arithmetic of the bf16 path before the tensor cores, bf16(x) - mu in
//     fp32, split into two bf16 halves hi = bf16(xc) and lo = bf16(xc - hi)
//     (xc to 16 bits), side by side in one operand (lo from the first
//     64-aligned column at or past K, zeros between); each stage loads one
//     V^T box and both halves' boxes and sums hi @ V + lo @ V into the same
//     accumulators.
//     Rounding x - mu once to bf16 instead is 3x closer to fp32 on the
//     serving test's fit but leaves JAX's bf16 scorer (bf16(x), folded) by
//     a mean relative 1.7e-2, where the port's contract is 1e-2.
//   * fp32 sums K in two levels: each 32-deep stage is its own FMA chain
//     in k order from 0, and the stage totals are added with __fadd_rn to
//     the running total in stage order, the order of csrc/fused_mlp.cu.
//     scripts/golden_summation_study.py replays the orders exactly on the
//     golden fixture (with the FC kernel's two-level diffs): one chain
//     over K 1.009e-3, two levels 3.625e-4, against the 2e-3 contract; the
//     card measured 5.435e-4 (PERF.md §6).  Two levels also let variant 4
//     spread one output's K over threads and blocks.  The tensor cores
//     sum bf16 products in fp32, twice the product's operations (hi and
//     lo) against each V^T box.
//   * The TPU kernel carries the row sum across J tiles in a revisited output
//     block, which relies on its grid running in order.  Hopper's blocks run
//     in no order, so the partial sums go to an (n_tiles, B) scratch and a
//     last small kernel adds them in a fixed order and divides by J: the
//     result is deterministic, with no atomics.
//
// Variant 4, fp32 at small batches (B <= SMALL_MAX_B), one cooperative
// launch in place of the three launches above, bit-equal to variant 0, in
// one of two schedules picked from (B, J) and the SMs (ns_even):
//   * The even schedule (nap_small_kernel_even), at B <= 16 where J has
//     32-column tiles for half the grid or more (J >= ~2100 on 132 SMs):
//     block g holds the contiguous columns [g J / 132, (g + 1) J / 132)
//     (41 or 42 at J = 5482, where whole tiles gave 40 of 132 blocks a
//     second 701 KB tile while 92 idled) and streams their V^T rows over
//     all of K, one round.  A producer warp fills a ring of two chunks (8
//     stages of 32) by tensor copies, a stage's box of the block's V^T rows
//     in the 128-byte swizzle; the consumers centre the chunk's columns of
//     x themselves (loaded a chunk ahead), so no grid sync precedes the
//     stream.  Eight consumer warps take items of R rows x 8 C columns x
//     one stage (R = 5, C = 6 at B = 10: 30 outputs a lane for 11 float4
//     reads a 4-deep step, where whole tiles read 12 a 128 FMAs), each
//     output an fmaf chain of 32 in k order from 0, and store the stage
//     totals in shared memory; after the consumers' barrier each output's
//     owner adds the chunk's in stage order to a running total it keeps in
//     a register, and after the block's last chunk stores its t.
//   * The tile kernel (nap_small_kernel) elsewhere: a work unit is a
//     32-column tile and a slice of K's stages.  Where J has tiles for half
//     the grid one slice covers K; else K splits into as many slices as
//     fill the grid (J = 400: 13 tiles x 10 slices of 18 stages), the
//     stage totals go to the scratch, and after a grid sync a warp per
//     (row, tile) adds all of K's from stage 0 in order.  First the grid
//     centres x once into the scratch and syncs; eight consumer warps take
//     items of RT rows x 4 columns x one stage from a ring that a producer
//     warp fills by bulk copies.
//   * The row sums keep variant 0's order: the tile's t^2 with nap_term's
//     arithmetic (lane tx adds columns tx + 8 q in q order, then the xor
//     butterfly over 8 lanes), a grid sync, then one thread per row adds
//     the tile partials in tile order and divides by J.  No atomics, so
//     the scores are bit-equal to variant 0, floored columns included.
//   * Device ms at B = 1 / 10 / 32 (K = 5482, the L2 flushed by a 128 MB
//     write before each call; PERF.md §6): J = 400 0.020 / 0.023 / 0.032
//     (the tile kernel; bytes bound 0.0027); J = 4096 0.049 / 0.058 /
//     0.105 (bound 0.027; whole tiles 0.059 / 0.069 / 0.106); J = 5482
//     0.060 / 0.065 / 0.195 (bound 0.036; whole tiles 0.095 / 0.126 /
//     0.195).  Under that flush the even schedule streams V^T about as
//     fast as plain loads of the same rows do (~2.2 TB/s; 2.4 us a chunk
//     at B = 10); in the robot's traced tick it takes 0.053 ms.  At B = 32
//     its items' shared-memory reads outlast the bytes (J = 4096: 0.125
//     ms), hence the tile kernel past B = 16.
//   * The grid is what the occupancy query allows at the kernel's shared
//     memory (cudaLaunchCooperativeKernel guarantees co-residency); a
//     refused launch returns its error, there is no fallback.

// Bound on an H100 SXM (the operations at the 67 TFLOP/s fp32 non-tensor
// rate or 989 TFLOP/s bf16; the bytes at 3.35 TB/s):
//   * B = 4096, K = 5482, J = 4096: 2*B*K*J = 184 GFLOP, compute-bound at
//     ~2.7 ms in fp32 and ~0.19 ms in bf16 (the hi/lo split doubles the
//     tensor-core work, ~0.37 ms).
//   * B = 10: reading V dominates, memory-bound: at J = 4096 90 MB fp32
//     (45 MB bf16), ~27 us (~13 us); at the robot's tick, K = J = 5482,
//     120.2 MB fp32, past the 50 MB L2, ~36 us (60.1 MB bf16, ~18 us).

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "probe.cuh"
#include "sm90_gemm.cuh"

namespace {

using NapNarrow = sm90::SimtTile<4, 4, 4, true>;
using NapWide = sm90::SimtTile<8, 8, 4, true>;
using NapNarrow16 = sm90::WgmmaTile<1, 64, 4, 2>;
using NapWide16 = sm90::WgmmaTile<2, 256, 3, 2>;

struct NapOut {
  const float* std_mu;
  const float* inv_std;
  float* partial;  // (n_tiles, M) row sums of t^2 over one J tile each
  int M, N;
};

// ((acc - std_mu) * inv_std)^2 of column n added to s
__device__ __forceinline__ float nap_term(const NapOut& p, float acc, int n,
                                          float s) {
  const float t = __fmul_rn(__fsub_rn(acc, __ldg(p.std_mu + n)),
                            __ldg(p.inv_std + n));
  return fmaf(t, t, s);
}

// Where the lo half of a bf16 centred row starts: the first multiple of
// the 64-column TMA box at or past K, so that every box starts aligned.
__host__ __device__ constexpr int lo_column(int K) { return (K + 63) / 64 * 64; }

// fp32: xc[b, k] = x[b, k] - mu[k].  bf16: c = bf16(x[b, k]) - mu[k] in
// fp32, xc[b, k] = hi = bf16(c) and xc[b, lo_column(K) + k] = bf16(c - hi),
// with zeros between K and lo_column(K).  Grid (k blocks, rows).
template <typename T>
__global__ void nap_center_kernel(const float* __restrict__ x, int ldx,
                                  const float* __restrict__ mu,
                                  T* __restrict__ xc, int ldxc, int B,
                                  int K) {
  const int lo = lo_column(K);
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    T* row = xc + static_cast<size_t>(b) * ldxc;
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < lo;
         k += gridDim.x * blockDim.x) {
      if constexpr (std::is_same<T, float>::value) {
        if (k < K)
          row[k] = __fsub_rn(x[static_cast<size_t>(b) * ldx + k],
                             __ldg(mu + k));
      } else if (k < K) {
        const float v = x[static_cast<size_t>(b) * ldx + k];
        const float c = __fsub_rn(__bfloat162float(__float2bfloat16_rn(v)),
                                  __ldg(mu + k));
        const __nv_bfloat16 hi = __float2bfloat16_rn(c);
        row[k] = hi;
        row[lo + k] = __float2bfloat16_rn(__fsub_rn(c, __bfloat162float(hi)));
      } else {
        row[k] = __float2bfloat16_rn(0.f);
      }
    }
  }
}

// one block per SM: see fc_simt_kernel in csrc/fused_mlp.cu
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
nap_simt_kernel(const float* __restrict__ xc, int ldx,
                const float* __restrict__ vt, int ldv, NapOut p, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  float acc[T::TM][T::TN];
  sm90::simt_gemm<T>(xc, ldx, vt, ldv, p.M, p.N, K, m0, n0,
                     reinterpret_cast<float*>(smem_raw), acc);
  const sm90::SimtCoord c = sm90::SimtCoord::of<T>(threadIdx.x);
  // one partial per (warp's J tile, row); a warp wholly past J writes none
  const int tile = blockIdx.x * T::WN + c.warp_n;
  if (tile * T::WARP_N >= p.N) return;
  float s[T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int q = 0; q < T::TN; ++q) {
      const int n = n0 + c.col<T>(q);
      if (n < p.N) s[i] = nap_term(p, acc[i][q], n, s[i]);
    }
    // the 8 lanes sharing a row differ in their low 3 bits
#pragma unroll
    for (int off = 1; off < 8; off *= 2)
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
  }
  if (c.tx == 0) {
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int m = m0 + c.row<T>(i);
      if (m < p.M) p.partial[static_cast<size_t>(tile) * p.M + m] = s[i];
    }
  }
}

template <class T>
__global__ void __launch_bounds__(T::THREADS)
nap_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_v, NapOut p, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  float acc[T::ACC];
  // the hi and lo halves of the centred rows against one V^T box each stage
  if (!sm90::wgmma_gemm<T>(&map_x, &map_v, K, lo_column(K), m0, n0,
                           smem_raw, acc))
    return;
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  // s[0]: this thread's row, s[1]: the row 8 below (wgmma_row's layout)
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < T::ACC; ++r) {
    const int n = n0 + sm90::wgmma_col(r, t);
    if (n < p.N) s[(r / 2) % 2] = nap_term(p, acc[r], n, s[(r / 2) % 2]);
  }
  // the 4 lanes of a quad share both rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
  }
  if (t % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + sm90::wgmma_row(2 * h, t);
      if (m < p.M)
        p.partial[static_cast<size_t>(blockIdx.x) * p.M + m] = s[h];
    }
  }
}

__global__ void nap_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int B, int n_tiles,
                                  int J) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(size_t)t * B + b];
  out[b] = s / (float)J;
}

// ---------------------------------------------------------------------------
// variant 4: fp32 small batches, one cooperative launch
// ---------------------------------------------------------------------------

constexpr int NS_THREADS = 256;  // the consumers: 8 warps
constexpr int NS_BLOCK = NS_THREADS + 32;  // and one producer warp
constexpr int NS_TILE = 32;      // columns a unit and a partial (variant 0's)
constexpr int NS_MAX_B = 64;     // KERNEL_MAX_B of ops/nap_kernel.py
constexpr int NS_MAX_CH = 8;     // 32-deep stages per chunk, at most
constexpr int NS_MAX_RING = 4;   // chunks in flight, at most
constexpr int NS_PART_LD = 40;   // floats per (stage, row) of stage totals
// outputs a consumer thread adds
constexpr int NS_OWNED = NS_TILE * NS_MAX_B / NS_THREADS;

struct NapSmall {
  const float* x;
  const float* vt;
  const float* mu;
  const float* std_mu;
  const float* inv_std;
  float* xc;       // (B, ldxc) centred rows, 16-byte aligned, zero past K
  float* st;       // (B, n_tiles, nk, 32) stage totals, where K is split
  //                  (slices > 1): task b * n_tiles + t's are contiguous
  float* partial;  // (n_tiles, B) tile partials, n_tiles = ceil(J / 32)
  float* out;      // (B,)
  int ldx, ldv, ldxc, B, K, J;
  int slices;        // K slices: a unit is (32-column tile, K slice)
  int slice_stages;  // 32-deep stages per slice
  int ch;            // stages per chunk
  int ring;          // chunks in flight
};

// a shared row of one chunk: 32 * ch floats and 4 more, so that rows start
// in different 16-byte bank groups (row / 4 is odd)
__host__ __device__ constexpr int ns_row(int ch) { return 32 * ch + 4; }
// one ring slot: B centred x rows, then 32 V^T rows
__host__ __device__ constexpr int ns_slot_floats(int B, int ch) {
  return (B + NS_TILE) * ns_row(ch);
}
// the chunk's stage totals, (ch, B, 32) in rows of NS_PART_LD
__host__ __device__ constexpr int ns_part_floats(int B, int ch) {
  return ch * B * NS_PART_LD;
}
// the slots, the stage totals and three mbarriers a slot (V^T rows in, x
// rows in, slot free)
__host__ __device__ constexpr int ns_smem_floats(int B, int ch, int ring) {
  return (ring * ns_slot_floats(B, ch) + ns_part_floats(B, ch) + 1) / 2 * 2 +
         6 * ring;
}
__host__ __device__ constexpr int ns_rt(int B) {
  return B <= 8 ? 1 : B <= 16 ? 4 : 8;
}
// the centred rows' stride: K rounded up to 16 bytes
__host__ __device__ constexpr int ns_ldxc(int K) { return (K + 3) / 4 * 4; }

// Called by a whole warp for row b of the 32-column tile at j0, lane n
// holding rot[b, j0 + n]: the tile's sum of t^2 in variant 0's order (lane
// tx adds columns tx + 8 q in q order by fmaf, then the xor butterfly over
// 8 lanes), valid in lane 0.
__device__ __forceinline__ float ns_tile_sum(const NapSmall& p, float rot,
                                             int j0, int lane) {
  const int j = j0 + lane;
  float tv = 0.f;
  if (j < p.J)
    tv = __fmul_rn(__fsub_rn(rot, __ldg(p.std_mu + j)), __ldg(p.inv_std + j));
  const int tx = lane % 8;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float tq = __shfl_sync(0xffffffffu, tv, tx + 8 * q);
    if (j0 + tx + 8 * q < p.J) s = fmaf(tq, tq, s);
  }
#pragma unroll
  for (int off = 1; off < 8; off *= 2)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// the consumer warps' barrier (the producer warp runs on its own)
__device__ __forceinline__ void ns_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NS_THREADS) : "memory");
}

// RT rows per work item: item (cq, rg, s) is the 32-deep stage s of
// columns cq + 8 c (c < 4) for rows rg + G r (r < RT, G = ceil(B / RT)),
// each its own fmaf chain in k order from 0.  Warps 0-7 consume the ring,
// warp 8 fills it by bulk copies.
template <int RT>
__global__ void __launch_bounds__(NS_BLOCK, 1)
nap_small_kernel(const NapSmall p) {
  extern __shared__ __align__(16) float smem[];
  PROBE_DECL;
  PROBE_MARK(1, 0);
  const int tid = threadIdx.x, B = p.B, ch = p.ch, row = ns_row(ch);
  const int slot = ns_slot_floats(B, ch);
  float* part_s = smem + p.ring * slot;
  // full_v[s]: slot s's V^T rows landed; full_x[s]: its x rows; empty[s]:
  // the consumers are done with it
  uint64_t* full_v = reinterpret_cast<uint64_t*>(
      smem + ns_smem_floats(B, ch, p.ring) - 6 * p.ring);
  uint64_t* full_x = full_v + p.ring;
  uint64_t* empty = full_x + p.ring;
  const int nk = (p.K + 31) / 32;
  const int n_tiles = (p.J + NS_TILE - 1) / NS_TILE;
  const int units = n_tiles * p.slices;
  const int blocks = gridDim.x, block = blockIdx.x;
  const int mine = block < units ? (units - 1 - block) / blocks + 1 : 0;
  const int cpu = (p.slice_stages + ch - 1) / ch;  // chunks per unit
  const int total = mine * cpu;
  const int G = (B + RT - 1) / RT;
  const int lane = tid % 32, warp = tid / 32, warps = NS_BLOCK / 32;
  const bool split = p.slices > 1;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (tid == 0) {
    for (int i = 0; i < p.ring; ++i) {
      sm90::mbar_init(&full_v[i], 1);
      sm90::mbar_init(&full_x[i], 1);
      sm90::mbar_init(&empty[i], NS_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // iteration it: chunk it % cpu of unit `unit(it)`, whose tile is
  // unit % n_tiles and whose slice is unit / n_tiles
  auto unit = [&](int it) { return block + (it / cpu) * blocks; };
  auto stage0 = [&](int it) {
    return (unit(it) / n_tiles) * p.slice_stages + (it % cpu) * ch;
  };
  auto n_stages = [&](int it) {
    const int end = min(nk, (unit(it) / n_tiles + 1) * p.slice_stages);
    return max(0, min(ch, end - stage0(it)));
  };
  // the bytes of chunk it's rows, each up to K rounded up to 4 floats
  // (what lies past K is never read, or zero), 0 for an empty chunk
  auto row_bytes = [&](int it) {
    const int k0 = 32 * stage0(it), n_st = n_stages(it);
    return n_st > 0 ? 4 * min(32 * n_st, ns_ldxc(p.K) - k0) : 0;
  };

  if (warp == NS_THREADS / 32) {
    // The producer: each chunk into its slot once the consumers have freed
    // it, by bulk copies: the tile's V^T rows (rows past J skipped) on
    // full_v, the B centred x rows on full_x.  The first chunk's V^T rows
    // fly while the grid centres x.
    auto load_v = [&](int it) {
      const int s = it % p.ring, k0 = 32 * stage0(it);
      const int j0 = (unit(it) % n_tiles) * NS_TILE;
      const int rows = min(NS_TILE, p.J - j0), bytes = row_bytes(it);
      if (lane == 0) sm90::mbar_expect_tx(&full_v[s], bytes * rows);
      __syncwarp();
      if (bytes > 0 && lane < rows)
        sm90::bulk_load(smem + s * slot + B * row + lane * row,
                        p.vt + static_cast<size_t>(j0 + lane) * p.ldv + k0,
                        bytes, &full_v[s]);
    };
    auto load_x = [&](int it) {
      const int s = it % p.ring, k0 = 32 * stage0(it), bytes = row_bytes(it);
      if (lane == 0) sm90::mbar_expect_tx(&full_x[s], bytes * B);
      __syncwarp();
      if (bytes > 0)
        for (int r = lane; r < B; r += 32)
          sm90::bulk_load(smem + s * slot + r * row,
                          p.xc + static_cast<size_t>(r) * p.ldxc + k0, bytes,
                          &full_x[s]);
    };
    if (total > 0) load_v(0);
    grid.sync();
    // the centred rows the other blocks wrote, before the copy engine
    // reads them; then chunk by chunk, so that no chunk's rows queue
    // behind a later chunk's
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int it = 0; it < total; ++it) {
      if (it >= p.ring)
        sm90::mbar_wait(&empty[it % p.ring], (it / p.ring - 1) & 1);
      if (it > 0) load_v(it);
      load_x(it);
    }
  } else {
    // xc = x - mu, the one __fsub_rn of nap_center_kernel, once for the
    // whole grid, into aligned rows zero past K
    for (int e = block * NS_THREADS + tid; e < B * p.ldxc;
         e += blocks * NS_THREADS) {
      const int b = e / p.ldxc, k = e % p.ldxc;
      p.xc[e] = k < p.K ? __fsub_rn(p.x[static_cast<size_t>(b) * p.ldx + k],
                                    __ldg(p.mu + k))
                        : 0.f;
    }
    // these writes come before the copy engine's reads of them
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    grid.sync();
    // the running totals of the outputs this thread owns, (column o % 32,
    // row o / 32) for o = tid + NS_THREADS i, where K is not split
    float tot[NS_OWNED];
#pragma unroll
    for (int i = 0; i < NS_OWNED; ++i) tot[i] = 0.f;
    for (int it = 0; it < total; ++it) {
      const int s_ = it % p.ring, parity = (it / p.ring) & 1;
      sm90::mbar_wait(&full_v[s_], parity);
      sm90::mbar_wait(&full_x[s_], parity);
      // also frees the stage totals read last
      ns_consumers_sync();
      PROBE_MARK(2, it);
      const float* xs = smem + s_ * slot;
      const float* vs = xs + B * row;
      const int n_st = n_stages(it), st0 = stage0(it);
      for (int w = tid; w < n_st * 8 * G; w += NS_THREADS) {
        const int cq = w % 8, rg = (w / 8) % G, s = w / (8 * G);
        const float* vr = vs + cq * row + 32 * s;
        const float* xq = xs + 32 * s;
        // the stage's depth: 32, or what is left of K in the last one
        const int lim = min(32, p.K - 32 * (st0 + s));
        float acc[RT][4];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
        if (lim == 32) {
#pragma unroll 2
          for (int kk = 0; kk < 32; kk += 4) {
            float4 v[4];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              v[c] = *reinterpret_cast<const float4*>(vr + 8 * c * row + kk);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              // rows past B read row B - 1 and are never stored
              const float4 a = *reinterpret_cast<const float4*>(
                  xq + min(rg + G * r, B - 1) * row + kk);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc[r][c] = fmaf(a.x, v[c].x, acc[r][c]);
                acc[r][c] = fmaf(a.y, v[c].y, acc[r][c]);
                acc[r][c] = fmaf(a.z, v[c].z, acc[r][c]);
                acc[r][c] = fmaf(a.w, v[c].w, acc[r][c]);
              }
            }
          }
        } else {
          // the last stage, k by k up to K: past K lie stale floats
          // (skipping a zero term leaves the chain's bits as variant 0's
          // zero-filled copy)
          for (int kk = 0; kk < lim; ++kk) {
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              const float a = xq[min(rg + G * r, B - 1) * row + kk];
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[r][c] = fmaf(a, vr[8 * c * row + kk], acc[r][c]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int b = rg + G * r;
          if (b < B) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              part_s[(s * B + b) * NS_PART_LD + cq + 8 * c] = acc[r][c];
          }
        }
      }
      ns_consumers_sync();
      PROBE_MARK(6, it);
      // the slot is read: the producer may refill it
      if (lane == 0) sm90::mbar_arrive(&empty[s_]);
      // each output's owner takes the chunk's stage totals in stage order:
      // adds them to its running total, or, where K is split, stores them
      const int j0 = (unit(it) % n_tiles) * NS_TILE;
      const bool last = it % cpu == cpu - 1;
#pragma unroll
      for (int i = 0; i < NS_OWNED; ++i) {
        // whole warps: 32 divides NS_TILE * B
        const int o = tid + i * NS_THREADS;
        if (o < NS_TILE * B) {
          const int n = o % NS_TILE, b = o / NS_TILE;
          float v[NS_MAX_CH];
#pragma unroll
          for (int s = 0; s < NS_MAX_CH; ++s)
            v[s] = s < n_st ? part_s[(s * B + b) * NS_PART_LD + n] : 0.f;
          if (split) {
            float* dst = p.st + ((static_cast<size_t>(b) * n_tiles +
                                  j0 / NS_TILE) * nk + st0) * NS_TILE + n;
#pragma unroll
            for (int s = 0; s < NS_MAX_CH; ++s)
              if (s < n_st) dst[s * NS_TILE] = v[s];
          } else {
#pragma unroll
            for (int s = 0; s < NS_MAX_CH; ++s)
              if (s < n_st) tot[i] = __fadd_rn(tot[i], v[s]);
            if (last) {
              const float t = ns_tile_sum(p, tot[i], j0, n);
              if (n == 0)
                p.partial[static_cast<size_t>(unit(it) % n_tiles) * B + b] =
                    t;
              tot[i] = 0.f;
            }
          }
        }
      }
      PROBE_MARK(7, it);
    }
  }
  if (split) {
    PROBE_MARK(3, 0);
    grid.sync();
    PROBE_MARK(4, 0);
    // (row, tile) tasks, b * n_tiles + t, a warp's each: a block takes
    // ceil(tasks / blocks) of them, copies `batch` tasks' stage totals at
    // a time into shared memory (the ring's, free now) with every thread's
    // loads in flight, then lane n of each warp adds column n's in stage
    // order from stage 0, and the warp takes the tile's sum
    constexpr int U = 24;  // loads in flight per thread
    const int per_task = nk * NS_TILE, tasks = n_tiles * B;
    const int per_block = (tasks + blocks - 1) / blocks;
    const int batch = min(warps, (ns_smem_floats(B, ch, p.ring) -
                                  6 * p.ring) / per_task);
    const int end = min(tasks, (block + 1) * per_block);
    for (int t0 = block * per_block; t0 < end; t0 += batch) {
      const int n_tasks = min(batch, end - t0), n = n_tasks * per_task;
      const float* src = p.st + static_cast<size_t>(t0) * per_task;
      for (int base = 0; base < n; base += U * NS_BLOCK) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = base + tid + u * NS_BLOCK;
          v[u] = e < n ? __ldcg(src + e) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = base + tid + u * NS_BLOCK;
          if (e < n) smem[e] = v[u];
        }
      }
      __syncthreads();
      if (warp < n_tasks) {
        const int task = t0 + warp, t = task % n_tiles, b = task / n_tiles;
        const float* tot_s = smem + warp * per_task + lane;
        float acc = 0.f;
        for (int s = 0; s < nk; ++s) acc = __fadd_rn(acc, tot_s[s * NS_TILE]);
        const float sum = ns_tile_sum(p, acc, NS_TILE * t, lane);
        if (lane == 0) p.partial[static_cast<size_t>(t) * B + b] = sum;
      }
      __syncthreads();
    }
  }
  PROBE_MARK(3, 1);
  grid.sync();
  PROBE_MARK(4, 1);
  // one thread per row: the tile partials in tile order, then / J
  const int b = block * NS_BLOCK + tid;
  if (b < B) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t)
      s = __fadd_rn(s, __ldcg(p.partial + static_cast<size_t>(t) * B + b));
    p.out[b] = __fdiv_rn(s, static_cast<float>(p.J));
  }
  PROBE_MARK(5, 0);
}

// ---------------------------------------------------------------------------
// variant 4 where J has tiles for half the grid: the even schedule
// ---------------------------------------------------------------------------

constexpr int NE_CONSUMERS = 256;  // eight consumer warps, two a scheduler
constexpr int NE_BLOCK = NE_CONSUMERS + 32;  // and one producer warp
constexpr int NE_LANES = 8;   // a consumer's column lane is lane % 8
constexpr int NE_SUBS = NE_CONSUMERS / NE_LANES;  // work items at a time
constexpr int NE_S = 8;       // 32-deep stages per chunk
constexpr int NE_KC = 32 * NE_S;  // a chunk's columns of K
constexpr int NE_RING = 2;    // chunks in flight (more stream no faster)
// The most rows the even schedule takes: past them its items' shared
// memory reads outlast the bytes, and the tile kernel is faster (B = 32,
// J = 4096: 0.125 against 0.105 ms; PERF.md).
constexpr int NE_MAX_B = 16;

struct NapEven {
  const float* x;
  const float* mu;
  const float* std_mu;
  const float* inv_std;
  float* tv;   // (B, ldt) t = (rot - std_mu) * inv_std of every output
  float* out;  // (B,)
  int ldx, ldt, B, K, J;
  int groups;  // block g holds columns [g J / groups, (g + 1) J / groups)
  int rows;    // V^T rows a stage's box: the widest pass's columns
};

// A chunk's slot: for each of its stages the pass's V^T rows, 8 C rows of
// 128 bytes in the tensor copy's 128-byte swizzle (C KB, 1024-byte
// aligned); then the B centred rows over the chunk's columns of K.
__host__ __device__ constexpr int ne_slot_bytes(int B, int C) {
  return NE_S * C * 1024 + (B * NE_KC * 4 + 1023) / 1024 * 1024;
}
// a chunk's stage totals, (NE_S, B, 8 C) floats with the stages 8 floats
// apart beyond the rows, so that a warp's four items store to different
// banks
__host__ __device__ constexpr int ne_fold_stride(int B, int C) {
  return B * NE_LANES * C + 8;
}
// the alignment's slack, the slots, two chunks' stage totals and two
// mbarriers a slot (V^T rows in, slot free)
__host__ __device__ constexpr int ne_smem_bytes(int B, int C) {
  return 1024 + NE_RING * ne_slot_bytes(B, C) +
         2 * NE_S * ne_fold_stride(B, C) * 4 + 2 * NE_RING * 8;
}
// the tiles: C columns a lane (8 C a pass) by R rows an item, two items a
// stage where B allows; an R-row kernel takes up to ne_max_b(R) rows
constexpr int ne_c(int w) { return w <= 32 ? 4 : 6; }
constexpr int ne_r(int B) {
  return B <= 1 ? 1 : B <= 4 ? 2 : B <= 8 ? 4 : B <= 10 ? 5 : 8;
}
__host__ __device__ constexpr int ne_max_b(int R) {
  return R == 1 ? 1 : 2 * R;
}

// the consumer warps' barrier (the producer warp runs on its own)
__device__ __forceinline__ void ne_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NE_CONSUMERS) : "memory");
}

// A block holds the contiguous columns [c0, c1) of J, the J / groups
// columns of the even partition (their counts differ by one at most), and
// streams their V^T rows over all of K in passes of 8 C columns, a chunk
// of NE_S stages at a time.  The consumers centre each chunk's columns of
// x themselves, x - mu (the one __fsub_rn of nap_center_kernel), loaded a
// chunk ahead.  A chunk's work item (q, rg) is its stage q for rows rg R +
// r (r < R); lane cl of the item's eight takes columns cl + 8 i (i < C),
// each output an fmaf chain of 32 in k order from 0, and stores its stage
// totals in shared memory.  After the consumers' barrier each output's
// owner adds the chunk's totals in stage order to the running total it
// keeps in a register, and after a pass's last chunk stores the output's
// t.  Warps 0-7 consume the ring, warp 8 fills it by tensor copies.
template <int R, int C>
__global__ void __launch_bounds__(NE_BLOCK, 1)
nap_small_kernel_even(const NapEven p,
                      const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled boxes 1024-byte aligned
  unsigned char* const smem =
      smem_raw + (1024 - sm90::smem_u32(smem_raw) % 1024) % 1024;
  PROBE_DECL;
  PROBE_MARK(1, 0);
  constexpr int W = NE_LANES * C;  // columns a pass
  constexpr int MB = ne_max_b(R);
  // the outputs a consumer owns, at most, and the columns of K it centres
  // a chunk
  constexpr int OWN = (MB * W + NE_CONSUMERS - 1) / NE_CONSUMERS;
  constexpr int KJ = NE_KC / NE_CONSUMERS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int B = p.B, ring = NE_RING;
  const int slot = ne_slot_bytes(B, C), fs = ne_fold_stride(B, C);
  float* const fold = reinterpret_cast<float*>(smem + ring * slot);
  // full[s]: slot s's V^T rows landed; empty[s]: the consumers are done
  // with them
  uint64_t* const full = reinterpret_cast<uint64_t*>(fold + 2 * NE_S * fs);
  uint64_t* const empty = full + ring;
  const int nk = (p.K + 31) / 32;
  const int n_tiles = (p.J + NS_TILE - 1) / NS_TILE;
  const int blocks = gridDim.x, block = blockIdx.x;
  const int c0 = static_cast<int>(static_cast<long long>(block) * p.J /
                                  p.groups);
  const int c1 = static_cast<int>(static_cast<long long>(block + 1) * p.J /
                                  p.groups);
  const int cpp = (nk + NE_S - 1) / NE_S;  // chunks a pass
  const int total = (c1 - c0 + W - 1) / W * cpp;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (tid == 0) {
    for (int i = 0; i < ring; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], NE_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // iteration it: chunk it % cpp of pass it / cpp
  auto stage0 = [&](int it) { return (it % cpp) * NE_S; };
  auto n_stages = [&](int it) { return min(NE_S, nk - stage0(it)); };
  auto col0 = [&](int it) { return c0 + (it / cpp) * W; };

  if (warp == NE_CONSUMERS / 32) {
    // The producer: each chunk's V^T rows into its slot once the consumers
    // have freed it, by tensor copies, a box of 32 columns of K by `rows`
    // V^T rows a stage (reads past K or J fill zeros).
    for (int it = 0; it < total; ++it) {
      const int s = it % ring;
      if (it >= ring) sm90::mbar_wait(&empty[s], (it / ring - 1) & 1);
      if (lane == 0) {
        const int n = n_stages(it);
        sm90::mbar_expect_tx(&full[s], n * p.rows * 128);
        for (int q = 0; q < n; ++q)
          sm90::tma_load(smem + s * slot + q * C * 1024, &map_v, &full[s],
                         32 * (stage0(it) + q), col0(it));
      }
    }
  } else {
    const int cl = lane % NE_LANES, sub = tid / NE_LANES;
    const int nr = (B + R - 1) / R, outs = B * W;
    // x and mu at the chunk's columns tid + 256 j of K (zeros past K), and
    // x - mu into the slot's rows
    float xr[MB][KJ], mr[KJ];
    auto fetch_x = [&](int it) {
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int k = 32 * stage0(it) + tid + NE_CONSUMERS * j;
        mr[j] = k < p.K ? __ldg(p.mu + k) : 0.f;
#pragma unroll
        for (int b = 0; b < MB; ++b)
          xr[b][j] = b < B && k < p.K
                         ? p.x[static_cast<size_t>(b) * p.ldx + k]
                         : 0.f;
      }
    };
    auto store_x = [&](int it) {
      float* const xs = reinterpret_cast<float*>(
          smem + (it % ring) * slot + NE_S * C * 1024);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
#pragma unroll
        for (int b = 0; b < MB; ++b)
          if (b < B)
            xs[b * NE_KC + tid + NE_CONSUMERS * j] =
                __fsub_rn(xr[b][j], mr[j]);
    };
    // the running totals of outputs tid + 256 m, (row o / W, column o % W
    // of the pass)
    float tot[OWN];
#pragma unroll
    for (int m = 0; m < OWN; ++m) tot[m] = 0.f;
    if (total > 0) {
      fetch_x(0);
      store_x(0);
    }
    ne_consumers_sync();
    for (int it = 0; it < total; ++it) {
      const int s_ = it % ring;
      // the next chunk's x in flight while this one computes
      const bool next = it + 1 < total;
      if (next) fetch_x(it + 1);
      sm90::mbar_wait(&full[s_], (it / ring) & 1);
      PROBE_MARK(2, it);
      const unsigned char* const vs = smem + s_ * slot;
      const float* const xs =
          reinterpret_cast<const float*>(vs + NE_S * C * 1024);
      float* const fb = fold + (it % 2) * NE_S * fs;
      const int n_st = n_stages(it);
      for (int u = sub; u < n_st * nr; u += NE_SUBS) {
        const int q = u % n_st, rg = u / n_st;
        // row cl + 8 i of the stage's box is 128 (cl + 8 i) bytes in; its
        // float4 f lies at (f ^ cl) in the swizzle
        const unsigned char* const vq = vs + q * C * 1024 + cl * 128;
        // the item's x rows (rows past B read row B - 1 and are never
        // stored)
        int xo[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          xo[r] = min(rg * R + r, B - 1) * NE_KC + 32 * q;
        float acc[R][C];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int i = 0; i < C; ++i) acc[r][i] = 0.f;
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          const int sw = (f ^ cl) * 16;
          float4 v[C], a[R];
#pragma unroll
          for (int i = 0; i < C; ++i)
            v[i] = *reinterpret_cast<const float4*>(vq + i * 1024 + sw);
#pragma unroll
          for (int r = 0; r < R; ++r)
            a[r] = *reinterpret_cast<const float4*>(xs + xo[r] + 4 * f);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < C; ++i) {
              acc[r][i] = fmaf(a[r].x, v[i].x, acc[r][i]);
              acc[r][i] = fmaf(a[r].y, v[i].y, acc[r][i]);
              acc[r][i] = fmaf(a[r].z, v[i].z, acc[r][i]);
              acc[r][i] = fmaf(a[r].w, v[i].w, acc[r][i]);
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int b = rg * R + r;
          if (b < B) {
#pragma unroll
            for (int i = 0; i < C; ++i)
              fb[q * fs + b * W + cl + NE_LANES * i] = acc[r][i];
          }
        }
      }
      PROBE_MARK(6, it);
      // the slot's V^T rows are read: the producer may refill them
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s_]);
      // the next chunk's x into its slot, whose x rows the chunk a ring
      // before read
      if (next) store_x(it + 1);
      ne_consumers_sync();
      // each output's owner adds the chunk's stage totals in stage order
      // (the other half of the buffer takes the next chunk's); after the
      // pass's last chunk it stores the output's t
      const int cols = min(W, c1 - col0(it));
      const bool last = it % cpp == cpp - 1;
#pragma unroll
      for (int m = 0; m < OWN; ++m) {
        const int o = tid + NE_CONSUMERS * m;
        if (o < outs) {
          float v[NE_S];
#pragma unroll
          for (int q = 0; q < NE_S; ++q)
            v[q] = q < n_st ? fb[q * fs + o] : 0.f;
#pragma unroll
          for (int q = 0; q < NE_S; ++q)
            if (q < n_st) tot[m] = __fadd_rn(tot[m], v[q]);
          if (last) {
            const int n = o % W, j = col0(it) + n;
            if (n < cols)
              p.tv[static_cast<size_t>(o / W) * p.ldt + j] =
                  __fmul_rn(__fsub_rn(tot[m], __ldg(p.std_mu + j)),
                            __ldg(p.inv_std + j));
            tot[m] = 0.f;
          }
        }
      }
      PROBE_MARK(7, it);
    }
  }
  PROBE_MARK(3, 1);
  grid.sync();
  PROBE_MARK(4, 1);
  // A block a row: thread i takes the tiles i + 160 u, each tile's sum of
  // t^2 in variant 0's order (column lane tx's chain over tx + 8 q in q
  // order, then the xor butterfly's adds, ((0 + 1) + (2 + 3)) + ((4 + 5) +
  // (6 + 7))) into shared memory; then one thread adds the tile partials
  // in tile order and divides by J.
  float* const part = reinterpret_cast<float*>(smem);
  for (int b = block; b < B; b += blocks) {
    const float* tv = p.tv + static_cast<size_t>(b) * p.ldt;
    for (int t = tid; t < n_tiles; t += NE_BLOCK) {
      // the tile's t, 16-byte rows (what lies past J is never used)
      float4 v[NS_TILE / 4];
#pragma unroll
      for (int n = 0; n < NS_TILE / 4; ++n)
        v[n] = NS_TILE * t + 4 * n < p.J
                   ? __ldcg(reinterpret_cast<const float4*>(
                         tv + NS_TILE * t + 4 * n))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      const float* tt = reinterpret_cast<const float*>(v);
      float s[8];
#pragma unroll
      for (int tx = 0; tx < 8; ++tx) {
        s[tx] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (NS_TILE * t + tx + 8 * q < p.J)
            s[tx] = fmaf(tt[tx + 8 * q], tt[tx + 8 * q], s[tx]);
      }
      part[t] = __fadd_rn(
          __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3])),
          __fadd_rn(__fadd_rn(s[4], s[5]), __fadd_rn(s[6], s[7])));
    }
    PROBE_MARK(8, b);
    __syncthreads();
    if (tid == 0) {
      // in tile order, the next 8 partials' loads in flight during the
      // adds of these 8
      float s = 0.f, v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = u < n_tiles ? part[u] : 0.f;
      for (int t = 0; t < n_tiles; t += 8) {
        float nv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          nv[u] = t + 8 + u < n_tiles ? part[t + 8 + u] : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (t + u < n_tiles) s = __fadd_rn(s, v[u]);
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = nv[u];
      }
      p.out[b] = __fdiv_rn(s, static_cast<float>(p.J));
    }
    PROBE_MARK(10, b);
    __syncthreads();
  }
  PROBE_MARK(5, 0);
}

// The launch shape of variant 4: its grid and dynamic shared memory, the
// scratch it needs in floats, and its partition's balance, the busiest
// block's columns x stages of V^T over the mean block's.
struct SmallShape {
  int grid = 0, smem = 0;
  long long scratch = 0;
  double balance = 0;
};

// Whether variant 4 takes the even schedule at (B, J) on `sms` SMs: at B <=
// NE_MAX_B where J's 32-column tiles number half the grid or more, so that
// one K slice keeps every SM streaming; else the tile kernel.
bool ns_even(int B, int J, int sms) {
  return B <= NE_MAX_B && 2 * ((J + NS_TILE - 1) / NS_TILE) >= sms;
}

// The chunk depth and ring at B rows in `floats` of shared memory: the
// stages whose items fill the consumers once, then the deepest multiple of
// them (NS_MAX_CH at most) that two slots hold, then as many slots as fit
// (NS_MAX_RING at most); the ring is 0 where two slots do not fit.
void ns_ring(int B, int floats, int* ch, int* ring) {
  const int G = (B + ns_rt(B) - 1) / ns_rt(B);
  const int ch0 = std::max(1, std::min(NS_MAX_CH, NS_THREADS / (8 * G)));
  *ch = ch0;
  while (*ch + ch0 <= NS_MAX_CH && ns_smem_floats(B, *ch + ch0, 2) <= floats)
    *ch += ch0;
  *ring = ns_smem_floats(B, *ch, 2) <= floats ? 2 : 0;
  while (*ring && *ring < NS_MAX_RING &&
         ns_smem_floats(B, *ch, *ring + 1) <= floats)
    ++*ring;
}

// The tile kernel's launch shape at p's (B, K, J) on device d: the chunk
// depth (enough work items for the consumer threads), the ring that fits
// beside it, the grid the occupancy query allows, and the K split: one
// slice where there are tiles for half the grid, else as many slices as
// fill it.
template <int RT>
cudaError_t small_shape(NapSmall* p, const sm90::DeviceInfo& d,
                        SmallShape* shape) {
  const int B = p->B;
  int ch = 0, ring = 0;
  ns_ring(B, d.smem_optin / 4, &ch, &ring);
  if (ring == 0) return cudaErrorInvalidValue;
  p->ch = ch;
  p->ring = ring;
  shape->smem = ns_smem_floats(B, ch, ring) * 4;
  static cudaError_t attr =
      sm90::allow_smem(nap_small_kernel<RT>, d.smem_optin);
  if (attr != cudaSuccess) return attr;
  int per_sm = 0;
  cudaError_t err = sm90::resident_blocks(nap_small_kernel<RT>, d.dev,
                                          NS_BLOCK, shape->smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorCooperativeLaunchTooLarge;
  const int cap = per_sm * d.sms;
  const int nk = (p->K + 31) / 32, n_tiles = (p->J + NS_TILE - 1) / NS_TILE;
  int slices = 1;
  if (2 * n_tiles < cap) slices = std::max(1, cap / n_tiles);
  p->slice_stages = (nk + slices - 1) / slices;
  p->slices = (nk + p->slice_stages - 1) / p->slice_stages;
  // where K is split, the fold stages at least one task's stage totals in
  // the ring's shared memory
  if (p->slices > 1 && ns_smem_floats(B, ch, ring) - 6 * ring < nk * NS_TILE)
    return cudaErrorInvalidValue;
  const int units = n_tiles * p->slices;
  shape->grid = std::min(units, cap);
  shape->scratch = static_cast<long long>(B) * ns_ldxc(p->K) +
                   static_cast<long long>(n_tiles) * B +
                   (p->slices > 1 ? static_cast<long long>(nk) * B *
                                        n_tiles * NS_TILE
                                  : 0);
  // a block's units, a unit's columns and stages at most
  shape->balance = static_cast<double>((units + shape->grid - 1) /
                                       shape->grid) *
                   std::min(NS_TILE, p->J) * p->slice_stages * shape->grid /
                   (static_cast<double>(p->J) * nk);
  return cudaSuccess;
}

template <int RT>
cudaError_t small_launch(NapSmall p, const sm90::DeviceInfo& d, bool launch,
                         cudaStream_t stream, SmallShape* shape) {
  cudaError_t err = small_shape<RT>(&p, d, shape);
  if (err != cudaSuccess || !launch) return err;
  // the centred rows first, at the scratch's (16-byte aligned) start, then
  // the stage totals, then the partials
  p.ldxc = ns_ldxc(p.K);
  p.xc = p.st;
  p.st = p.xc + static_cast<size_t>(p.B) * p.ldxc;
  const size_t n_tiles = (p.J + NS_TILE - 1) / NS_TILE;
  p.partial = p.st + (p.slices > 1 ? static_cast<size_t>((p.K + 31) / 32) *
                                         p.B * n_tiles * NS_TILE
                                   : 0);
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(nap_small_kernel<RT>), dim3(shape->grid),
      dim3(NS_BLOCK), args, static_cast<size_t>(shape->smem), stream);
}

// The even schedule's launch shape at p's (B, K, J) on device d: a block
// an SM and the columns dealt out evenly over them.
template <int R, int C>
cudaError_t even_shape(NapEven* p, const sm90::DeviceInfo& d,
                       SmallShape* shape) {
  const int B = p->B, limit = d.smem_optin;
  p->groups = std::min(p->J, d.sms);
  const int w = (p->J + p->groups - 1) / p->groups;
  p->rows = std::min(w, NE_LANES * C);
  shape->smem = ne_smem_bytes(B, C);
  // the rows' pass stages a partial a tile in the same shared memory
  if (shape->smem > limit ||
      1024 + 4 * ((p->J + NS_TILE - 1) / NS_TILE) > shape->smem)
    return cudaErrorInvalidValue;
  static cudaError_t attr =
      sm90::allow_smem(nap_small_kernel_even<R, C>, limit);
  if (attr != cudaSuccess) return attr;
  int per_sm = 0;
  cudaError_t err = sm90::resident_blocks(nap_small_kernel_even<R, C>,
                                          d.dev, NE_BLOCK, shape->smem,
                                          &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorCooperativeLaunchTooLarge;
  shape->grid = p->groups;
  p->ldt = ns_ldxc(p->J);
  shape->scratch = static_cast<long long>(B) * p->ldt;
  shape->balance = static_cast<double>(w) * p->groups / p->J;
  return cudaSuccess;
}

// Tensor map of V^T, (J, K) fp32 with row stride `ldv` floats, read in
// boxes of 32 columns of K by `rows` rows in the 128-byte swizzle; reads
// past J or K fill zeros.  Returns false where cuTensorMapEncodeTiled
// refuses it.
bool ne_map(CUtensorMap* map, const float* vt, int J, int K, int ldv,
            int rows) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(J)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldv) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(vt),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int R, int C>
cudaError_t even_launch(NapEven p, const float* vt, int ldv,
                        const sm90::DeviceInfo& d, bool launch,
                        cudaStream_t stream, SmallShape* shape) {
  cudaError_t err = even_shape<R, C>(&p, d, shape);
  if (err != cudaSuccess || !launch) return err;
  CUtensorMap map_v;
  if (!ne_map(&map_v, vt, p.J, p.K, ldv, p.rows))
    return cudaErrorInvalidValue;
  void* args[] = {&p, &map_v};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(nap_small_kernel_even<R, C>),
      dim3(shape->grid), dim3(NE_BLOCK), args,
      static_cast<size_t>(shape->smem), stream);
}

// Variant 4 on the current device: the even schedule or the tile kernel
// (ns_even), the tiles from B and the block's columns.  Fills `shape`,
// and if `launch` launches on `stream` with `scratch` (shape's floats,
// 16-byte aligned: the outputs' t, or the centred rows, the stage totals
// and the tile partials).
cudaError_t nap_small(const float* x, int ldx, const float* vt, int ldv,
                      const float* mu, const float* std_mu,
                      const float* inv_std, float* scratch, float* out,
                      int B, int K, int J, bool launch, cudaStream_t stream,
                      SmallShape* shape) {
  if (B < 1 || B > NS_MAX_B || K < 1 || J < 1 || ldv % 4 != 0)
    return cudaErrorInvalidValue;
  sm90::DeviceInfo d;
  cudaError_t err = sm90::device_info(&d);
  if (err != cudaSuccess) return err;
  if (ns_even(B, J, d.sms)) {
    NapEven p{};
    p.x = x;
    p.mu = mu;
    p.std_mu = std_mu;
    p.inv_std = inv_std;
    p.tv = scratch;
    p.out = out;
    p.ldx = ldx;
    p.B = B;
    p.K = K;
    p.J = J;
    const int groups = std::min(J, d.sms);
    const int C = ne_c((J + groups - 1) / groups);
    switch (ne_r(B) * 16 + C) {
#define NE_CASE(R_, C_)   \
  case R_ * 16 + C_:      \
    return even_launch<R_, C_>(p, vt, ldv, d, launch, stream, shape);
      NE_CASE(1, 4) NE_CASE(2, 4) NE_CASE(4, 4) NE_CASE(5, 4) NE_CASE(8, 4)
      NE_CASE(1, 6) NE_CASE(2, 6) NE_CASE(4, 6) NE_CASE(5, 6) NE_CASE(8, 6)
#undef NE_CASE
      default: return cudaErrorInvalidValue;
    }
  }
  NapSmall p{};
  p.x = x;
  p.vt = vt;
  p.mu = mu;
  p.std_mu = std_mu;
  p.inv_std = inv_std;
  p.st = scratch;
  p.out = out;
  p.ldx = ldx;
  p.ldv = ldv;
  p.B = B;
  p.K = K;
  p.J = J;
  switch (ns_rt(B)) {
    case 1: return small_launch<1>(p, d, launch, stream, shape);
    case 4: return small_launch<4>(p, d, launch, stream, shape);
    default: return small_launch<8>(p, d, launch, stream, shape);
  }
}

// The launch shape of variant 4 at (B, K, J) on the current device, with
// cudaSuccess, or the error that a launch would return.
cudaError_t small_query(int B, int K, int J, SmallShape* shape) {
  return nap_small(nullptr, K, nullptr, 4, nullptr, nullptr, nullptr,
                   nullptr, nullptr, B, K, J, false, nullptr, shape);
}

template <typename T>
cudaError_t center(const float* x, int ldx, const float* mu, void* xc,
                   int ldxc, int B, int K, cudaStream_t stream) {
  const dim3 grid(std::min((K + 255) / 256, 64), std::min(B, 65535));
  nap_center_kernel<T><<<grid, 256, 0, stream>>>(
      x, ldx, mu, static_cast<T*>(xc), ldxc, B, K);
  return cudaGetLastError();
}

template <class T>
cudaError_t product_simt(const void* xc, int ldxc, const void* vt, int ldv,
                         const NapOut& p, int K, cudaStream_t stream) {
  static cudaError_t attr = sm90::allow_smem(nap_simt_kernel<T>,
                                             T::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + T::BM - 1) / T::BM);
  nap_simt_kernel<T><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      static_cast<const float*>(xc), ldxc, static_cast<const float*>(vt),
      ldv, p, K);
  return cudaGetLastError();
}

template <class T>
cudaError_t product_wgmma(const void* xc, int ldxc, const void* vt, int ldv,
                          const NapOut& p, int K, cudaStream_t stream) {
  static cudaError_t attr = sm90::allow_smem(nap_wgmma_kernel<T>,
                                             T::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_x, map_v;
  if (!sm90::tma_map_bf16(&map_x, xc, p.M, lo_column(K) + K, ldxc, T::BM) ||
      !sm90::tma_map_bf16(&map_v, vt, p.N, K, ldv, T::BN))
    return cudaErrorInvalidValue;
  const dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + T::BM - 1) / T::BM);
  nap_wgmma_kernel<T><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      map_x, map_v, p, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns of the centred-row scratch xc that `variant` needs for depth K
// (variant 4 centres into its own scratch and needs none).
int nap_score_xc_cols(int variant, int K) {
  if (variant == 4) return 0;
  return (variant == 2 || variant == 3) ? lo_column(K) + K : K;
}

// Columns of J that one partial row sum covers in `variant`: the caller's
// (n_tiles, B) fp32 scratch holds ceil(J / nap_score_tile_j(variant)) rows.
// 0 for an unknown variant.
int nap_score_tile_j(int variant) {
  switch (variant) {
    case 0: return NapNarrow::WARP_N;
    case 1: return NapWide::WARP_N;
    case 2: return NapNarrow16::BN;
    case 3: return NapWide16::BN;
    case 4: return NS_TILE;
    default: return 0;
  }
}

// Variant 0-4 (above).  x (B, K) fp32 with unit column stride and row
// stride ldx; V^T (J, K) in the kernel type with row stride ldv; mu (K,),
// std_mu (J,), inv_std (J,), out (B,) fp32.  Scratch: xc in the kernel type
// with row stride ldxc, (B, K) for fp32 and (B, ceil(K / 64) * 64 + K) for
// bf16 (nap_score_xc_cols), and partial
// (ceil(J / nap_score_tile_j(variant)), B) fp32.  ldv and ldxc are
// multiples of 16 bytes and every row is 16-byte aligned.  Variant 4
// takes 1 <= B <= 64 and any ldx, ignores xc and uses `partial`, 16-byte
// aligned, as its one scratch of nap_score_small_scratch(B, K, J) floats.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launches (or cudaErrorInvalidValue for an
// unknown variant or a tensor map the CUDA driver refuses).
int nap_score(int variant, const float* x, int ldx, const void* vt, int ldv,
              const float* mu, const float* std_mu, const float* inv_std,
              void* xc, int ldxc, float* partial, float* out, int B, int K,
              int J, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 4) {
    SmallShape shape;
    return static_cast<int>(nap_small(x, ldx, static_cast<const float*>(vt),
                                      ldv, mu, std_mu, inv_std, partial, out,
                                      B, K, J, true, s, &shape));
  }
  const int tj = nap_score_tile_j(variant);
  if (tj == 0) return static_cast<int>(cudaErrorInvalidValue);
  const NapOut p{std_mu, inv_std, partial, B, J};
  const bool bf16 = variant == 2 || variant == 3;
  cudaError_t err = bf16 ? center<__nv_bfloat16>(x, ldx, mu, xc, ldxc, B, K, s)
                         : center<float>(x, ldx, mu, xc, ldxc, B, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (variant) {
    case 0: err = product_simt<NapNarrow>(xc, ldxc, vt, ldv, p, K, s); break;
    case 1: err = product_simt<NapWide>(xc, ldxc, vt, ldv, p, K, s); break;
    case 2: err = product_wgmma<NapNarrow16>(xc, ldxc, vt, ldv, p, K, s); break;
    case 3: err = product_wgmma<NapWide16>(xc, ldxc, vt, ldv, p, K, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  nap_reduce_kernel<<<(B + 255) / 256, 256, 0, s>>>(partial, out, B,
                                                     (J + tj - 1) / tj, J);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory one block of `variant`'s tile product launches
// with (variant 4: at the robot's tick, B = 10, K = J = 5482, on the
// current device); 0 if unknown.
int nap_score_smem_bytes(int variant) {
  switch (variant) {
    case 0: return NapNarrow::SMEM_BYTES;
    case 1: return NapWide::SMEM_BYTES;
    case 2: return NapNarrow16::SMEM_BYTES;
    case 3: return NapWide16::SMEM_BYTES;
    case 4: {
      SmallShape shape;
      return small_query(10, 5482, 5482, &shape) == cudaSuccess ? shape.smem
                                                                : 0;
    }
    default: return 0;
  }
}

// Floats of scratch variant 4 takes at (B, K, J) on the current device
// (the outputs' t, or the centred rows, the stage totals where it splits
// K and the tile partials); -1 for arguments it does not take or a failed
// device query.
long long nap_score_small_scratch(int B, int K, int J) {
  SmallShape shape;
  return small_query(B, K, J, &shape) == cudaSuccess ? shape.scratch : -1;
}

// Variant 4's partition at (B, K, J) on the current device: its busiest
// block's columns x stages of V^T over the mean of its blocks; -1 where
// nap_score_small_scratch is.
double nap_score_small_balance(int B, int K, int J) {
  SmallShape shape;
  return small_query(B, K, J, &shape) == cudaSuccess ? shape.balance : -1;
}

const char* nap_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
