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
//   * fp32 sums K in one FMA chain in k order per output (the single-tile
//     kernel this replaces: golden 1.1115e-3 against 2e-3); the tensor
//     cores sum bf16 products in fp32, twice the product's operations (hi
//     and lo) against each V^T box.
//   * The TPU kernel carries the row sum across J tiles in a revisited output
//     block, which relies on its grid running in order.  Hopper's blocks run
//     in no order, so the partial sums go to an (n_tiles, B) scratch and a
//     last small kernel adds them in a fixed order and divides by J: the
//     result is deterministic, with no atomics.
//
// Bound on an H100 SXM (the operations at the 67 TFLOP/s fp32 non-tensor
// rate or 989 TFLOP/s bf16; the bytes at 3.35 TB/s):
//   * B = 4096, K = 5482, J = 4096: 2*B*K*J = 184 GFLOP, compute-bound at
//     ~2.7 ms in fp32 and ~0.19 ms in bf16 (the hi/lo split doubles the
//     tensor-core work, ~0.37 ms).
//   * B = 10: reading V (90 MB fp32, 45 MB bf16) dominates, memory-bound at
//     ~27 us and ~13 us.

#include <algorithm>
#include <type_traits>

#include "sm90_gemm.cuh"

namespace {

using NapNarrow = sm90::SimtTile<4, 4, 4, false>;
using NapWide = sm90::SimtTile<8, 8, 4, false>;
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

// Columns of the centred-row scratch xc that `variant` needs for depth K.
int nap_score_xc_cols(int variant, int K) {
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
    default: return 0;
  }
}

// Variant 0-3 (above).  x (B, K) fp32 with unit column stride and row
// stride ldx; V^T (J, K) in the kernel type with row stride ldv; mu (K,),
// std_mu (J,), inv_std (J,), out (B,) fp32.  Scratch: xc in the kernel type
// with row stride ldxc, (B, K) for fp32 and (B, ceil(K / 64) * 64 + K) for
// bf16 (nap_score_xc_cols), and partial
// (ceil(J / nap_score_tile_j(variant)), B) fp32.  ldv and ldxc are
// multiples of 16 bytes and every row is 16-byte aligned.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launches (or cudaErrorInvalidValue for an unknown variant or a tensor map
// the driver refuses).
int nap_score(int variant, const float* x, int ldx, const void* vt, int ldv,
              const float* mu, const float* std_mu, const float* inv_std,
              void* xc, int ldxc, float* partial, float* out, int B, int K,
              int J, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
// with; 0 if unknown.
int nap_score_smem_bytes(int variant) {
  switch (variant) {
    case 0: return NapNarrow::SMEM_BYTES;
    case 1: return NapWide::SMEM_BYTES;
    case 2: return NapNarrow16::SMEM_BYTES;
    case 3: return NapWide16::SMEM_BYTES;
    default: return 0;
  }
}

const char* nap_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
