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
//     small-batch variants reach neither.  A split of K at small B and a
//     whole-module launch are later work.

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
