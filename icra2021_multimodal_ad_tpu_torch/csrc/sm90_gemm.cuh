// The K-looped tile product shared by the port's two kernels on Hopper
// (sm_90a), written once:
//
//     acc[m, n] = sum_k A[m, k] * B[n, k]
//
// with both operands K-major (row-major, k contiguous): A is the batch of
// inputs, B the weights in torch's (out, in) layout or the NAP rotation
// packed as V^T.  Each caller keeps the output tile in registers and runs its
// own epilogue on it: csrc/fused_mlp.cu (bias, LeakyReLU, BN) and
// csrc/nap_score.cu (standardize, square, row sum).  Two mainloops:
//
// fp32 on the CUDA cores (`SimtTile`, `simt_gemm`).  True fp32 FMA, no TF32.
//   * 256 threads; warps 4 (M) x 2 (N), lanes 4 (M) x 8 (N), each thread a
//     TM x TN register tile at rows ty + 4 i and columns tx + 8 q of its
//     warp's tile.  128 x 128 blocks (TM = TN = 8) for large batches, 64 x 64
//     (TM = TN = 4) for small ones.
//   * A ring of STAGES shared-memory stages, each BK = 32 deep, filled by
//     16-byte cp.async copies that keep the operands' K-major layout (no
//     transposing store); the next stages' copies fly while this stage's
//     FMAs run.  Rows are padded to 36 floats, so every float4 read of a
//     warp (4 distinct A rows, 8 distinct B rows, the rest broadcast) hits
//     distinct banks.
//   * Ragged M, N and K: copies of rows past the edge, and bytes past K, are
//     zero-filled by cp.async's source size, so the caller pads nothing but
//     the row stride (a multiple of 4 floats, 16-byte aligned rows).
//   * Summation order is part of the golden contract (whitening amplifies
//     rounding ~2e6): with TWO_LEVEL each 32-deep stage is summed in its own
//     FMA chain in k order and added once into the running total (the FC
//     kernel); without it, one FMA chain over all of K in k order (the NAP
//     kernel).  Both are fixed, so results are bit-identical run to run.
//
// bf16 on the tensor cores (`WgmmaTile`, `wgmma_gemm`).  fp32 accumulation.
//   * One producer warp issues TMA loads of 64-deep A and B boxes (128-byte
//     swizzle) into a ring of STAGES shared-memory stages guarded by
//     full/empty mbarriers; CONSUMERS warpgroups, 64 rows each, run
//     wgmma.mma_async m64nBNk16 on the stages that have landed, keep one
//     stage's products in flight while they wait for the next, and keep
//     the accumulators in registers, where the epilogue reads them in place.
//   * A_PARTS > 1 sums several bf16 parts of A (the NAP kernel's hi and lo
//     halves) against one B box per stage, so B is read once for all.
//   * TMA needs 16-byte aligned bases and row strides: the caller pads each
//     row to a multiple of 8 bf16.  Boxes past M, N or K are zero-filled by
//     the TMA unit (the tensor map's extent is the logical one).
//   * The descriptors are built on the host with cuTensorMapEncodeTiled,
//     taken through cudaGetDriverEntryPoint so that the library does not
//     link libcuda, and passed as __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace sm90 {

// ----------------------------------------------------------------------------
// fp32 on the CUDA cores
// ----------------------------------------------------------------------------

template <int TM_, int TN_, int STAGES_, bool TWO_LEVEL_>
struct SimtTile {
  static constexpr int TM = TM_, TN = TN_, STAGES = STAGES_;
  static constexpr bool TWO_LEVEL = TWO_LEVEL_;
  static constexpr int WM = 4, WN = 2;          // warps along M and N
  static constexpr int THREADS = 32 * WM * WN;  // 256
  static constexpr int BM = WM * 4 * TM;        // rows of A per block
  static constexpr int BN = WN * 8 * TN;        // rows of B per block
  static constexpr int WARP_N = 8 * TN;         // columns of one warp
  static constexpr int BK = 32;                 // depth of one stage
  static constexpr int LDS = BK + 4;            // floats per shared row
  static constexpr int STAGE_FLOATS = (BM + BN) * LDS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
};

// This thread's place in the block tile: acc[i][q] sits at block row
// `row0 + 4 i` and block column `col0 + 8 q`; lanes with the same `ty` share
// rows, and `tx` runs over the 8 lanes of one row.
struct SimtCoord {
  int warp_m, warp_n, ty, tx;
  template <class T>
  __device__ __forceinline__ static SimtCoord of(int tid) {
    const int warp = tid / 32, lane = tid % 32;
    return {warp / T::WN, warp % T::WN, lane / 8, lane % 8};
  }
  template <class T>
  __device__ __forceinline__ int row(int i) const {
    return warp_m * 4 * T::TM + ty + 4 * i;
  }
  template <class T>
  __device__ __forceinline__ int col(int q) const {
    return warp_n * T::WARP_N + tx + 8 * q;
  }
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One ROWS x BK slab of a K-major operand into shared rows of LDS floats:
// rows at or past `rows`, and columns at or past K, are zero-filled.
template <class T, int ROWS>
__device__ __forceinline__ void simt_load(float* dst, const float* src,
                                          int ld, int rows, int k0, int K) {
  static_assert((ROWS * T::BK / 4) % T::THREADS == 0, "tile/threads");
#pragma unroll
  for (int it = 0; it < ROWS * T::BK / 4 / T::THREADS; ++it) {
    const int e = threadIdx.x + it * T::THREADS;
    const int r = e / (T::BK / 4), c = 4 * (e % (T::BK / 4));
    const int k = k0 + c;
    const float* g = src;
    int bytes = 0;
    if (r < rows && k < K) {
      g = src + static_cast<size_t>(r) * ld + k;
      bytes = min(16, 4 * (K - k));
    }
    cp_async16(dst + r * T::LDS + c, g, bytes);
  }
}

// acc = A[m0:m0+BM, :K] @ B[n0:n0+BN, :K]^T for this thread's TM x TN
// outputs.  A (M, K) and B (N, K) are fp32 with row strides lda and ldb
// (multiples of 4, rows 16-byte aligned); smem holds T::SMEM_BYTES.
template <class T>
__device__ __forceinline__ void simt_gemm(const float* __restrict__ A,
                                          int lda,
                                          const float* __restrict__ B,
                                          int ldb, int M, int N, int K,
                                          int m0, int n0, float* smem,
                                          float (&acc)[T::TM][T::TN]) {
  const SimtCoord c = SimtCoord::of<T>(threadIdx.x);
  const float* a_src = A + static_cast<size_t>(m0) * lda;
  const float* b_src = B + static_cast<size_t>(n0) * ldb;
  const int nk = (K + T::BK - 1) / T::BK;
  auto stage_a = [&](int s) { return smem + s * T::STAGE_FLOATS; };
  auto stage_b = [&](int s) {
    return smem + s * T::STAGE_FLOATS + T::BM * T::LDS;
  };
  auto load = [&](int kt) {
    const int s = kt % T::STAGES;
    simt_load<T, T::BM>(stage_a(s), a_src, lda, M - m0, kt * T::BK, K);
    simt_load<T, T::BN>(stage_b(s), b_src, ldb, N - n0, kt * T::BK, K);
  };

#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int q = 0; q < T::TN; ++q) acc[i][q] = 0.f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // this thread's copies of stage kt have landed; the barrier makes
    // everyone's visible and frees the stage read in the last iteration
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    if (kt + T::STAGES - 1 < nk) load(kt + T::STAGES - 1);
    cp_async_commit();

    const float* as = stage_a(kt % T::STAGES) + c.row<T>(0) * T::LDS;
    const float* bs = stage_b(kt % T::STAGES) + c.col<T>(0) * T::LDS;
    float part[T::TM][T::TN];
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int q = 0; q < T::TN; ++q) part[i][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 4) {
      float4 b[T::TN];
#pragma unroll
      for (int q = 0; q < T::TN; ++q)
        b[q] = *reinterpret_cast<const float4*>(bs + 8 * q * T::LDS + kk);
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(as + 4 * i * T::LDS + kk);
#pragma unroll
        for (int q = 0; q < T::TN; ++q) {
          float& d = T::TWO_LEVEL ? part[i][q] : acc[i][q];
          d = fmaf(a.x, b[q].x, d);
          d = fmaf(a.y, b[q].y, d);
          d = fmaf(a.z, b[q].z, d);
          d = fmaf(a.w, b[q].w, d);
        }
      }
    }
    if (T::TWO_LEVEL) {
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int q = 0; q < T::TN; ++q)
          acc[i][q] = __fadd_rn(acc[i][q], part[i][q]);
    }
  }
  cp_async_wait<0>();
}

// ----------------------------------------------------------------------------
// bf16 on the tensor cores: TMA + mbarrier ring + wgmma
// ----------------------------------------------------------------------------

template <int CONSUMERS_, int BN_, int STAGES_, int A_PARTS_ = 1>
struct WgmmaTile {
  static constexpr int CONSUMERS = CONSUMERS_;  // warpgroups, 64 rows each
  static constexpr int BM = 64 * CONSUMERS, BN = BN_, BK = 64;
  static constexpr int STAGES = STAGES_;
  // A_PARTS A boxes against each B box: the product sums A_PARTS bf16
  // parts of A, part p at column offset p * a_part_k of the A matrix
  static constexpr int A_PARTS = A_PARTS_;
  static constexpr int PRODUCER_WARP = 4 * CONSUMERS;
  static constexpr int THREADS = 128 * CONSUMERS + 32;
  static constexpr int ACC = BN / 2;  // fp32 accumulators per thread
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_PARTS * A_BYTES + B_BYTES;
  // stages, 1 KB of slack to align them to the swizzle's 1 KB period, and
  // the full/empty barriers
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 16 * STAGES;
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma width");
};

// Where accumulator r of this consumer thread sits in its warpgroup's
// 64 x BN tile (the m64nNk16 fp32 fragment): r and r ^ 1 are neighbouring
// columns of one row, r ^ 2 the same columns 8 rows down.
__device__ __forceinline__ int wgmma_row(int r, int t) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((r / 2) % 2);
}
__device__ __forceinline__ int wgmma_col(int r, int t) {
  return 8 * (r / 4) + 2 * (t % 4) + (r % 2);
}

template <int N>
struct Wgmma;
// D (64 x N, fp32) += A (64 x 16) @ B (N x 16)^T, both bf16 and K-major in
// shared memory with the 128-byte swizzle, named by descriptors.
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// Shared-memory matrix descriptor of a K-major bf16 tile whose 128-byte
// rows carry the TMA's 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// One box of a 2-D tensor map at (k, row) into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row)
      : "memory");
}

// acc = sum_p A[m0:m0+BM, p*a_part_k : p*a_part_k + K] @ B[n0:n0+BN, :K]^T
// over the T::A_PARTS parts p, through the tensor cores, for the 64 x BN
// tile of this thread's consumer warpgroup.  Returns false on the producer
// warp, which has no outputs; only consumers run the epilogue.  smem holds
// T::SMEM_BYTES of dynamic shared memory.  With more than one part, A boxes
// may run past column K of a part into the next: B's tensor map ends at K,
// so those columns meet zeros.  a_part_k is a multiple of T::BK: box loads
// that start off that grid faulted on the card.
template <class T>
__device__ __forceinline__ bool wgmma_gemm(const CUtensorMap* map_a,
                                           const CUtensorMap* map_b, int K,
                                           int a_part_k, int m0, int n0,
                                           unsigned char* smem_raw,
                                           float (&acc)[T::ACC]) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES *
                                               T::STAGE_BYTES);
  uint64_t* empty = full + T::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = (K + T::BK - 1) / T::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * T::CONSUMERS);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == T::PRODUCER_WARP) {
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % T::STAGES;
        mbar_wait(&empty[s], ((kt / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE_BYTES);
        unsigned char* st = smem + s * T::STAGE_BYTES;
        for (int p = 0; p < T::A_PARTS; ++p)
          tma_load(st + p * T::A_BYTES, map_a, &full[s],
                   p * a_part_k + kt * T::BK, m0);
        tma_load(st + T::A_PARTS * T::A_BYTES, map_b, &full[s], kt * T::BK,
                 n0);
      }
    }
    return false;
  }

  const int wg = warp / 4;
#pragma unroll
  for (int r = 0; r < T::ACC; ++r) acc[r] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % T::STAGES;
    mbar_wait(&full[s], (kt / T::STAGES) & 1);
    const unsigned char* a = smem + s * T::STAGE_BYTES + wg * 64 * 128;
    const unsigned char* b = smem + s * T::STAGE_BYTES + T::A_PARTS * T::A_BYTES;
#pragma unroll
    for (int r = 0; r < T::ACC; ++r) asm volatile("" : "+f"(acc[r])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int p = 0; p < T::A_PARTS; ++p)
#pragma unroll
      for (int k16 = 0; k16 < T::BK / 16; ++k16)
        Wgmma<T::BN>::mma(acc, smem_desc(a + p * T::A_BYTES + 32 * k16),
                          smem_desc(b + 32 * k16));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // keep this stage's products in flight; the ones before have finished
    // reading their stage, which goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < T::ACC; ++r) asm volatile("" : "+f"(acc[r])::"memory");
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % T::STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int r = 0; r < T::ACC; ++r) asm volatile("" : "+f"(acc[r])::"memory");
  return true;
}

// ----------------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a (rows, cols) bf16 matrix with row stride `ld` elements,
// read in boxes of box_rows x 64 with the 128-byte swizzle; reads past rows
// or cols fill zeros.  Returns false if the driver refuses it.
inline bool tma_map_bf16(CUtensorMap* map, const void* ptr, int rows,
                         int cols, int ld, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Allow `kernel` the dynamic shared memory it asks for above 48 KB.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace sm90
