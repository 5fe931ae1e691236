// The robot tick's front end for Hopper (sm_90a): one window batch's native
// sensor payloads to fused (B, 1728) fp32 windows in one launch, the
// fixed-range normalization and the fusion projection's convs of
// ops/fusion.py (`normalize_mods`, then `fuse(sensor="All")`):
//
//   RGB   (B,32,32,3) HWC, [0, 255] -> [-1, 1] -> conv 3->16 k2 s2 -> conv
//         16->16 k3 p1 -> conv 16->16 k2 s2, each + bias, ReLU -> cols 0-1023
//   depth (B,1,32,32),  [0, 255] -> [-1, 1] -> the same with 1->8->8->8
//         channels                                         -> cols 1024-1535
//   force (B,1),        [0, 400] -> [-1, 1], broadcast to 8 x 8 -> 1536-1599
//   mic   (B,1,13) MFCC frames, by the batch's min and max -> [-1, 1] ->
//         conv1d 1->8 k18 s9 p9 -> conv1d 8->16 k2 s2, each + bias, ReLU,
//         (16) as (2, 8) broadcast along the last axis     -> cols 1600-1727
//
// every block of columns channel-major, as `fuse` flattens them.
//
// It replaces no TPU kernel: the JAX package's front end is plain jnp,
// which XLA fuses into the tick's program.  Eagerly, or captured in a CUDA
// graph, the same work in stock PyTorch is about 45 kernels at B = 10 (the
// HWC -> CHW copy, the casts, four elementwise ops a normalization, the
// mic's amin, amax and difference, eight cuDNN convolutions with their
// bias adds and ReLUs, the broadcast copies, the cat): 0.091 ms of device
// time a tick on the H100, and a gap between every two of the graph's
// nodes, for ~18 MFLOP and ~130 KB, whose bound is under 1 us (0.26 us of
// fp32 operations at 67 TFLOP/s, 0.04 us of bytes at 3.35 TB/s).
//
// What bounds it here is latency: each branch is a chain of three
// dependent convolutions over a few thousand outputs, and at B = 10 one
// block a window would leave most of the card idle while each block works
// through its chain alone (one block per RGB window: 25.6 us on the H100,
// L2 cold).
//   * Blocks by window, branch and tile: blocks [0, 4B) each take a
//     quarter of a window's RGB branch (4 x 4 of its 8 x 8 output plane),
//     [4B, 5B) a window's whole depth branch (the same work as an RGB
//     quarter), and each of the last ceil(B / MIC_GROUP) blocks the force
//     and mic columns of MIC_GROUP windows: 51 blocks at B = 10.
//   * A tile carries its halo: a quarter's conv1 tile is 10 x 10 (its 8 x
//     8 conv2 tile and one row and column each side), read from a 20 x 20
//     input tile; halo positions past the image's edge hold 0, the
//     padding, so the convolutions need no bounds checks.
//   * A mic block first takes the whole batch's min and max
//     (NaN-propagating, as torch.amin and amax are): MIC_GROUP windows a
//     block keep that read from growing as B^2 at large batches.  Min and
//     max are exact in any order, so every block, at any B, finds the same
//     two values.
//   * Every block first brings what it reads into shared memory at once:
//     its payload tile (normalized on load), its convs' weights, repacked
//     to (ci, kh, kw, co), and biases; then each convolution reads and
//     writes shared memory alone, the last one its columns of the output
//     row.  A thread computes one output position for a group of output
//     channels: one load of each input value, broadcast 16-byte loads of
//     the weights, an fmaf chain an output in (ci, kh, kw) order from 0,
//     then + bias, then ReLU as `v < 0 ? 0 : v`, which keeps NaN as
//     torch.relu does (a constant mic batch gives NaN columns, as the
//     stock path does).
//   * The normalization happens on load, in norm_minmax_global's own
//     order, (out_hi - out_lo) * (v - lo) / (hi - lo) + out_lo, each step
//     correctly rounded (__fsub_rn and friends; IEEE division): the
//     numbers of the stock path on the CPU.  On the card the stock path
//     multiplies by the reciprocal of a Python scalar divisor (255, 400),
//     so its normalized pixels and force may differ from these by an ulp.
//     The camera's HWC bytes are read directly: no permute copy, no cast.
//   * Plain fp32 FMAs on the CUDA cores: no TF32, no tensor cores.  No
//     atomics: every launch gives the same bits, so a captured tick is bit
//     for bit its eager twin.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
// windows whose force and mic columns one block writes
constexpr int MIC_GROUP = 32;
constexpr int FEAT = 1728;
constexpr int N_MFCC = 13;
// the first column of each branch (the mic's follow the force's)
constexpr int RGB_COL = 0, DEPTH_COL = 1024, FORCE_COL = 1536;
// RGB tiles a side: a window's RGB branch is T_RGB^2 blocks
constexpr int T_RGB = 2;

// the fusion convs' weights and biases, in this order
enum Conv { RGB1, RGB2, RGB3, DEP1, DEP2, DEP3, LID1, LID2, N_CONV };

struct Params {
  const void* r;  // (B, 32, 32, 3) uint8 or fp32
  const void* d;  // (B, 1, 32, 32) uint8 or fp32
  const float* t;  // (B, 1)
  const float* m;  // (B, 1, 13)
  const float* w[N_CONV];  // OIHW / OIH, contiguous
  const float* b[N_CONV];
  float* out;  // (B, 1728)
  int B;
  int r_u8;
  int d_u8;
};

// A camera branch's tile of C input channels and F features, T tiles a
// side: its conv3 tile (H3 x H3), conv2 tile (H2 x H2), conv1 tile with
// its halo (H1 x H1) and input tile (HI x HI), and the floats of shared
// memory it takes (the weights first, 16-byte aligned).
template <int C, int F, int T>
struct Tile {
  static constexpr int H3 = 8 / T, H2 = 16 / T, H1 = H2 + 2, HI = 2 * H1;
  static constexpr int W1 = C * 4 * F, W2 = F * 9 * F, W3 = F * 4 * F;
  static constexpr int FLOATS = W1 + W2 + W3 + 3 * F + C * HI * HI
                                + F * H1 * H1 + F * H2 * H2;
};

// the force and mic block's shared memory: the reduction's partials, the
// lid convs' weights and biases, the group's frames and force, and its
// two conv outputs
constexpr int MIC_FLOATS = 64 + 8 * 18 + 16 * 8 * 2 + 8 + 16
                           + MIC_GROUP * (N_MFCC + 1 + 16 + 16);
constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
constexpr int SMEM_FLOATS = max3(Tile<3, 16, T_RGB>::FLOATS,
                                 Tile<1, 8, 1>::FLOATS, MIC_FLOATS);

// norm_minmax_global onto [-1, 1], its operations one by one:
// 2 * (v - lo) / den - 1 with den = hi - lo
__device__ __forceinline__ float norm(float v, float lo, float den) {
  return __fadd_rn(__fdiv_rn(__fmul_rn(2.0f, __fsub_rn(v, lo)), den), -1.0f);
}

__device__ __forceinline__ float payload(const void* p, int u8, long long i) {
  return u8 ? static_cast<float>(static_cast<const uint8_t*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// OIHW weights (CO, CI, K, K) into wt as (CI, K, K, CO), and the bias.
template <int CI, int CO, int K>
__device__ void repack(const float* w, const float* b, float* wt,
                       float* bias) {
  constexpr int TAPS = CI * K * K;
  for (int i = threadIdx.x; i < CO * TAPS; i += THREADS)
    wt[(i % TAPS) * CO + i / TAPS] = w[i];
  for (int i = threadIdx.x; i < CO; i += THREADS) bias[i] = b[i];
}

// One conv over a tile in shared memory, bias and ReLU fused: output (i, j)
// of HO x HO reads in[ci][S i + kh][S j + kw] of the (CI, HIN, HIN) tile,
// whose padding is in place; store(co, i, j, v) takes each output.  A
// work item is an output position and CG of the CO channels.
template <int CI, int CO, int K, int S, int HIN, int HO, int CG,
          class Store>
__device__ void conv(const float* in, const float* wt, const float* bias,
                     Store store) {
  static_assert(CO % CG == 0 && CG % 4 == 0, "16-byte weight loads");
  constexpr int N = HO * HO;
  for (int it = threadIdx.x; it < N * (CO / CG); it += THREADS) {
    const int pos = it % N, c0 = it / N * CG;
    const float* at = in + (S * (pos / HO)) * HIN + S * (pos % HO);
    float acc[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[c] = 0.0f;
    for (int ci = 0; ci < CI; ++ci) {
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float x = at[(ci * HIN + kh) * HIN + kw];
          const float4* w4 = reinterpret_cast<const float4*>(
              wt + ((ci * K + kh) * K + kw) * CO + c0);
#pragma unroll
          for (int q = 0; q < CG / 4; ++q) {
            const float4 v = w4[q];
            acc[4 * q] = fmaf(x, v.x, acc[4 * q]);
            acc[4 * q + 1] = fmaf(x, v.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(x, v.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(x, v.w, acc[4 * q + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CG; ++c)
      store(c0 + c, pos / HO, pos % HO,
            relu(__fadd_rn(acc[c], bias[c0 + c])));
  }
}

// Tile `tile` (row-major of T x T) of window b's camera branch: (C, 32,
// 32) -> (F, 16, 16) -> (F, 16, 16) -> (F, 8, 8), its conv3 tile into the
// branch's columns of the window's row; the payload is HWC (C channels
// interleaved), normalized from [0, 255] on load.  CG1 and CG2: conv1's
// and conv2's channels a work item.
template <int C, int F, int T, int CG1, int CG2>
__device__ void camera_tile(const void* src, int u8, int b, int tile,
                            const float* const* w, const float* const* bs,
                            float* out_row, float* sm) {
  using L = Tile<C, F, T>;
  constexpr int H1 = L::H1, H2 = L::H2, H3 = L::H3, HI = L::HI;
  float* w1 = sm;
  float* w2 = w1 + L::W1;
  float* w3 = w2 + L::W2;
  float* bias = w3 + L::W3;
  float* x = bias + 3 * F;      // the input tile, (C, HI, HI)
  float* y1 = x + C * HI * HI;  // conv1's, with its halo, (F, H1, H1)
  float* y2 = y1 + F * H1 * H1;  // conv2's, (F, H2, H2)
  repack<C, F, 2>(w[0], bs[0], w1, bias);
  repack<F, F, 3>(w[1], bs[1], w2, bias + F);
  repack<F, F, 2>(w[2], bs[2], w3, bias + 2 * F);
  const int ty = tile / T, tx = tile % T;
  // the conv1 tile's first row and column in the (16, 16) plane; the
  // input tile's are twice them
  const int r1 = H2 * ty - 1, c1 = H2 * tx - 1;
  const long long base = static_cast<long long>(b) * C * 1024;
  for (int i = threadIdx.x; i < C * HI * HI; i += THREADS) {
    const int gy = 2 * r1 + i / HI % HI, gx = 2 * c1 + i % HI;
    x[i] = gy >= 0 && gy < 32 && gx >= 0 && gx < 32
               ? norm(payload(src, u8, base + (gy * 32 + gx) * C
                                           + i / (HI * HI)),
                      0.0f, 255.0f)
               : 0.0f;
  }
  __syncthreads();
  conv<C, F, 2, 2, HI, H1, CG1>(x, w1, bias, [&](int co, int i, int j,
                                                  float v) {
    const bool inside = r1 + i >= 0 && r1 + i < 16 && c1 + j >= 0
                        && c1 + j < 16;
    y1[(co * H1 + i) * H1 + j] = inside ? v : 0.0f;  // conv2's padding
  });
  __syncthreads();
  conv<F, F, 3, 1, H1, H2, CG2>(y1, w2, bias + F, [&](int co, int i, int j,
                                                      float v) {
    y2[(co * H2 + i) * H2 + j] = v;
  });
  __syncthreads();
  conv<F, F, 2, 2, H2, H3, 4>(y2, w3, bias + 2 * F,
                              [&](int co, int i, int j, float v) {
                                out_row[co * 64 + (H3 * ty + i) * 8
                                        + H3 * tx + j] = v;
                              });
}

// torch.amin / amax semantics: NaN wins
__device__ __forceinline__ float lo_of(float a, float b) {
  return a != a ? a : (b != b || b < a ? b : a);
}
__device__ __forceinline__ float hi_of(float a, float b) {
  return a != a ? a : (b != b || b > a ? b : a);
}

// The force and mic columns of windows [b0, b0 + MIC_GROUP).
__device__ void force_mic_block(const Params& p, int b0, float* sm) {
  const int n = min(MIC_GROUP, p.B - b0);
  float* red = sm;                  // 2 x 32 partials
  float* w1 = red + 64;             // lid1 (8, 1, 18)
  float* w2 = w1 + 8 * 18;          // lid2 (16, 8, 2)
  float* b1 = w2 + 16 * 8 * 2;
  float* b2 = b1 + 8;
  float* mg = b2 + 16;              // the group's frames, (n, 13)
  float* tg = mg + MIC_GROUP * N_MFCC;  // its force, (n)
  float* z = tg + MIC_GROUP;        // conv1's outputs, (n, 8, 2)
  float* y = z + MIC_GROUP * 16;    // conv2's, (n, 16)
  for (int i = threadIdx.x; i < 8 * 18; i += THREADS) w1[i] = p.w[LID1][i];
  for (int i = threadIdx.x; i < 16 * 8 * 2; i += THREADS)
    w2[i] = p.w[LID2][i];
  for (int i = threadIdx.x; i < 8; i += THREADS) b1[i] = p.b[LID1][i];
  for (int i = threadIdx.x; i < 16; i += THREADS) b2[i] = p.b[LID2][i];
  const float* m0 = p.m + static_cast<long long>(b0) * N_MFCC;
  for (int i = threadIdx.x; i < n * N_MFCC; i += THREADS) mg[i] = m0[i];
  for (int i = threadIdx.x; i < n; i += THREADS) tg[i] = p.t[b0 + i];
  // the whole batch's min and max over its B x 13 frames
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (long long i = threadIdx.x; i < static_cast<long long>(p.B) * N_MFCC;
       i += THREADS) {
    lo = lo_of(lo, p.m[i]);
    hi = hi_of(hi, p.m[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = lo_of(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = hi_of(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (threadIdx.x % 32 == 0) {
    red[threadIdx.x / 32] = lo;
    red[32 + threadIdx.x / 32] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[32];
  for (int k = 1; k < THREADS / 32; ++k) {
    lo = lo_of(lo, red[k]);
    hi = hi_of(hi, red[32 + k]);
  }
  const float den = __fsub_rn(hi, lo);
  // conv1d 1 -> 8, k 18, stride 9, padding 9: two outputs a channel
  for (int it = threadIdx.x; it < n * 16; it += THREADS) {
    const int win = it / 16, co = it % 16 / 2, j = it % 2;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 18; ++k) {
      const int i = j * 9 - 9 + k;
      if (i >= 0 && i < N_MFCC)
        acc = fmaf(norm(mg[win * N_MFCC + i], lo, den), w1[co * 18 + k], acc);
    }
    z[it] = relu(__fadd_rn(acc, b1[co]));
  }
  __syncthreads();
  // conv1d 8 -> 16, k 2, stride 2: one output a channel
  for (int it = threadIdx.x; it < n * 16; it += THREADS) {
    const int win = it / 16, co = it % 16;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k)  // (ci, tap) in order
      acc = fmaf(z[win * 16 + k], w2[co * 16 + k], acc);
    y[it] = relu(__fadd_rn(acc, b2[co]));
  }
  __syncthreads();
  // force: one value over its 8 x 8 plane; mic: channel c (of 16) over
  // row c of the (2, 8, 8) planes
  for (int it = threadIdx.x; it < n * 192; it += THREADS) {
    const int win = it / 192, col = it % 192;
    p.out[(b0 + win) * static_cast<long long>(FEAT) + FORCE_COL + col] =
        col < 64 ? norm(tg[win], 0.0f, 400.0f) : y[win * 16 + (col - 64) / 8];
  }
}

__global__ void __launch_bounds__(THREADS) frontend_fuse_kernel(Params p) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  constexpr int RGB_TILES = T_RGB * T_RGB;
  const int blk = blockIdx.x;
  if (blk < RGB_TILES * p.B) {
    const int b = blk / RGB_TILES;
    camera_tile<3, 16, T_RGB, 8, 4>(
        p.r, p.r_u8, b, blk % RGB_TILES, p.w + RGB1, p.b + RGB1,
        p.out + static_cast<long long>(b) * FEAT + RGB_COL, sm);
  } else if (blk < (RGB_TILES + 1) * p.B) {
    const int b = blk - RGB_TILES * p.B;
    camera_tile<1, 8, 1, 8, 8>(
        p.d, p.d_u8, b, 0, p.w + DEP1, p.b + DEP1,
        p.out + static_cast<long long>(b) * FEAT + DEPTH_COL, sm);
  } else {
    force_mic_block(p, (blk - (RGB_TILES + 1) * p.B) * MIC_GROUP, sm);
  }
}

}  // namespace

extern "C" {

// r (B, 32, 32, 3) and d (B, 1, 32, 32), each uint8 (r_u8, d_u8 = 1) or
// fp32, t (B, 1) and m (B, 1, 13) fp32, out (B, 1728) fp32, all contiguous
// on the current device; params: the 16 device pointers of the fusion
// weights and biases, w then b of rgb1, rgb2, rgb3, dep1, dep2, dep3, lid1,
// lid2, each contiguous fp32.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for B < 1 or a grid past the card's limit).
int frontend_fuse(const void* r, int r_u8, const void* d, int d_u8,
                  const float* t, const float* m, const void* const* params,
                  float* out, int B, void* stream) {
  if (B < 1 || B > (1 << 28)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.r = r;
  p.d = d;
  p.t = t;
  p.m = m;
  for (int i = 0; i < N_CONV; ++i) {
    p.w[i] = static_cast<const float*>(params[2 * i]);
    p.b[i] = static_cast<const float*>(params[2 * i + 1]);
  }
  p.out = out;
  p.B = B;
  p.r_u8 = r_u8;
  p.d_u8 = d_u8;
  const int grid = (T_RGB * T_RGB + 1) * B + (B + MIC_GROUP - 1) / MIC_GROUP;
  frontend_fuse_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

const char* frontend_fuse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
