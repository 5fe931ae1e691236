// Time stamps inside the small-batch kernels, for
// scripts/torch_small_kernel_probe.py.  A build with -DSMALL_PROBE makes
// thread 0 of every block record (%globaltimer, tag, aux) at each
// PROBE_MARK into a buffer the probe hands over with small_probe_arm; the
// libraries the port loads are built without it, and there every mark
// compiles to nothing.
//
// Tags: 1 entry, 2 a ring stage ready (aux: its index), 3 before a grid
// sync, 4 after it (aux: the sync's index, or the layer's), 5 exit.

#pragma once

#ifdef SMALL_PROBE

#include <cuda_runtime.h>

namespace probe {
__device__ unsigned long long* g_buf = nullptr;
__device__ int g_per_block = 0;

__device__ __forceinline__ void mark(int& n, int tag, int aux) {
  if (threadIdx.x == 0 && g_buf != nullptr && n < g_per_block) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const size_t i = (static_cast<size_t>(blockIdx.x) * g_per_block + n) * 2;
    g_buf[i] = t;
    g_buf[i + 1] = static_cast<unsigned long long>(tag) |
                   (static_cast<unsigned long long>(aux) << 8);
  }
  ++n;
}

__global__ void stamp_kernel(unsigned long long* out) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = t;
}
}  // namespace probe

#define PROBE_DECL int probe_n = 0
#define PROBE_MARK(tag, aux) probe::mark(probe_n, (tag), (aux))

extern "C" {
// Record up to per_block marks per block into buf (blocks x per_block x 2
// u64, zeroed by the caller); a null buf stops recording.
int small_probe_arm(void* buf, int per_block) {
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  cudaError_t err = cudaMemcpyToSymbol(probe::g_buf, &p, sizeof(p));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(probe::g_per_block, &per_block, sizeof(int));
  return static_cast<int>(err);
}
// One thread writes %globaltimer to out on `stream` when it runs.
int small_probe_stamp(void* out, void* stream) {
  probe::stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
}

#else

#define PROBE_DECL
#define PROBE_MARK(tag, aux) ((void)0)

#endif
