// Lane gather for Hopper (sm_90a): out[i] = table[idx[i]].
//
// Replaces the g7 Pallas probe of tools/gather_bench.py (its kernel at
// :234-236, launched by g7 at :238 through the pallas_call at :246). The
// TPU version streams idx/out in blocks of 4096 and keeps the whole
// 128x512 f32 LUT (256 KB) resident in VMEM, so every lookup is an
// on-chip dynamic index.
//
// On Hopper a block has at most 227 KB of shared memory, so the 256 KB
// table does not fit. It does not need to: the table is read through the
// read-only path (__ldg) and stays resident in the 50 MB L2 after the
// first touches, so the random lookups cost L2 (not HBM) traffic. What is
// left to stream is idx in and out back, both coalesced: thread t of a
// block takes samples base + t + k * THREADS for k < PER_THREAD, so each
// warp's loads and stores hit consecutive addresses.
//
// Bound on the H100: bytes. 4 B of idx + 4 B of out per sample + the
// table once: 4S + 4S + 262,144 B (16.26 MB at S = 1,999,872, 4.85 us at
// 3.35 TB/s); no arithmetic to speak of. At that size one launch is of
// the order of the launch overhead itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int PER_BLOCK = THREADS * PER_THREAD;

__global__ void __launch_bounds__(THREADS)
lane_gather_kernel(const float* __restrict__ table,
                   const int* __restrict__ idx,
                   float* __restrict__ out, int64_t n) {
  const int64_t base = (int64_t)blockIdx.x * PER_BLOCK + threadIdx.x;
  int lane_idx[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {  // all index loads in flight first
    const int64_t i = base + (int64_t)k * THREADS;
    lane_idx[k] = i < n ? __ldg(idx + i) : 0;
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int64_t i = base + (int64_t)k * THREADS;
    if (i < n) out[i] = __ldg(table + lane_idx[k]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). The caller has checked that
// every index lies in [0, table size). Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() of the launch.
extern "C" int szg_lane_gather(const float* table, const int* idx, float* out,
                               long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + PER_BLOCK - 1) / PER_BLOCK;
    lane_gather_kernel<<<(unsigned)blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(table, idx, out,
                                                               (int64_t)n);
  }
  return (int)cudaGetLastError();
}
