// Lane gather for Hopper (sm_90a): out[i] = table[idx[i]].
//
// Replaces the g7 Pallas probe of tools/gather_bench.py (its kernel at
// :234-236, launched by g7 at :238 through the pallas_call at :246). The
// TPU version streams idx/out in blocks of 4096 and keeps the whole
// 128x512 f32 LUT (256 KB) resident in VMEM, so every lookup is an
// on-chip dynamic index.
//
// Bound on the H100: bytes. 4 B of idx + 4 B of out per sample + the
// table once: 4S + 4S + 262,144 B (16.26 MB at S = 1,999,872, 4.85 us at
// 3.35 TB/s; 268.7 MB at S = 33,554,432, 80.2 us); no arithmetic to speak
// of.
//
// Design. A block has at most 227 KB of shared memory, so the 256 KB
// table cannot sit in one. A cluster of 2 CTAs holds one half of it each
// (128 KB of dynamic shared memory, staged once), and each CTA serves
// only the lookups into its own half, from its own shared memory: both
// CTAs read every index of the chunks the pair walks (the second read
// hits L2, the pair runs side by side) and each writes the samples of its
// half (coalesced 4-byte stores that L2 merges into whole sectors). No
// lookup leaves the SM. The grid is persistent, one pair per two SMs.
// Indices and samples move as scalars, so any view of int32 indices
// serves. Tables of up to 2 x 227 KB; kernels/gather.py refuses larger
// ones. Two other designs measured slower on the H100 and went (PERF.md):
// the table read through L1/L2 with 16-byte index loads (1.39x this
// design's device time at 2.0 M samples, 1.30x at 33.6 M), and the table
// in distributed shared memory, half of the lookups crossing to the
// partner SM (slower than the L1/L2 design at both sizes).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.h"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 2;
constexpr int THREADS = 1024;
constexpr int UNROLL = 4;         // index loads per thread in flight
constexpr int MAX_SMEM = 232448;  // a block's shared memory on the H100 (227 KB)

// Copies table[first, first + count) into `part`, 16 bytes at a time
// where the table is 16-byte aligned (`first` is a multiple of 4).
__device__ __forceinline__ void stage_half(float* part, const float* __restrict__ table, int first,
                                           int count) {
  const float* src = table + first;
  int done = 0;
  if ((uintptr_t)src % 16 == 0) {
    for (int i = threadIdx.x; i < count / 4; i += blockDim.x) {
      reinterpret_cast<float4*>(part)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
    }
    done = count / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) part[i] = __ldg(src + i);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
lane_gather_split(const float* __restrict__ table, int half, int table_n,
                  const int* __restrict__ idx, float* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) float part[];  // table[first, first + count)
  const int first = (int)cg::this_cluster().block_rank() * half;
  const int count = min(half, table_n - first);
  stage_half(part, table, first, count);
  __syncthreads();
  const int64_t pair = blockIdx.x / CLUSTER, pairs = gridDim.x / CLUSTER;
  const int64_t step = pairs * THREADS * UNROLL;
  for (int64_t i0 = pair * THREADS * UNROLL + threadIdx.x; i0 < n; i0 += step) {
    int lane_idx[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {  // cached in L2 alone: the partner reads them too
      const int64_t i = i0 + (int64_t)u * THREADS;
      lane_idx[u] = i < n ? __ldcg(idx + i) : first - 1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned j = (unsigned)(lane_idx[u] - first);
      if (j < (unsigned)count) __stcs(out + i0 + (int64_t)u * THREADS, part[j]);
    }
  }
}

int sm_count(int device) {
  static int cached[szg::MAX_DEVICES] = {};
  if (!cached[device]) cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
  return cached[device];
}

// Elements of one CTA's half: half the table, rounded up to 16 bytes.
long long half_of(long long table_n) { return ((table_n + 1) / 2 + 3) / 4 * 4; }

}  // namespace

// Plain C entry point (bound with ctypes). The caller has checked that
// every index lies in [0, table_n). Refuses (cudaErrorInvalidValue) a
// table whose halves do not fit two CTAs' shared memory. Launches on
// `stream` of `device`, allocates nothing, and returns the launch's CUDA
// error (0 when it was accepted).
extern "C" int szg_lane_gather(const float* table, long long table_n, const int* idx, float* out,
                               long long n, int device, void* stream) {
  if (n <= 0) return 0;
  if (!szg::valid_device(device)) return (int)cudaErrorInvalidDevice;
  const long long half = half_of(table_n);
  if (table_n <= 0 || half * (long long)sizeof(float) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  szg::DeviceScope scope(device);
  static szg::SharedMemoryOptIn opt_in;
  const cudaError_t err = opt_in.ensure(lane_gather_split, MAX_SMEM, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t pairs_needed = (n + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const int64_t pairs_cap = sm_count(device) / CLUSTER;
  const int64_t pairs = pairs_needed < pairs_cap ? pairs_needed : pairs_cap;
  lane_gather_split<<<(unsigned)(pairs * CLUSTER), THREADS, (size_t)half * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(table, (int)half, (int)table_n, idx, out, n);
  return (int)cudaGetLastError();
}
