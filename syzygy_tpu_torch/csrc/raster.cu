// Visibility / shadow-depth rasterizer for Hopper (sm_90a).
//
// Replaces the four Pallas raster calls of syzygy_tpu/kernels/raster.py:
//   K1 rasterize_listed(depth_only=False) -> _raster_kernel_listed (:1014)
//   K2 rasterize_listed(depth_only=True)  -> kernel_depth          (:1005)
//   K3 rasterize(depth_only=False)        -> _raster_kernel        (:808)
//   K4 rasterize(depth_only=True)         -> kernel_depth          (:799)
// K1/K3 and K2/K4 compute the same function of the triangle setup; they
// differ only in how the TPU walks coefficient chunks under its scalar
// prefetch budget. Here the host builds EXACT per-tile slot lists
// (kernels/raster.py::bin_triangles), so one kernel, templated on
// DEPTH_ONLY, covers all four and no list can overflow.
//
// Semantics (the reference's serial _chunk_loop, raster.py:542-562): one
// CTA per 64x128 tile walks its list in ascending slot order; per pixel
//   b0 = a0 + be0*px + g0*py,  b1 = a1 + be1*px + g1*py,  b2 = 1 - b0 - b1,
//   z  = z2 + dz0*b0 + dz1*b1,
// a hit needs every b >= 0, z >= depth, 0 <= z <= 1 and valid > 0 (so the
// later slot wins a depth tie). px/py are GLOBAL pixel centers: local
// position + origin + 0.5, all exact in f32. Contraction is explicit: the
// build passes --fmad=false, and the fused multiply-adds sit exactly where
// the reference's default (vector) raster has them on the CPU,
//   b0 = fma(be0, px, a0) + g0*py,  z = fma(dz1, b1, fma(dz0, b0, z2)),
// written with __fmaf_rn/__fmul_rn/__fadd_rn/__fsub_rn. The plain torch
// version evaluates the same expression (its fma in float64, rounded once),
// so ids/depths/barycentrics agree with it and with the reference.
//
// What bounds it on the H100: per-pixel work is (list length) x 16 FLOPs
// for every pixel of the tile, so large triangles in long lists make it
// ALU-bound (every listed triangle is evaluated over all 8192 pixels of
// its tile); for the 254k-triangle dense field the host-side binning
// (count, scan, sort of (tile, slot) pairs) and the per-pixel evaluation
// of many small triangles dominate. The design keeps each thread's 16
// pixels in one column, so fma(be0, px, a0) is computed once per triangle
// per thread and only the g0*py term per pixel; coefficient rows are staged
// through shared memory in batches and read as broadcasts. Finer tiles,
// per-triangle pixel bounds and a device-side binning are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr int THREADS = 512;
constexpr int ROWS_PER_PASS = THREADS / TILE_W;       // 4
constexpr int PX_PER_THREAD = TILE_H / ROWS_PER_PASS;  // 16
constexpr int BATCH = 256;                             // slots staged per pass
constexpr int COEFF_WIDTH = 12;
constexpr int USED = 10;  // a0 be0 g0 a1 be1 g1 z2 dz0 dz1 valid

template <bool DEPTH_ONLY>
__global__ void __launch_bounds__(THREADS)
raster_kernel(const float* __restrict__ coeffs,
              const int* __restrict__ slots,
              const int* __restrict__ offsets,
              int tiles_x, int width, int oy, int ox,
              float* __restrict__ depth_out,
              int* __restrict__ tri_out,
              float* __restrict__ b0_out,
              float* __restrict__ b1_out) {
  __shared__ float s_coeff[BATCH * USED];
  __shared__ int s_slot[BATCH];

  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int col = threadIdx.x % TILE_W;
  const int row0 = threadIdx.x / TILE_W;

  const int gx = tx * TILE_W + col;
  const float px = (float)(gx + ox) + 0.5f;  // exact: small integer + 0.5
  float py[PX_PER_THREAD];
  float depth[PX_PER_THREAD];
  int tri[PX_PER_THREAD];
  float bb0[PX_PER_THREAD];
  float bb1[PX_PER_THREAD];
#pragma unroll
  for (int k = 0; k < PX_PER_THREAD; ++k) {
    py[k] = (float)(ty * TILE_H + row0 + k * ROWS_PER_PASS + oy) + 0.5f;
    depth[k] = 0.0f;
    tri[k] = -1;
    bb0[k] = 0.0f;
    bb1[k] = 0.0f;
  }

  const int begin = offsets[tile];
  const int end = offsets[tile + 1];
  for (int base = begin; base < end; base += BATCH) {
    const int n = min(BATCH, end - base);
    __syncthreads();  // previous batch fully consumed
    for (int i = threadIdx.x; i < n * USED; i += THREADS) {
      const int s = i / USED;
      const int c = i - s * USED;
      s_coeff[i] = coeffs[(int64_t)slots[base + s] * COEFF_WIDTH + c];
    }
    for (int i = threadIdx.x; i < n; i += THREADS) s_slot[i] = slots[base + i];
    __syncthreads();

    for (int s = 0; s < n; ++s) {
      const float* c = s_coeff + s * USED;
      if (!(c[9] > 0.0f)) continue;  // invalid slot: never a hit
      const float a0 = __fmaf_rn(c[1], px, c[0]);  // per thread: one column
      const float g0 = c[2];
      const float a1 = __fmaf_rn(c[4], px, c[3]);
      const float g1 = c[5];
      const float z2 = c[6], dz0 = c[7], dz1 = c[8];
      const int slot = s_slot[s];
#pragma unroll
      for (int k = 0; k < PX_PER_THREAD; ++k) {
        const float e0 = __fadd_rn(a0, __fmul_rn(g0, py[k]));
        const float e1 = __fadd_rn(a1, __fmul_rn(g1, py[k]));
        const float e2 = __fsub_rn(__fsub_rn(1.0f, e0), e1);
        const float z = __fmaf_rn(dz1, e1, __fmaf_rn(dz0, e0, z2));
        const bool hit = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f) &
                         (z >= depth[k]) & (z <= 1.0f) & (z >= 0.0f);
        if (hit) {
          depth[k] = z;
          if (!DEPTH_ONLY) {
            tri[k] = slot;
            bb0[k] = e0;
            bb1[k] = e1;
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PX_PER_THREAD; ++k) {
    const int64_t idx = (int64_t)(ty * TILE_H + row0 + k * ROWS_PER_PASS) * width + gx;
    depth_out[idx] = depth[k];
    if (!DEPTH_ONLY) {
      tri_out[idx] = tri[k];
      b0_out[idx] = bb0[k];
      b1_out[idx] = bb1[k];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() of the launch.
extern "C" int szg_raster(const float* coeffs, const int* slots,
                          const int* offsets, int tiles_y, int tiles_x,
                          int oy, int ox, int depth_only, float* depth,
                          int* tri, float* b0, float* b1, void* stream) {
  const dim3 grid(tiles_y * tiles_x);
  const int width = tiles_x * TILE_W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid.x > 0) {
    if (depth_only) {
      raster_kernel<true><<<grid, THREADS, 0, s>>>(
          coeffs, slots, offsets, tiles_x, width, oy, ox, depth, tri, b0, b1);
    } else {
      raster_kernel<false><<<grid, THREADS, 0, s>>>(
          coeffs, slots, offsets, tiles_x, width, oy, ox, depth, tri, b0, b1);
    }
  }
  return (int)cudaGetLastError();
}
