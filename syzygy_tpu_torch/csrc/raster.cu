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
// Semantics (the reference's serial _chunk_loop, raster.py:542-562): per
// pixel of a 64x128 tile, over the tile's listed slots,
//   b0 = a0 + be0*px + g0*py,  b1 = a1 + be1*px + g1*py,  b2 = 1 - b0 - b1,
//   z  = z2 + dz0*b0 + dz1*b1,
// a hit needs every b >= 0, 0 <= z <= 1 and valid > 0, and the serial loop
// commits it where z >= depth in ascending slot order. px/py are GLOBAL
// pixel centres: local position + origin + 0.5, all exact in f32.
// Contraction is explicit: the build passes --fmad=false, and the fused
// multiply-adds sit exactly where the reference's default (vector) raster
// has them on the CPU,
//   b0 = fma(be0, px, a0) + g0*py,  z = fma(dz1, b1, fma(dz0, b0, z2)),
// written with __fmaf_rn/__fmul_rn/__fadd_rn/__fsub_rn. The plain torch
// version evaluates the same expression (its fma in float64, rounded once).
//
// Design. The serial loop's result needs no order: it is the covering slot
// with the largest z, the larger slot among equal z. So a hit becomes the
// 64-bit key (bits(z) << 32) | (slot + 1), with -0.0 made +0.0 so the bits
// order like the values, and keys merge by atomicMax; key 0 is background.
// The epilogue decodes the winning slot and recomputes its b0, b1 and z at
// the pixel with the same expression, so depth, id and barycentrics are
// the serial loop's bits, -0.0 included. Depth-only rasters merge the 32
// bits of z alone and write the merged bits: equal in value to the serial
// loop's depth, but where it commits a hit at z = -0.0 they write +0.0
// (the bits carry no slot to recompute z from).
//
// Work. A cluster of 8 CTAs serves one tile. A list of up to 256 pairs
// (one batch) is split by rows: each CTA rasters the whole list over its
// own 8 rows and writes them. A longer list is cut into 8 contiguous parts;
// each part's CTA merges into its own shared-memory key tile (64 KB of u64,
// 32 KB of u32), and after a cluster barrier each CTA reduces its 8 rows
// over the 8 key tiles through distributed shared memory and writes them.
// Inside a CTA, a batch of 256 pairs is staged, one per thread: the
// coefficient row and the slot's pixel box (the setup's pixel_box,
// kernels/raster.py::pixel_boxes) clipped to the CTA's rows of the tile,
// so a pair costs its box, not its tile. Small boxes (<= 128 px: most
// triangles) are flattened by a block scan of their areas into (pair,
// pixel) items that all threads share, merged with shared-memory atomics;
// a small triangle costs a few threads. Large boxes go through an owner
// pass: each thread owns one column and every other row, hoists
// fma(be0, px, a0) per column and merges without atomics. A long list's
// parts record their large pairs instead (up to 512 each), and after the
// barrier every CTA runs all of them over its own 8 rows, so a part full
// of large triangles does not hold its tile back. pixel_boxes proves that
// no hit lies outside a slot's box; slots it cannot bound tightly
// (slivers, degenerate forms) get the whole target, i.e. the whole-tile
// evaluation, through the owner pass.
//
// What bounds it on the H100: the outputs (16 B/px visibility, 4 B/px
// depth) once the tests follow the boxes; for lists of thousands of tiny
// triangles (the dense field: ~1.4 px per pair) the per-pair staging
// (a slot id, a 16-byte box and 36 B of coefficients gathered from L2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.h"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr int TILE_PX = TILE_H * TILE_W;
constexpr int CLUSTER = 8;  // CTAs per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = THREADS;  // pairs staged per pass, one per thread
constexpr int COEFF_WIDTH = 12;
constexpr int ROWS_PER_RANK = TILE_H / CLUSTER;                       // 8
constexpr int PX_PER_THREAD = ROWS_PER_RANK * TILE_W / THREADS;       // 4
constexpr int THREADS_PER_ROW = TILE_W / PX_PER_THREAD;               // 32
static_assert(PX_PER_THREAD == 4, "the epilogue stores 16-byte vectors");

constexpr int LARGE_AREA = 128;  // boxes above this many pixels take the owner pass
constexpr int LARGE_SHIFT = 20;  // scan word: small area (< 2^20) | large count << 20
static_assert(BATCH * LARGE_AREA < (1 << LARGE_SHIFT), "small areas overflow the scan word");
static_assert(THREADS == 2 * TILE_W, "the owner pass gives each thread one column, every other row");

struct alignas(16) Batch {
  float coef[9][BATCH];  // a0 be0 g0 a1 be1 g1 z2 dz0 dz1
  int slot[BATCH];
  int x0[BATCH];  // the pair's box clipped to the CTA's rows of the tile (target-local)
  int y0[BATCH];
  int w[BATCH];
  int h[BATCH];
  int start[BATCH];  // exclusive scan of the small boxes' areas
  int large[BATCH];  // the batch's large pairs, in list order
  int warp_total[WARPS];
  int total;
};

// A long list's large pairs, recorded by the part that holds them and run
// by every CTA of the cluster over its own rows: (slot, x0, w, y0 | h << 16).
constexpr int RECORD_CAP = 512;
struct alignas(16) Records {
  int4 entry[RECORD_CAP];
  int count;
};

template <bool DEPTH_ONLY>
using Key = typename std::conditional<DEPTH_ONLY, unsigned int, unsigned long long>::type;

template <bool DEPTH_ONLY>
constexpr size_t smem_bytes() {
  return TILE_PX * sizeof(Key<DEPTH_ONLY>) + sizeof(Batch) + sizeof(Records);
}

// Exclusive prefix sum of v over the block; the block's total goes to
// b.total (visible after the caller's next __syncthreads).
__device__ int block_exclusive_scan(int v, Batch& b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) b.warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += b.warp_total[w];
  if (threadIdx.x == THREADS - 1) b.total = before + incl;
  return before + incl - v;
}

struct Plane {
  float e0, e1, z;
};

// The reference's per-pixel forms, with its fused multiply-adds.
__device__ __forceinline__ Plane eval_plane(float a0, float be0, float g0, float a1,
                                            float be1, float g1, float z2, float dz0,
                                            float dz1, float px, float py) {
  Plane p;
  p.e0 = __fadd_rn(__fmaf_rn(be0, px, a0), __fmul_rn(g0, py));
  p.e1 = __fadd_rn(__fmaf_rn(be1, px, a1), __fmul_rn(g1, py));
  p.z = __fmaf_rn(dz1, p.e1, __fmaf_rn(dz0, p.e0, z2));
  return p;
}

__device__ __forceinline__ bool is_hit(float e0, float e1, float z) {
  const float e2 = __fsub_rn(__fsub_rn(1.0f, e0), e1);
  return (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f) & (z <= 1.0f) & (z >= 0.0f);
}

// The merge key of a hit: the bits of z (-0.0 made +0.0, so the bits order
// like the values), above slot + 1 unless depth only.
template <bool DEPTH_ONLY>
__device__ __forceinline__ Key<DEPTH_ONLY> make_key(float z, int slot) {
  const unsigned zbits = __float_as_uint(__fadd_rn(z, 0.0f));
  if constexpr (DEPTH_ONLY) {
    return zbits;
  } else {
    return ((unsigned long long)zbits << 32) | (unsigned)(slot + 1);
  }
}

// The owner pass of one large pair (coefficients c[9]) over the columns
// [x0, x0 + w) and tile-local rows [r_lo, r_hi): each thread tests the
// pixels it owns, one column and every other row of the tile, so it
// merges without atomics (no other thread writes them in this pass).
template <bool DEPTH_ONLY>
__device__ __forceinline__ void owner_pass(Key<DEPTH_ONLY>* keys, const float* c, int slot, int x0,
                                           int w, int r_lo, int r_hi, int tile_x0, int tile_y0,
                                           int ox, int oy) {
  const int col = threadIdx.x % TILE_W;
  const int x = tile_x0 + col;
  if (x < x0 || x >= x0 + w) return;
  const int parity = threadIdx.x / TILE_W;
  const float px = (float)(x + ox) + 0.5f;  // exact: small integer + 0.5
  const float a0 = __fmaf_rn(c[1], px, c[0]);  // eval_plane's, hoisted per column
  const float a1 = __fmaf_rn(c[4], px, c[3]);
  const float g0 = c[2], g1 = c[5], z2 = c[6], dz0 = c[7], dz1 = c[8];
  for (int r = r_lo + ((parity - r_lo) & 1); r < r_hi; r += 2) {
    const float py = (float)(tile_y0 + r + oy) + 0.5f;
    const float e0 = __fadd_rn(a0, __fmul_rn(g0, py));
    const float e1 = __fadd_rn(a1, __fmul_rn(g1, py));
    const float z = __fmaf_rn(dz1, e1, __fmaf_rn(dz0, e0, z2));
    if (is_hit(e0, e1, z)) {
      Key<DEPTH_ONLY>* dst = keys + r * TILE_W + col;
      const Key<DEPTH_ONLY> key = make_key<DEPTH_ONLY>(z, slot);
      if (key > *dst) *dst = key;
    }
  }
}

template <bool DEPTH_ONLY>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
raster_kernel(const float* __restrict__ coeffs,
              const int4* __restrict__ boxes,
              const int* __restrict__ slots,
              const int* __restrict__ offsets,
              int tiles_x, int width, int oy, int ox,
              float* __restrict__ depth_out,
              int* __restrict__ tri_out,
              float* __restrict__ b0_out,
              float* __restrict__ b1_out) {
  using K = Key<DEPTH_ONLY>;
  extern __shared__ __align__(16) unsigned char smem[];
  K* keys = reinterpret_cast<K*>(smem);
  Batch& b = *reinterpret_cast<Batch*>(smem + TILE_PX * sizeof(K));
  Records& rec = *reinterpret_cast<Records*>(smem + TILE_PX * sizeof(K) + sizeof(Batch));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / CLUSTER;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int tile_x0 = tx * TILE_W, tile_y0 = ty * TILE_H;
  const int begin = offsets[tile];
  const int len = offsets[tile + 1] - begin;  // the same in every rank of the cluster
  // A list of one batch at most is split by rows: each rank rasters all of
  // it over its own band of rows and needs no other rank's keys. A longer
  // list is split into CLUSTER parts, each over the whole tile, merged
  // through distributed shared memory.
  const bool banded = len <= BATCH;
  const int band_lo = rank * ROWS_PER_RANK, band_hi = band_lo + ROWS_PER_RANK;
  const int row_lo = banded ? band_lo : 0;  // tile-local rows this CTA rasters first
  const int row_hi = banded ? band_hi : TILE_H;
  const int lo = banded ? begin : begin + (int)((int64_t)len * rank / CLUSTER);
  const int hi = banded ? begin + len : begin + (int)((int64_t)len * (rank + 1) / CLUSTER);

  int recorded = 0;  // large pairs recorded for the cluster (uniform over the CTA)
  if (lo < hi) {
    for (int i = row_lo * TILE_W + threadIdx.x; i < row_hi * TILE_W; i += THREADS) keys[i] = 0;
    for (int base = lo; base < hi; base += BATCH) {
      const int n = min(BATCH, hi - base);
      __syncthreads();  // keys zeroed, or the previous batch consumed
      int area = 0;
      if (threadIdx.x < n) {
        const int s = slots[base + threadIdx.x];
        const int4 box = boxes[s];  // x0, x1, y0, y1, target-local, inclusive
        const int bx0 = max(box.x, tile_x0), bx1 = min(box.y, tile_x0 + TILE_W - 1);
        const int by0 = max(box.z, tile_y0 + row_lo), by1 = min(box.w, tile_y0 + row_hi - 1);
        const int w = bx1 - bx0 + 1, h = by1 - by0 + 1;
        area = (w > 0 && h > 0) ? w * h : 0;
        const float* c = coeffs + (int64_t)s * COEFF_WIDTH;
#pragma unroll
        for (int k = 0; k < 9; ++k) b.coef[k][threadIdx.x] = __ldg(c + k);
        b.slot[threadIdx.x] = s;
        b.x0[threadIdx.x] = bx0;
        b.y0[threadIdx.x] = by0;
        b.w[threadIdx.x] = w;
        b.h[threadIdx.x] = h;
      }
      const bool large = area > LARGE_AREA;
      const int prefix = block_exclusive_scan(large ? (1 << LARGE_SHIFT) : area, b);
      if (threadIdx.x < n) {
        b.start[threadIdx.x] = prefix & ((1 << LARGE_SHIFT) - 1);
        if (large) b.large[prefix >> LARGE_SHIFT] = threadIdx.x;
      }
      __syncthreads();
      const int total = b.total & ((1 << LARGE_SHIFT) - 1);
      const int n_large = b.total >> LARGE_SHIFT;

      // small boxes: the batch's (pair, pixel) items shared by all threads,
      // merged with shared-memory atomics
      for (int item = threadIdx.x; item < total; item += THREADS) {
        int j = 0, j_end = n;  // the last pair whose items start at or before `item`
        while (j_end - j > 1) {
          const int mid = (j + j_end) >> 1;
          if (b.start[mid] <= item) j = mid; else j_end = mid;
        }
        const int r = item - b.start[j];
        const int w = b.w[j];
        const int dy = r / w;
        const int x = b.x0[j] + (r - dy * w), y = b.y0[j] + dy;
        const float px = (float)(x + ox) + 0.5f;  // exact: small integer + 0.5
        const float py = (float)(y + oy) + 0.5f;
        const Plane p = eval_plane(b.coef[0][j], b.coef[1][j], b.coef[2][j], b.coef[3][j],
                                   b.coef[4][j], b.coef[5][j], b.coef[6][j], b.coef[7][j],
                                   b.coef[8][j], px, py);
        if (is_hit(p.e0, p.e1, p.z)) {
          K* dst = keys + (y - tile_y0) * TILE_W + (x - tile_x0);
          const K key = make_key<DEPTH_ONLY>(p.z, b.slot[j]);
          if (key > *dst) atomicMax(dst, key);
        }
      }

      // large boxes: a long list records them for every CTA's rows (up to
      // RECORD_CAP); the rest, and a banded list's, take the owner pass now
      const int kept = banded ? 0 : min(n_large, RECORD_CAP - recorded);
      for (int q = threadIdx.x; q < kept; q += THREADS) {
        const int j = b.large[q];
        rec.entry[recorded + q] = make_int4(b.slot[j], b.x0[j], b.w[j], b.y0[j] | (b.h[j] << 16));
      }
      recorded += kept;
      __syncthreads();  // no atomic in flight while the owner pass writes plainly
      for (int q = kept; q < n_large; ++q) {
        const int j = b.large[q];
        float c[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) c[k] = b.coef[k][j];
        owner_pass<DEPTH_ONLY>(keys, c, b.slot[j], b.x0[j], b.w[j], b.y0[j] - tile_y0,
                               b.y0[j] - tile_y0 + b.h[j], tile_x0, tile_y0, ox, oy);
      }
    }
  }

  if (banded) {
    __syncthreads();  // this CTA's keys complete
  } else {
    if (threadIdx.x == 0) rec.count = recorded;
    cluster.sync();  // every part merged and recorded
    // every part's recorded large pairs, over this CTA's own rows
    int counts[CLUSTER];
    int all = 0;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      counts[r] = cluster.map_shared_rank(&rec, r)->count;
      all += counts[r];
    }
    for (int base = 0; base < all; base += BATCH) {
      const int n = min(BATCH, all - base);
      __syncthreads();  // the previous chunk consumed
      if (threadIdx.x < n) {  // stage entry base + t: its rank's record, its coefficients
        int q = base + threadIdx.x, r = 0;
        while (q >= counts[r]) q -= counts[r++];
        const int4 e = cluster.map_shared_rank(&rec, r)->entry[q];
        const float* c = coeffs + (int64_t)e.x * COEFF_WIDTH;
#pragma unroll
        for (int k = 0; k < 9; ++k) b.coef[k][threadIdx.x] = __ldg(c + k);
        b.slot[threadIdx.x] = e.x;
        b.x0[threadIdx.x] = e.y;
        b.w[threadIdx.x] = e.z;
        b.y0[threadIdx.x] = e.w & 0xffff;
        b.h[threadIdx.x] = e.w >> 16;
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const int r_lo = max(b.y0[j] - tile_y0, band_lo);
        const int r_hi = min(b.y0[j] - tile_y0 + b.h[j], band_hi);
        if (r_lo >= r_hi) continue;
        float c[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) c[k] = b.coef[k][j];
        owner_pass<DEPTH_ONLY>(keys, c, b.slot[j], b.x0[j], b.w[j], r_lo, r_hi, tile_x0, tile_y0,
                               ox, oy);
      }
    }
    __syncthreads();  // this CTA's rows complete in its own keys
  }

  // epilogue: this rank's 8 rows, 4 consecutive pixels per thread, the max
  // over the parts' keys (over its own keys when banded; none for an empty
  // list). A part writes other ranks' rows only before the cluster barrier.
  const int lrow = band_lo + threadIdx.x / THREADS_PER_ROW;
  const int lcol = (threadIdx.x % THREADS_PER_ROW) * PX_PER_THREAD;
  K k4[PX_PER_THREAD] = {0, 0, 0, 0};
  const int sources = banded ? (len > 0 ? 1 : 0) : CLUSTER;
  for (int r = 0; r < sources; ++r) {
    const K* src = (banded ? keys : cluster.map_shared_rank(keys, r)) + lrow * TILE_W + lcol;
    if constexpr (DEPTH_ONLY) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      k4[0] = max(k4[0], (K)v.x);
      k4[1] = max(k4[1], (K)v.y);
      k4[2] = max(k4[2], (K)v.z);
      k4[3] = max(k4[3], (K)v.w);
    } else {
      const ulonglong2 v0 = reinterpret_cast<const ulonglong2*>(src)[0];
      const ulonglong2 v1 = reinterpret_cast<const ulonglong2*>(src)[1];
      k4[0] = max(k4[0], (K)v0.x);
      k4[1] = max(k4[1], (K)v0.y);
      k4[2] = max(k4[2], (K)v1.x);
      k4[3] = max(k4[3], (K)v1.y);
    }
  }
  const int64_t at = (int64_t)(tile_y0 + lrow) * width + tile_x0 + lcol;
  if constexpr (DEPTH_ONLY) {  // the merged bits: -0.0 comes out as +0.0
    *reinterpret_cast<float4*>(depth_out + at) =
        make_float4(__uint_as_float((unsigned)k4[0]), __uint_as_float((unsigned)k4[1]),
                    __uint_as_float((unsigned)k4[2]), __uint_as_float((unsigned)k4[3]));
  } else {
    float d[PX_PER_THREAD], e0[PX_PER_THREAD], e1[PX_PER_THREAD];
    int t[PX_PER_THREAD];
    const float py = (float)(tile_y0 + lrow + oy) + 0.5f;
#pragma unroll
    for (int q = 0; q < PX_PER_THREAD; ++q) {
      if (k4[q] == 0) {
        d[q] = 0.0f;
        t[q] = -1;
        e0[q] = 0.0f;
        e1[q] = 0.0f;
      } else {
        const int slot = (int)(unsigned)(k4[q] & 0xffffffffull) - 1;
        const float* c = coeffs + (int64_t)slot * COEFF_WIDTH;
        const float px = (float)(tile_x0 + lcol + q + ox) + 0.5f;
        const Plane p = eval_plane(__ldg(c + 0), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3),
                                   __ldg(c + 4), __ldg(c + 5), __ldg(c + 6), __ldg(c + 7),
                                   __ldg(c + 8), px, py);
        d[q] = p.z;
        t[q] = slot;
        e0[q] = p.e0;
        e1[q] = p.e1;
      }
    }
    *reinterpret_cast<float4*>(depth_out + at) = make_float4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<int4*>(tri_out + at) = make_int4(t[0], t[1], t[2], t[3]);
    *reinterpret_cast<float4*>(b0_out + at) = make_float4(e0[0], e0[1], e0[2], e0[3]);
    *reinterpret_cast<float4*>(b1_out + at) = make_float4(e1[0], e1[1], e1[2], e1[3]);
  }
  if (!banded) cluster.sync();  // no CTA leaves while its keys or records may be read
}

template <bool DEPTH_ONLY>
int launch(int device, dim3 grid, cudaStream_t stream, const float* coeffs, const int4* boxes,
           const int* slots, const int* offsets, int tiles_x, int width, int oy, int ox,
           float* depth, int* tri, float* b0, float* b1) {
  static szg::SharedMemoryOptIn opt_in;
  const int bytes = (int)smem_bytes<DEPTH_ONLY>();
  const cudaError_t err = opt_in.ensure(raster_kernel<DEPTH_ONLY>, bytes, device);
  if (err != cudaSuccess) return (int)err;
  raster_kernel<DEPTH_ONLY><<<grid, THREADS, bytes, stream>>>(
      coeffs, boxes, slots, offsets, tiles_x, width, oy, ox, depth, tri, b0, b1);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` of
// `device`, allocates nothing, and returns the launch's CUDA error (0 when
// it was accepted). `boxes` is the setup's (T2pad, 4) int32 pixel_box.
extern "C" int szg_raster(const float* coeffs, const int* boxes, const int* slots,
                          const int* offsets, int tiles_y, int tiles_x, int oy, int ox,
                          int depth_only, float* depth, int* tri, float* b0, float* b1,
                          int device, void* stream) {
  const int tiles = tiles_y * tiles_x;
  if (tiles <= 0) return 0;
  if (!szg::valid_device(device)) return (int)cudaErrorInvalidDevice;
  szg::DeviceScope scope(device);
  const dim3 grid(tiles * CLUSTER);
  const int width = tiles_x * TILE_W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* box4 = reinterpret_cast<const int4*>(boxes);
  if (depth_only) {
    return launch<true>(device, grid, s, coeffs, box4, slots, offsets, tiles_x, width, oy, ox,
                        depth, tri, b0, b1);
  }
  return launch<false>(device, grid, s, coeffs, box4, slots, offsets, tiles_x, width, oy, ox,
                       depth, tri, b0, b1);
}
