// The 5x5 PCF shadow lookup (kernels/lighting.py::compute_shadow_frame and
// sample_shadow_map), shared by the lighting and the sky pass: one pixel's
// shadow frame in a light's map, then its 25 NEAREST taps, clamp-to-border
// 0, reverse-Z test.
//
// Taps read the f32 map, rounded to f16 with `f16` (the plain version
// rounds the map), or, with `codes` given (pcf_q8 at <= 2048 texels),
// decode the u8 segment tables that kernels/lighting.py::_q8_segments
// makes: the tap row's one segment that holds all five taps, its tap
// lo + code * step, rounded after the product and after the sum. A tap's
// index is the int64 conversion of floor((v + oy * dv) * size); at 8192^2
// texels one ulp of a tap coordinate can move a tap.
#pragma once

#include <cuda_fp16.h>

#include "f32.h"

namespace szg {

// the q8 segments (kernels/lighting.py::_q8_segments): a map row zero-padded
// by kPcfPad on the left, cut into kSegment-texel segments at stride 8
constexpr long long kPcfPad = 8;
constexpr long long kSegment = 16;

// A stack of (size, size) maps, and their q8 segments when codes is given
struct PcfMaps {
  const float* maps;  // (slots, size, size)
  const __half* codes;  // (slots, size, n_w, kSegment) q8 codes, or null
  const float* lo;  // (slots, size, n_w) segment minima, f16-rounded
  const float* step;  // (slots, size, n_w) segment steps, f16-rounded
  int size, f16, n_w;
};

struct ShadowFrame {
  float u, v, depth, dx, dy;
};

// computeShadowFrame (compute_shadow_frame): the 4x4 row-major matrix m
// (to-texture x projection x view) over [position, 1] and [normal, 0],
// each row summed as matvec's (p0 + p1) + (p2 + p3)
__device__ __forceinline__ ShadowFrame shadow_frame(const float* m, const float* x, const float* n) {
  float c[4];
  for (int r = 0; r < 4; ++r) {
    const float* row = m + 4 * r;
    c[r] = add(add(mul(row[0], x[0]), mul(row[1], x[1])), add(mul(row[2], x[2]), mul(row[3], 1.0f)));
  }
  constexpr float kMinW = static_cast<float>(1e-8);
  const float w = fabsf(c[3]) < kMinW ? kMinW : c[3];
  float pn[2];
  for (int r = 0; r < 2; ++r) {
    const float* row = m + 4 * r;
    pn[r] = add(add(mul(row[0], n[0]), mul(row[1], n[1])), add(mul(row[2], n[2]), mul(row[3], 0.0f)));
  }
  ShadowFrame f;
  f.u = div(c[0], w);
  f.v = div(c[1], w);
  f.depth = div(c[2], w);
  f.dx = __fsqrt_rn(sub(1.0f, clamp01(mul(pn[0], pn[0]))));
  f.dy = __fsqrt_rn(sub(1.0f, clamp01(mul(pn[1], pn[1]))));
  return f;
}

// floor(v / 8) for any sign, as torch.div(rounding_mode="floor")
__device__ __forceinline__ long long floor_div8(long long v) { return (v - (v < 0 ? 7 : 0)) / 8; }

// sampleShadowMap (_pcf_taps) in map `slot`: 1 - occluded taps / 25 (a
// tensor divided by 25 is multiplied by the f32 reciprocal); kQ8: the taps
// decoded from the q8 segments
template <bool kQ8>
__device__ __forceinline__ float pcf(const PcfMaps& p, int slot, const ShadowFrame& f) {
  constexpr float kInv25 = 1.0f / 25.0f;
  const int size = p.size;
  const float fsize = static_cast<float>(size);
  const float inv_size = div(1.0f, fsize);
  const float du = mul(mul(1.5f, f.dx), inv_size);
  const float dv = mul(mul(1.5f, f.dy), inv_size);
  long long ix[5];
  for (int k = 0; k < 5; ++k) {
    ix[k] = static_cast<long long>(floorf(mul(add(f.u, mul(du, static_cast<float>(k - 2))), fsize)));
  }
  const float* map = p.maps + static_cast<size_t>(slot) * size * size;
  const long long segments = static_cast<long long>(slot) * size * p.n_w;  // the slot's first segment
  long long w = 0;  // q8: the segment column that holds the leftmost tap
  if (kQ8) {
    const long long start = static_cast<long long>(floorf(mul(f.u, fsize))) - 3 + kPcfPad;
    w = min(max(floor_div8(start), 0LL), static_cast<long long>(p.n_w - 1));
  }
  float occluded = 0.0f;
  for (int oy = -2; oy <= 2; ++oy) {
    const long long iy = static_cast<long long>(floorf(mul(add(f.v, mul(dv, static_cast<float>(oy))), fsize)));
    if (iy < 0 || iy >= size) continue;  // every tap of the row reads 0
    const long long seg = segments + iy * p.n_w + w;
    for (int k = 0; k < 5; ++k) {
      if (ix[k] < 0 || ix[k] >= size) continue;
      float t;
      if (kQ8) {
        const long long c = min(max(ix[k] + kPcfPad - 8 * w, 0LL), kSegment - 1);  // the tap's channel
        t = add(__ldg(p.lo + seg), mul(__half2float(p.codes[seg * kSegment + c]), __ldg(p.step + seg)));
      } else {
        t = __ldg(map + iy * size + ix[k]);
        if (p.f16) t = __half2float(__float2half_rn(t));
      }
      if (t > 0.0f && t > f.depth) occluded = add(occluded, 1.0f);
    }
  }
  return sub(1.0f, mul(occluded, kInv25));
}

}  // namespace szg
