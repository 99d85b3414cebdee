// Deferred lighting of a row block (sm_90a): every live light slot's 5x5
// PCF shadow lookup and PBR BRDF, for each pixel, in one pass.
//
// Replaces no TPU kernel: the JAX package computes the lighting as XLA
// tensor operations (syzygy_tpu/kernels/lighting.py::deferred_lighting), and
// the port's plain version (kernels/lighting.py::deferred_lighting_plain)
// does the same over whole-frame tensors: 2 directional and 16 spot slots,
// each evaluated over every pixel and kept under a device mask, so a frame
// pays for all 18 whatever the scene lights.
//
// One thread owns one pixel of the (rows, W) target, keeping every
// intermediate in registers. A background pixel (diffuse alpha < 1) writes
// 0 and does nothing else. The masks of light_activity stay on the device;
// each thread reads them (uniform across the launch, so no divergence) and
// evaluates only the live slots, in the plain version's order: shadowed
// directionals, then the unshadowed ones (shadowless_eps > 0), then spots.
// A skipped slot leaves the sum as where(active, total + c, total) does.
// Each pixel notes the slots it evaluated in a bit mask; a warp ORs its
// lanes' masks, a block its warps' in shared memory, and one thread a
// block ORs that into `slots` (zeroed before the launch): bit k is set
// when some pixel evaluated slot k, so a frame without a lit pixel reads 0
// whatever the masks say.
//
// Bound: bytes. A lit pixel reads 5 G-buffer planes of 16 B and writes
// 12 B, a background pixel reads its diffuse texel and writes 12 B; each
// live slot adds 25 taps, neighbours in one shadow map, which the
// neighbouring pixels of a warp share through L1 and L2.
//
// Taps read the f32 map, rounded to f16 with `f16` (the plain version
// rounds the map), or, with `codes` given (pcf_q8 at <= 2048 texels),
// decode the u8 segment tables that kernels/lighting.py::_q8_segments
// makes: the tap row's one segment that holds all five taps, its tap
// lo + code * step, rounded after the product and after the sum.
//
// Bitwise the plain version on the card. Each operation rounds as the
// PyTorch CUDA operation it stands for, and this file is built with
// --fmad=false, so nothing is contracted into a fused multiply-add:
// - every product, sum and quotient is __fmul_rn/__fadd_rn/__fsub_rn/
//   __fdiv_rn in the plain version's order; matvec's (p0 + p1) + (p2 + p3);
// - torch.sum over a last axis of 3 runs on two threads of a reduction, so
//   it takes (a0 + a2) + a1;
// - a tensor divided by a Python number is multiplied by the number's f32
//   reciprocal (PyTorch's div_true for a CPU scalar): 1/25, 1/pi, 1/size;
// - sqrt_rn is the correctly rounded __fsqrt_rn; torch.pow calls powf;
// - torch.clamp passes NaN through; a tap's index is the int64 conversion
//   of floor((v + oy * dv) * size).
// At 8192^2 texels one ulp of a tap coordinate can move a tap.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "launch.h"

namespace {

constexpr int kThreads = 256;
// a light slot's row of the table (kernels/lighting.py::light_table)
constexpr int kStride = 32;
constexpr int kShadowFrame = 0;  // 4x4, row-major: to-texture x projection x view
constexpr int kDirection = 16;  // normalized -forward
constexpr int kSpectral = 19;  // color x strength
constexpr int kPosition = 22;  // spots
constexpr int kFalloffFactor = 25;
constexpr int kFalloffDistance = 26;

// Python numbers as PyTorch casts them to f32
constexpr float kEps = static_cast<float>(1e-20);  // _normalize
constexpr float kMinFalloff = static_cast<float>(1e-8);
constexpr float kMinMetallic = static_cast<float>(1e-8);
constexpr float kMinW = static_cast<float>(1e-8);
constexpr float kDielectricF0 = static_cast<float>(0.04);
constexpr float kSpecularPowerBase = static_cast<float>(160.0);
constexpr float kInvPi = 1.0f / static_cast<float>(3.14159265359);
constexpr float kInv25 = 1.0f / 25.0f;
// the q8 segments (kernels/lighting.py::_q8_segments): a map row zero-padded
// by kPcfPad on the left, cut into kSegment-texel segments at stride 8
constexpr long long kPcfPad = 8;
constexpr long long kSegment = 16;

struct Params {
  const float4* diffuse;  // the G-buffer planes, (n, 4) each
  const float4* specular;
  const float4* normal;
  const float4* position;
  const float4* orm;
  const float* camera;  // the camera's world position, 3 floats
  const float* table;  // (n_dir + n_spot, kStride)
  const bool* shadowed;  // (n_dir,)
  const bool* unshadowed;  // (n_dir,)
  const bool* spots;  // (n_spot,)
  const float* maps;  // (n_dir + n_spot, size, size)
  const __half* codes;  // (n_dir + n_spot, size, n_w, kSegment) q8 codes, or null
  const float* lo;  // (n_dir + n_spot, size, n_w) segment minima, f16-rounded
  const float* step;  // (n_dir + n_spot, size, n_w) segment steps, f16-rounded
  const float* sun_shadow;  // (n,) directional 0's PCF, or null
  float* out;  // (n, 3)
  unsigned long long* slots;  // bit k: some pixel evaluated slot k
  long long n;
  int n_dir, n_spot, shadowless, size, f16, n_w;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float sum3(float a0, float a1, float a2) { return add(add(a0, a2), a1); }

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return sum3(mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2]));
}

__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

__device__ __forceinline__ float clamp01(float v) { return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f); }

// torch.amax: NaN wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// _normalize
__device__ __forceinline__ void normalize3(const float* v, float* out) {
  const float len = __fsqrt_rn(clamp_min(dot3(v, v), kEps));
  for (int c = 0; c < 3; ++c) out[c] = div(v[c], len);
}

struct Material {
  float position[3], normal[3], color[3], f0[3];
  float occlusion, spec_power;
};

// convertPBRProperties (convert_pbr)
__device__ __forceinline__ Material material_at(const Params& p, long long i, float4 diffuse) {
  const float4 spec = p.specular[i], nrm = p.normal[i], pos = p.position[i], orm = p.orm[i];
  Material m;
  m.position[0] = pos.x, m.position[1] = pos.y, m.position[2] = pos.z;
  m.normal[0] = nrm.x, m.normal[1] = nrm.y, m.normal[2] = nrm.z;
  m.color[0] = diffuse.x, m.color[1] = diffuse.y, m.color[2] = diffuse.z;
  const float s[3] = {spec.x, spec.y, spec.z};
  const float den = clamp_min(max_nan(max_nan(s[0], s[1]), s[2]), kMinMetallic);
  const float metallic = orm.z;
  const float dielectric = mul(kDielectricF0, sub(1.0f, metallic));
  for (int c = 0; c < 3; ++c) m.f0[c] = add(dielectric, mul(div(mul(0.5f, s[c]), den), metallic));
  m.occlusion = orm.x;
  m.spec_power = powf(kSpecularPowerBase, sub(1.0f, orm.y));
  return m;
}

struct ShadowFrame {
  float u, v, depth, dx, dy;
};

// computeShadowFrame (compute_shadow_frame): matvec over [p, 1] and [n, 0]
__device__ __forceinline__ ShadowFrame shadow_frame(const float* m, const Material& mat) {
  const float* x = mat.position;
  const float* n = mat.normal;
  float c[4];
  for (int r = 0; r < 4; ++r) {
    const float* row = m + 4 * r;
    c[r] = add(add(mul(row[0], x[0]), mul(row[1], x[1])), add(mul(row[2], x[2]), mul(row[3], 1.0f)));
  }
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

// sampleShadowMap (_pcf_taps): 25 NEAREST taps of slot `slot`'s map,
// clamp-to-border 0, reverse-Z test; kQ8: decoded from the q8 segments
template <bool kQ8>
__device__ __forceinline__ float pcf(const Params& p, int slot, const ShadowFrame& f) {
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

// computeLightContribution (_light_contribution), added to `total`
__device__ __forceinline__ void accumulate(const Material& mat, const float* view, const float* light,
                                           const float* spectral, float* total) {
  float h[3];
  for (int c = 0; c < 3; ++c) h[c] = add(light[c], view[c]);
  float halfway[3];
  normalize3(h, halfway);
  const float schlick = powf(sub(1.0f, clamp01(dot3(halfway, light))), 5.0f);
  const float hn = clamp01(dot3(halfway, mat.normal));
  const float specular = mul(mul(add(mat.spec_power, 2.0f), 0.125f), powf(hn, mat.spec_power));
  const float nl = clamp01(dot3(mat.normal, light));
  for (int c = 0; c < 3; ++c) {
    const float fresnel = add(mat.f0[c], mul(sub(1.0f, mat.f0[c]), schlick));
    const float brdf = add(mul(mul(mat.color[c], kInvPi), sub(1.0f, fresnel)), mul(specular, fresnel));
    total[c] = add(total[c], mul(mul(mul(mat.occlusion, brdf), spectral[c]), nl));
  }
}

__device__ __forceinline__ void directional(const Params& p, const Material& mat, const float* view, int slot,
                                            float shadow, float* total) {
  const float* row = p.table + slot * kStride;
  float spectral[3];
  for (int c = 0; c < 3; ++c) spectral[c] = mul(__ldg(row + kSpectral + c), shadow);
  float light[3];
  for (int c = 0; c < 3; ++c) light[c] = __ldg(row + kDirection + c);
  accumulate(mat, view, light, spectral, total);
}

// Pixel i's lighting, written to out; returns the slots it evaluated
template <bool kQ8>
__device__ __forceinline__ unsigned long long shade(const Params& p, long long i) {
  float* out = p.out + 3 * i;
  const float4 diffuse = p.diffuse[i];
  if (!(diffuse.w >= 1.0f)) {  // background: the final where's 0
    out[0] = out[1] = out[2] = 0.0f;
    return 0;
  }
  const Material mat = material_at(p, i, diffuse);
  float to_camera[3];
  for (int c = 0; c < 3; ++c) to_camera[c] = sub(__ldg(p.camera + c), mat.position[c]);
  float view[3];
  normalize3(to_camera, view);
  float total[3] = {0.0f, 0.0f, 0.0f};
  unsigned long long seen = 0;

  for (int d = 0; d < p.n_dir; ++d) {
    if (!p.shadowed[d]) continue;
    float shadow;
    if (d == 0 && p.sun_shadow != nullptr) {
      shadow = p.sun_shadow[i];
    } else {
      shadow = pcf<kQ8>(p, d, shadow_frame(p.table + d * kStride + kShadowFrame, mat));
    }
    directional(p, mat, view, d, shadow, total);
    seen |= 1ull << d;
  }
  if (p.shadowless) {
    for (int d = 0; d < p.n_dir; ++d) {
      if (!p.unshadowed[d]) continue;
      directional(p, mat, view, d, 1.0f, total);
      seen |= 1ull << d;
    }
  }
  for (int j = 0; j < p.n_spot; ++j) {
    if (!p.spots[j]) continue;
    const int slot = p.n_dir + j;
    const float* row = p.table + slot * kStride;
    const ShadowFrame f = shadow_frame(row + kShadowFrame, mat);
    const float shadow = pcf<kQ8>(p, slot, f);
    // quadratic falloff and UV edge softening (lights.comp:73-91)
    float to_light[3];
    for (int c = 0; c < 3; ++c) to_light[c] = sub(__ldg(row + kPosition + c), mat.position[c]);
    const float norm_dist = div(__fsqrt_rn(dot3(to_light, to_light)), __ldg(row + kFalloffDistance));
    const float falloff = clamp_min(mul(mul(__ldg(row + kFalloffFactor), norm_dist), norm_dist), kMinFalloff);
    const float cu = sub(f.u, 0.5f), cv = sub(f.v, 0.5f);
    const float uv_dist = clamp01(mul(__fsqrt_rn(add(mul(cu, cu), mul(cv, cv))), 2.0f));
    const float edge = sub(1.0f, mul(uv_dist, uv_dist));
    float spectral[3], light[3];
    for (int c = 0; c < 3; ++c) {
      spectral[c] = mul(mul(div(__ldg(row + kSpectral + c), falloff), edge), shadow);
      light[c] = __ldg(row + kDirection + c);
    }
    accumulate(mat, view, light, spectral, total);
    seen |= 1ull << slot;
  }
  out[0] = total[0], out[1] = total[1], out[2] = total[2];
  return seen;
}

// one instance a tap format, so that the f32 taps pay no register for q8
template <bool kQ8>
__global__ void __launch_bounds__(kThreads) lighting_kernel(const Params p) {
  __shared__ unsigned long long block_seen;
  if (threadIdx.x == 0) block_seen = 0;
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const unsigned long long seen = i < p.n ? shade<kQ8>(p, i) : 0;
  // every thread of the block gets here: kThreads is whole warps
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(seen));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(seen >> 32));
  const unsigned long long warp_seen = (static_cast<unsigned long long>(hi) << 32) | lo;
  if ((threadIdx.x & 31) == 0 && warp_seen != 0) atomicOr(&block_seen, warp_seen);
  __syncthreads();
  if (threadIdx.x == 0 && block_seen != 0) atomicOr(p.slots, block_seen);
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a CUDA error, 0 when the
// launch succeeded. Zeroes `slots` and launches on `stream` of `device`;
// allocates nothing. `codes`, `lo` and `step` are all null or all given.
extern "C" int szg_lighting(const void* diffuse, const void* specular, const void* normal, const void* position,
                            const void* orm, const float* camera, const float* table, const bool* shadowed,
                            const bool* unshadowed, const bool* spots, int n_dir, int n_spot, int shadowless,
                            const float* maps, int size, int f16, const void* codes, const float* lo,
                            const float* step, int n_w, const float* sun_shadow, float* out,
                            unsigned long long* slots, long long n, int device, void* stream) {
  if (n < 0 || n_dir < 0 || n_spot < 0 || n_dir + n_spot > 64 || size <= 0 || slots == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (codes != nullptr && (lo == nullptr || step == nullptr || n_w <= 0)) return (int)cudaErrorInvalidValue;
  if (!szg::valid_device(device)) return (int)cudaErrorInvalidDevice;
  szg::DeviceScope scope(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(slots, 0, sizeof(*slots), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  Params p{static_cast<const float4*>(diffuse), static_cast<const float4*>(specular),
           static_cast<const float4*>(normal), static_cast<const float4*>(position),
           static_cast<const float4*>(orm), camera, table, shadowed, unshadowed, spots, maps,
           static_cast<const __half*>(codes), lo, step, sun_shadow, out, slots, n, n_dir, n_spot, shadowless,
           size, f16, n_w};
  const long long blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  if (codes != nullptr) {
    lighting_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  } else {
    lighting_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
