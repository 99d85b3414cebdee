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
// The taps (f32, f16-rounded or q8-decoded) are csrc/pcf.h's and the
// material and BRDF csrc/pbr.h's, which the sky pass shares.
//
// Bitwise the plain version on the card. Each operation rounds as the
// PyTorch CUDA operation it stands for (csrc/f32.h: the products, sums and
// quotients in the plain version's order, torch.sum over 3 as
// (a0 + a2) + a1, sqrt_rn, NaN through torch.clamp), and this file is
// built with --fmad=false, so nothing is contracted into a fused
// multiply-add. A tensor divided by a Python number is multiplied by the
// number's reciprocal, taken in f64 and rounded to f32 (PyTorch's
// div_true for a CPU scalar): 1/25, 1/pi, 1/size; torch.pow calls powf.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "launch.h"
#include "pbr.h"
#include "pcf.h"

namespace {

using namespace szg;

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
constexpr float kMinFalloff = static_cast<float>(1e-8);

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
  PcfMaps maps;  // (n_dir + n_spot) maps, one a slot
  const float* sun_shadow;  // (n,) directional 0's PCF, or null
  float* out;  // (n, 3)
  unsigned long long* slots;  // bit k: some pixel evaluated slot k
  long long n;
  int n_dir, n_spot, shadowless;
};

// computeLightContribution (_light_contribution), added to `total`
__device__ __forceinline__ void accumulate(const Material& mat, const float* view, const float* light,
                                           const float* spectral, float* total) {
  float b[3];
  brdf(mat, mat.normal, light, view, b);
  const float nl = clamp01(dot3(mat.normal, light));
  for (int c = 0; c < 3; ++c) total[c] = add(total[c], mul(mul(mul(mat.occlusion, b[c]), spectral[c]), nl));
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
  const Material mat = convert_pbr(diffuse, p.specular[i], p.normal[i], p.position[i], p.orm[i]);
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
      const float* frame = p.table + d * kStride + kShadowFrame;
      shadow = pcf<kQ8>(p.maps, d, shadow_frame(frame, mat.position, mat.normal));
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
    const ShadowFrame f = shadow_frame(row + kShadowFrame, mat.position, mat.normal);
    const float shadow = pcf<kQ8>(p.maps, slot, f);
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
           static_cast<const float4*>(orm), camera, table, shadowed, unshadowed, spots,
           szg::PcfMaps{maps, static_cast<const __half*>(codes), lo, step, size, f16, n_w}, sun_shadow, out, slots,
           n, n_dir, n_spot, shadowless};
  const long long blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  if (codes != nullptr) {
    lighting_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  } else {
    lighting_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
