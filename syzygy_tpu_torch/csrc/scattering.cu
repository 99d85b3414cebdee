// The 32-step LUT-ratio in-scattering integral (sm_90a): one thread per
// ray, every step in registers.
//
// Replaces no TPU kernel: the JAX package computes the integral as XLA
// tensor operations (syzygy_tpu/kernels/atmosphere.py), and the port's
// plain version (kernels/atmosphere.py::luminance_scattering_integral_plain
// and _scattering_integral_components_plain) does the same over whole
// tensors: some 450 elementwise operations a step, each a launch of its own
// over every ray.
//
// A thread owns one ray: its origin (one shared origin, stride 0, or one a
// ray, stride 3), direction and distance. It computes the ray's set-up
// (_march_setup: the scattering direction, the origin step, the two
// origin-side transmittance samples; the phase terms), then the 32 steps
// of _march_step with the sums in registers, and writes its result once:
// the luminance, phase applied per step (kComponents false), or the
// Rayleigh and Mie parts (A_r, A_m) with the phase factored out
// (kComponents true), each in its plain version's order of accumulation.
// A ray whose step length is 0 (distance 0, as a sky pixel of the per-pixel
// pass has) takes the same step 32 times: it evaluates it once and adds
// it 32 times, in order, which is the same sum.
//
// Bound: operations. A step takes ~450 f32 operations (divisions, square
// roots and two expf among them) against 24 bytes a ray read and written;
// the transmittance LUT (512 x 128 x 3 f32, 768 KiB) is read through the
// read-only cache, the neighbouring rays of a warp sharing its footprints.
// The atmosphere's values are one small table (kernels/atmosphere.py::
// scattering_table), copied into shared memory by each block.
//
// Bitwise the plain version on the card. Each operation rounds as the
// PyTorch CUDA operation it stands for (csrc/f32.h; the LUT's samples are
// csrc/transmittance.h's, which the sky pass shares), and this file is
// built with --fmad=false, so nothing is contracted into a fused
// multiply-add. A tensor divided by a Python number is multiplied by the
// number's reciprocal, taken in f64 and rounded to f32 (PyTorch's div_true
// for a CPU scalar): 1/15, 1/32; a tensor divided by a 0-dim device tensor
// is divided; torch.exp calls expf, torch.pow powf.

#include <cuda_runtime.h>

#include "launch.h"
#include "transmittance.h"

namespace {

using namespace szg;

constexpr int kThreads = 128;
constexpr int kSteps = 32;  // SKYVIEW_SAMPLES
// the atmosphere table (kernels/atmosphere.py::scattering_table)
constexpr int kTable = 25;
constexpr int kPlanetRadius = 0;
constexpr int kAtmosphereRadius = 1;
constexpr int kScaleRayleigh = 2;
constexpr int kScaleMie = 3;
constexpr int kScatteringRayleigh = 4;  // 3 each from here on
constexpr int kAbsorptionRayleigh = 7;
constexpr int kScatteringMie = 10;
constexpr int kScatteringOzone = 13;
constexpr int kAbsorptionOzone = 16;
constexpr int kSun = 19;  // incident_direction_sun
constexpr int kSinSunRadius = 22;
constexpr int kCosSunRadius = 23;
constexpr int kSunNorm = 24;  // vec_norm(incident_direction_sun)

// Python numbers as PyTorch casts them to f32
constexpr float kMinRatio = static_cast<float>(1e-20);  // the transmittance ratios
constexpr float kMinSpan = static_cast<float>(1e-12);
constexpr float kMinAltitude = static_cast<float>(-0.001);
constexpr float kTinyStep = static_cast<float>(1e-7);
constexpr float kInv15 = 1.0f / 15.0f;
constexpr float kInvSteps = 1.0f / static_cast<float>(kSteps);
constexpr double kPi = 3.141592653589793;
constexpr double kG = 0.8;  // phase_mie's g
constexpr float kPhaseRayleigh = static_cast<float>(3.0 / (16.0 * kPi));
constexpr float kPhaseMie = static_cast<float>(3.0 / (8.0 * kPi));
constexpr float kMieNum = static_cast<float>(1.0 - kG * kG);
constexpr float kMieBase = static_cast<float>(1.0 + kG * kG);
constexpr float kMieSlope = static_cast<float>(2.0 * kG);
constexpr float kMieDen = static_cast<float>(2.0 + kG * kG);

struct Params {
  const float* origin;  // (3,) with origin_stride 0, (n, 3) with 3
  const float* direction;  // (n, 3)
  const float* distance;  // (n,)
  Transmittance lut;  // its radii set by each thread
  const float* table;  // (kTable,) the atmosphere
  float* out0;  // (n, 3): luminance, or A_r
  float* out1;  // (n, 3): A_m, components only
  long long n;
  int origin_stride;
};

// The atmosphere's values
struct Atmosphere {
  float planet_radius;
  float scale_rayleigh, scale_mie;
  float scattering_rayleigh[3], absorption_rayleigh[3], scattering_mie[3], scattering_ozone[3],
      absorption_ozone[3], sun[3];
  float sin_sun_radius, cos_sun_radius, sun_norm;
};

__device__ __forceinline__ void load_atmosphere(const float* t, Atmosphere& a) {
  a.planet_radius = t[kPlanetRadius];
  a.scale_rayleigh = t[kScaleRayleigh];
  a.scale_mie = t[kScaleMie];
  for (int c = 0; c < 3; ++c) {
    a.scattering_rayleigh[c] = t[kScatteringRayleigh + c];
    a.absorption_rayleigh[c] = t[kAbsorptionRayleigh + c];
    a.scattering_mie[c] = t[kScatteringMie + c];
    a.scattering_ozone[c] = t[kScatteringOzone + c];
    a.absorption_ozone[c] = t[kAbsorptionOzone + c];
    a.sun[c] = t[kSun + c];
  }
  a.sin_sun_radius = t[kSinSunRadius];
  a.cos_sun_radius = t[kCosSunRadius];
  a.sun_norm = t[kSunNorm];
}

// sample_transmittance_sun(lut, atmo, row.radius, cos_sun_zenith)
__device__ __forceinline__ void sample_sun(const Transmittance& lut, const Atmosphere& a, const Row& r,
                                           float cos_sun_zenith, float* out) {
  const float sin_horizon = div(a.planet_radius, r.radius);
  const float cos_horizon = -safe_sqrt(sub(1.0f, mul(sin_horizon, sin_horizon)));
  float through[3];
  sample_rmu(lut, r, cos_sun_zenith, through);
  const float edge0 = mul(-sin_horizon, a.sin_sun_radius);
  const float edge1 = mul(sin_horizon, a.sin_sun_radius);
  const float x = sub(cos_sun_zenith, mul(cos_horizon, a.cos_sun_radius));
  const float t = clamp(div(sub(x, edge0), clamp_min(sub(edge1, edge0), kMinSpan)), 0.0f, 1.0f);
  const float smooth = mul(mul(t, t), sub(3.0f, mul(t, 2.0f)));
  for (int c = 0; c < 3; ++c) out[c] = mul(through[c], smooth);
}

// sample_extinction, with its absorptionRayleigh-for-Mie slip
struct Extinction {
  float rayleigh[3], mie[3], extinction[3];
};

__device__ __forceinline__ Extinction sample_extinction(const Atmosphere& a, float altitude) {
  const float alt = clamp_min(altitude, kMinAltitude);
  const float density_rayleigh = expf(div(-alt, a.scale_rayleigh));
  const float density_mie = expf(div(-alt, a.scale_mie));
  const float altitude_km = mul(altitude, 1000.0f);
  const float density_ozone = clamp_min(sub(1.0f, mul(fabsf(sub(altitude_km, 25.0f)), kInv15)), 0.0f);
  Extinction e;
  for (int c = 0; c < 3; ++c) {
    e.rayleigh[c] = mul(a.scattering_rayleigh[c], density_rayleigh);
    const float absorption_rayleigh = mul(a.absorption_rayleigh[c], density_rayleigh);
    e.mie[c] = mul(a.scattering_mie[c], density_mie);
    const float absorption_mie = mul(a.absorption_rayleigh[c], density_mie);  // the reference's quirk
    const float scattering_ozone = mul(a.scattering_ozone[c], density_ozone);
    const float absorption_ozone = mul(a.absorption_ozone[c], density_ozone);
    e.extinction[c] = add(add(add(add(add(e.rayleigh[c], absorption_rayleigh), e.mie[c]), absorption_mie),
                              scattering_ozone), absorption_ozone);
  }
  return e;
}

// A ray's set-up (_march_setup)
struct Ray {
  float origin[3], scattering_dir[3];
  float radius, mu, mu_sun, mu_sun_step, d_sample;
  float start_up[3], start_dn[3];
  bool up;
};

// One step of the integral (_march_step): the extinction sample's Rayleigh
// and Mie scattering, t_sun, (1 - t_path) / extinction and t_begin, each a
// channel
struct Step {
  float rayleigh[3], mie[3], t_sun[3], integral[3], t_begin[3];
};

__device__ __forceinline__ Step march_step(const Transmittance& lut, const Atmosphere& a, const Ray& ray, int i) {
  const float t = mul(ray.d_sample, static_cast<float>(i));
  const float t_next = mul(ray.d_sample, static_cast<float>(i + 1));
  float begin[3], end[3];
  for (int c = 0; c < 3; ++c) {
    begin[c] = sub(ray.origin[c], mul(t, ray.scattering_dir[c]));
    end[c] = sub(ray.origin[c], mul(t_next, ray.scattering_dir[c]));
  }
  // step_radius_mu(origin_step, t)
  const float radius = safe_sqrt(add(add(mul(t, t), mul(mul(mul(ray.radius, 2.0f), ray.mu), t)),
                                     mul(ray.radius, ray.radius)));
  const float safe_radius = clamp_min(radius, kMinSpan);
  const float mu = div(add(mul(ray.radius, ray.mu), t), safe_radius);
  const float mu_sun = div(add(mul(ray.radius, ray.mu_sun), mul(t, ray.mu_sun_step)), safe_radius);
  const float altitude = sub(norm3(begin), a.planet_radius);

  Step s;
  const Row row = row_at(lut, radius);
  sample_sun(lut, a, row, mu_sun, s.t_sun);
  const Extinction e = sample_extinction(a, altitude);
  float s_end[3];
  sample_rmu(lut, row, ray.up ? mu : -mu, s_end);
  float t_path[3];
  sample_segment(lut, begin, end, t_path);
  const bool tiny = t < kTinyStep;
  for (int c = 0; c < 3; ++c) {
    const float ratio = ray.up ? div(ray.start_up[c], clamp_min(s_end[c], kMinRatio))
                               : div(s_end[c], clamp_min(ray.start_dn[c], kMinRatio));
    s.t_begin[c] = tiny ? 1.0f : clamp(ratio, 0.0f, 1.0f);
    s.integral[c] = div(sub(1.0f, t_path[c]), clamp_min(e.extinction[c], kMinSpan));
    s.rayleigh[c] = e.rayleigh[c];
    s.mie[c] = e.mie[c];
  }
  return s;
}

// The ray's set-up (_march_setup, _ray_step_setup)
__device__ __forceinline__ Ray ray_setup(const Params& p, const Transmittance& lut, const Atmosphere& a, long long i,
                                         float* direction) {
  Ray ray;
  const float* o = p.origin + i * p.origin_stride;
  for (int c = 0; c < 3; ++c) ray.origin[c] = __ldg(o + c), direction[c] = p.direction[3 * i + c];
  const float direction_norm = norm3(direction);
  for (int c = 0; c < 3; ++c) ray.scattering_dir[c] = div(-direction[c], direction_norm);
  ray.radius = norm3(ray.origin);
  ray.mu = div(dot3(ray.origin, direction), mul(ray.radius, direction_norm));
  float to_sun[3];
  for (int c = 0; c < 3; ++c) to_sun[c] = -a.sun[c];
  ray.mu_sun = div(dot3(ray.origin, to_sun), mul(ray.radius, a.sun_norm));
  ray.d_sample = mul(p.distance[i], kInvSteps);
  ray.up = ray.mu > 0.0f;
  // step_radius_mu's sun term: the same at every step
  ray.mu_sun_step = safe_sqrt(sub(mul(ray.mu_sun, ray.mu),
                                  safe_sqrt(mul(sub(1.0f, mul(ray.mu_sun, ray.mu_sun)),
                                                sub(1.0f, mul(ray.mu, ray.mu))))));
  const Row origin_row = row_at(lut, ray.radius);
  sample_rmu(lut, origin_row, ray.mu, ray.start_up);
  sample_rmu(lut, origin_row, -ray.mu, ray.start_dn);
  return ray;
}

// kComponents: (A_r, A_m) of _scattering_integral_components_plain; else
// the luminance of luminance_scattering_integral_plain
template <bool kComponents>
__global__ void __launch_bounds__(kThreads) scattering_kernel(const Params p) {
  __shared__ float table[kTable];
  if (threadIdx.x < kTable) table[threadIdx.x] = p.table[threadIdx.x];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p.n) return;
  Atmosphere a;
  load_atmosphere(table, a);
  Transmittance lut = p.lut;
  set_radii(lut, table[kPlanetRadius], table[kAtmosphereRadius]);
  float direction[3];
  const Ray ray = ray_setup(p, lut, a, i, direction);

  float phase_r = 0.0f, phase_m = 0.0f;
  if (!kComponents) {  // phase_rayleigh and phase_mie of the incident cosine
    const float cosine = dot3(a.sun, ray.scattering_dir);
    const float c2p1 = add(mul(cosine, cosine), 1.0f);
    phase_r = mul(c2p1, kPhaseRayleigh);
    const float base = clamp_min(sub(kMieBase, mul(cosine, kMieSlope)), kMinSpan);
    phase_m = div(mul(mul(c2p1, kMieNum), kPhaseMie), mul(powf(base, 1.5f), kMieDen));
  }

  const bool same = ray.d_sample == 0.0f;  // a step length of 0 makes every step the same
  float acc0[3] = {0.0f, 0.0f, 0.0f}, acc1[3] = {0.0f, 0.0f, 0.0f};
  float x0[3] = {}, x1[3] = {};
  for (int k = 0; k < kSteps; ++k) {
    if (k == 0 || !same) {
      const Step s = march_step(lut, a, ray, k);
      for (int c = 0; c < 3; ++c) {
        if (kComponents) {
          const float common = mul(mul(s.t_sun[c], s.integral[c]), s.t_begin[c]);
          x0[c] = mul(s.rayleigh[c], common);
          x1[c] = mul(s.mie[c], common);
        } else {
          const float phase_scat = add(mul(s.rayleigh[c], phase_r), mul(s.mie[c], phase_m));
          x0[c] = mul(mul(mul(phase_scat, s.t_sun[c]), s.integral[c]), s.t_begin[c]);
        }
      }
    }
    for (int c = 0; c < 3; ++c) {
      acc0[c] = add(acc0[c], x0[c]);
      if (kComponents) acc1[c] = add(acc1[c], x1[c]);
    }
  }
  for (int c = 0; c < 3; ++c) {
    p.out0[3 * i + c] = acc0[c];
    if (kComponents) p.out1[3 * i + c] = acc1[c];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a CUDA error, 0 when the
// launch succeeded. Launches on `stream` of `device`; allocates nothing.
// `components`: write (A_r, A_m) to out0 and out1; else the luminance to
// out0 (out1 unused).
extern "C" int szg_scattering(const float* origin, int origin_stride, const float* direction,
                              const float* distance, const float* lut, int lut_h, int lut_w, const float* table,
                              float* out0, float* out1, long long n, int components, int device, void* stream) {
  if (n < 0 || (origin_stride != 0 && origin_stride != 3) || lut_h <= 0 || lut_w <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (components && out1 == nullptr) return (int)cudaErrorInvalidValue;
  if (!szg::valid_device(device)) return (int)cudaErrorInvalidDevice;
  if (n == 0) return (int)cudaSuccess;
  szg::DeviceScope scope(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{origin, direction, distance, transmittance_lut(lut, lut_h, lut_w), table, out0, out1, n, origin_stride};
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (components) {
    scattering_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  } else {
    scattering_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
