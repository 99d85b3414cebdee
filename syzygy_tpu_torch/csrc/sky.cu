// The sky camera pass of the aerial-LUT formulation (sm_90a): one thread a
// pixel computes camera.comp's main (kernels/sky.py::sky_camera_pass with
// an aerial LUT) from the G-buffer, the depth and the lit colour to the
// tonemapped colour, every intermediate in registers.
//
// Replaces no TPU kernel: the JAX package computes the pass as XLA tensor
// operations (syzygy_tpu/kernels/sky.py), and the port's plain version
// (kernels/sky.py::sky_camera_pass_lut_plain) does the same over
// whole-frame tensors, some 1,250 elementwise and gather operations, each
// a launch of its own over every pixel.
//
// A pixel takes one of two branches, as the plain version's final where
// keeps one:
// - environment (no geometry, or geometry below the ground): the camera
//   ray's shared environment sample (sample_environment_shared: the planet
//   hit, the sky-view texel, the shared transmittance sample, the ground's
//   glint and the sun disk);
// - geometry: the sun's 25-tap PCF (pcf.h; or the given sun_shadow), the
//   aerial volume's trilinear sample (the implicit distance-0 slice
//   included), geometry_luminance_transfer and, with the metallic bounce,
//   the shared environment sample along the reflected ray from the
//   surface.
// Then the composite, luminance * 10 + the lit colour, and pow(..., 1.2).
// The frame's constants (the camera's matrices and position, the
// atmosphere's scalars, the sun's directions, intensity and shadow frame)
// are one small table (kernels/sky.py::sky_table), each the plain
// version's own tensor operation.
//
// Bound: bytes. A geometry pixel reads five G-buffer planes (80 B), the
// depth and the lit colour (16 B) and writes 12 B; an environment pixel
// reads the depth and one plane. The 25 PCF taps are neighbours in one
// shadow map, shared by a warp's pixels through L1 and L2; the aerial
// volume (32 x 32 x 16 x 9 f32), the transmittance LUT, the t_seg rows
// and the sky-view LUT stay in L2. The planes are read as float4, a warp's
// pixels adjacent, and nothing but the colour is written.
//
// Bitwise the plain version on the card: each operation rounds as the
// PyTorch CUDA operation it stands for (f32.h, transmittance.h, pcf.h),
// and this file is built with --fmad=false. Besides:
// - a tensor divided by a Python number is multiplied by the number's
//   reciprocal, taken in f64 and rounded to f32 (PyTorch's div_true for a
//   CPU scalar): 1/1e6, 1/pi and 1/t_max, 250 for t_max = 0.004, where the
//   f32 number's f32 reciprocal would be 249.99998; a tensor divided by a
//   tensor is divided;
// - matvec sums (p0 + p1) + (p2 + p3); camera_rays' centred coordinate is
//   (i * (1 / extent) - 0.5) in f64, rounded to f32, times 2;
// - torch.pow calls powf, torch.asin asinf, torch.acos acosf.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "launch.h"
#include "pbr.h"
#include "pcf.h"
#include "transmittance.h"

namespace {

using namespace szg;

constexpr int kThreads = 128;
// the frame's table (kernels/sky.py::sky_table)
constexpr int kInverseProjection = 0;  // 4x4 row-major
constexpr int kRotation = 16;  // 4x4 row-major
constexpr int kCamera = 32;  // the camera's position in sky space (+y up, Mm)
constexpr int kPlanetRadius = 35;
constexpr int kAtmosphereRadius = 36;
constexpr int kSun = 37;  // incident_direction_sun
constexpr int kLightProj = 40;  // (-sun.x, -sun.z), normalized: the sky-view's azimuth
constexpr int kLightDir = 42;  // _normalize(-sun)
constexpr int kToSunNorm = 45;  // vec_norm(-sun)
constexpr int kSunRadius = 46;  // sun_angular_radius
constexpr int kSpectrum = 47;  // sun_intensity_spectrum
constexpr int kShadowFrame = 50;  // 4x4 row-major: to-texture x projection x view of the sun
constexpr int kSunT0 = 66;  // the aerial LUT's t_sun0

// the sky-view LUT's storage
constexpr int kSkyF32 = 0;
constexpr int kSkyF16 = 1;
constexpr int kSkyQ8 = 2;

// Python numbers as PyTorch casts them to f32
constexpr float kPi = static_cast<float>(3.141592653589793);  // kernels/atmosphere.py::PI
constexpr float kInvMeters = static_cast<float>(1.0 / 1000000.0);  // 1 / METERS_PER_MM
constexpr float kMinSpan = static_cast<float>(1e-12);
constexpr float kGlintPower = static_cast<float>(160.0);
constexpr float kGlintScale = static_cast<float>((160.0 + 2.0) / 8.0);
constexpr float kGroundDiffuse = static_cast<float>(0.4 / 3.141592653589793);
constexpr float kGroundF0 = static_cast<float>(0.04);
constexpr float kGroundF0Rest = static_cast<float>(1.0 - 0.04);
constexpr float kSunEdge = static_cast<float>(0.2);
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
constexpr float kGamma = static_cast<float>(1.2);

struct Params {
  const float4* diffuse;  // the G-buffer planes, (n, 4) each
  const float4* specular;
  const float4* normal;
  const float4* position;
  const float4* orm;
  const float* depth;  // (n,)
  const float* color;  // (n, 3) the lit colour
  const float* sun_shadow;  // (n,) the sun's shared PCF, or null
  const float* table;  // the frame's constants
  Transmittance lut;  // its radii set by each thread
  const void* sky;  // (sky_h, sky_w, 3) f32 or f16, or (sky_h, sky_w, 12) u8 codes
  const float* sky_scale;  // (sky_h, sky_w) q8 scales
  const float* tseg;  // (tseg_h, 6) t_seg row pairs, or null
  const float* volume;  // (n_y, n_x, n_s, 9) the aerial LUT
  PcfMaps sun_map;  // one map: the sun's
  float* out;  // (n, 3)
  long long n;
  int width, row_origin, metallic, sky_format, sky_h, sky_w, tseg_h, n_y, n_x, n_s;
  // Python numbers: 1 / draw extent (w, h), 1 / t_max, 0.5 + 0.5 / sky_h
  float inv_draw_w, inv_draw_h, inv_t_max, v_ground;
};

__device__ __forceinline__ float tab(const Params& p, int k) { return __ldg(p.table + k); }

// camera_rays' centred(i, extent)
__device__ __forceinline__ float centred(float i, float inv_extent) {
  const double c = __dsub_rn(__dmul_rn(static_cast<double>(i), static_cast<double>(inv_extent)), 0.5);
  return mul(__double2float_rn(c), 2.0f);
}

// matvec of a 4x4 row-major row and a 4-vector
__device__ __forceinline__ float row4(const float* m, float v0, float v1, float v2, float v3) {
  return add(add(mul(m[0], v0), mul(m[1], v1)), add(mul(m[2], v2), mul(m[3], v3)));
}

// _ray_sphere_roots -> where(hit, t0, 0) (the nearer root), hit
__device__ __forceinline__ float nearer_root(float b, float discriminant, float c, bool& hit) {
  hit = discriminant >= 0.0f;
  const float sq = safe_sqrt(discriminant);
  const float q = b < 0.0f ? sub(b, sq) : add(b, sq);
  const float t0 = div(c, fabsf(q) < kMinSpan ? kMinSpan : q);
  return hit ? min_nan(t0, q) : 0.0f;
}

// sample_lut_bilinear of the sky-view LUT at (u, v)
__device__ __forceinline__ void sample_sky(const Params& p, float u, float v, float* out) {
  const int h = p.sky_h, w = p.sky_w;
  const float x = clamp(sub(mul(u, static_cast<float>(w)), 0.5f), 0.0f, static_cast<float>(w - 1.0));
  const float y = clamp(sub(mul(v, static_cast<float>(h)), 0.5f), 0.0f, static_cast<float>(h - 1.0));
  const long long floor_x = static_cast<long long>(floorf(x)), floor_y = static_cast<long long>(floorf(y));
  const float fx = sub(x, static_cast<float>(floor_x)), fy = sub(y, static_cast<float>(floor_y));
  const float gx = sub(1.0f, fx), gy = sub(1.0f, fy);
  const int x0 = texel_index(floor_x, w), y0 = texel_index(floor_y, h);
  if (p.sky_format == kSkyQ8) {  // the texel's footprint, u8 fractions of its scale
    const long long texel = static_cast<long long>(y0) * w + x0;
    const float scale = mul(__ldg(p.sky_scale + texel), kInv255);
    const unsigned char* q = static_cast<const unsigned char*>(p.sky) + texel * 12;
    float f[12];
    for (int k = 0; k < 12; ++k) f[k] = mul(static_cast<float>(q[k]), scale);
    for (int c = 0; c < 3; ++c) {
      const float top = add(mul(f[c], gx), mul(f[3 + c], fx));
      const float bot = add(mul(f[6 + c], gx), mul(f[9 + c], fx));
      out[c] = add(mul(top, gy), mul(bot, fy));
    }
    return;
  }
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  const long long t00 = (static_cast<long long>(y0) * w + x0) * 3, t01 = (static_cast<long long>(y0) * w + x1) * 3;
  const long long t10 = (static_cast<long long>(y1) * w + x0) * 3, t11 = (static_cast<long long>(y1) * w + x1) * 3;
  for (int c = 0; c < 3; ++c) {
    float a, b, d, e;
    if (p.sky_format == kSkyF16) {
      const __half* s = static_cast<const __half*>(p.sky);
      a = __half2float(s[t00 + c]), b = __half2float(s[t01 + c]), d = __half2float(s[t10 + c]),
      e = __half2float(s[t11 + c]);
    } else {
      const float* s = static_cast<const float*>(p.sky);
      a = __ldg(s + t00 + c), b = __ldg(s + t01 + c), d = __ldg(s + t10 + c), e = __ldg(s + t11 + c);
    }
    const float top = add(mul(a, gx), mul(b, fx));
    const float bot = add(mul(d, gx), mul(e, fx));
    out[c] = add(mul(top, gy), mul(bot, fy));
  }
}

// _skyview_uv(atmo, position, direction); dir_norm = _norm3(direction)
__device__ __forceinline__ void skyview_uv(const Params& p, const float* position, const float* direction,
                                           float dir_norm, float& u, float& v) {
  const float sin_horizon = div(tab(p, kPlanetRadius), norm3_fma(position));
  const float horizon_zenith = sub(kPi, asinf(clamp(sin_horizon, -1.0f, 1.0f)));
  const float cos_view_zenith = div(direction[1], dir_norm);
  const float cos_horizon_zenith = -safe_sqrt(sub(1.0f, mul(sin_horizon, sin_horizon)));
  const float view_zenith = acosf(clamp(cos_view_zenith, -1.0f, 1.0f));
  const float frac_above = div(view_zenith, clamp_min(horizon_zenith, kMinSpan));
  const float v_above = mul(sub(1.0f, safe_sqrt(sub(1.0f, frac_above))), 0.5f);
  const float frac_below = div(sub(view_zenith, horizon_zenith), clamp_min(sub(kPi, horizon_zenith), kMinSpan));
  const float v_below = add(mul(safe_sqrt(frac_below), 0.5f), 0.5f);
  v = cos_view_zenith > cos_horizon_zenith ? v_above : v_below;
  const float proj_norm = clamp_min(
      __fsqrt_rn(add(mul(direction[0], direction[0]), mul(direction[2], direction[2]))), kMinSpan);
  const float view_x = div(direction[0], proj_norm), view_z = div(direction[2], proj_norm);
  const float cos_azimuth = add(mul(tab(p, kLightProj), view_x), mul(tab(p, kLightProj + 1), view_z));
  u = add(mul(clamp(cos_azimuth, -1.0f, 1.0f), 0.5f), 0.5f);
}

// sample_environment_shared(atmo, lut, sky, position, direction, tseg)
// -> (luminance, sun disk)
__device__ __forceinline__ void environment(const Params& p, const Transmittance& lut, const float* position,
                                            const float* direction, float* env, float* disk) {
  const float planet_radius = tab(p, kPlanetRadius);
  // the planet hit, with the compiled arithmetic (ray_sphere_intersect_fma)
  const float b = -dot3_fma(position, direction);
  float chord[3];
  for (int c = 0; c < 3; ++c) chord[c] = fma32(b, direction[c], position[c]);
  const float rr = mul(planet_radius, planet_radius);
  bool hit;
  const float dist = nearer_root(b, sub(rr, dot3_fma(chord, chord)), sub(dot3_fma(position, position), rr), hit);
  hit = hit && dist > 0.0f;
  float surface[3];
  for (int c = 0; c < 3; ++c) surface[c] = fma32(dist, direction[c], position[c]);

  const float dir_norm = norm3_fma(direction);
  float u, v;
  skyview_uv(p, position, direction, dir_norm, u, v);
  const float v_sel = hit ? clamp_min(v, p.v_ground) : v;
  float sky[3];
  sample_sky(p, u, v_sel, sky);

  float light_dir[3];
  for (int c = 0; c < 3; ++c) light_dir[c] = -tab(p, kSun + c);
  const float r_srf = norm3_fma(surface);
  const float mu_srf = div(dot3(surface, light_dir), mul(r_srf, norm3_fma(light_dir)));
  const float r_ray = norm3_fma(position);
  const float mu_ray = div(dot3(position, direction), mul(r_ray, dir_norm));
  float t_shared[3];
  sample_rmu(lut, row_at(lut, hit ? r_srf : r_ray), hit ? mu_srf : mu_ray, t_shared);

  // the ground (sampleGround, camera.comp:203-235; _ground_albedo_nl)
  float normal[3], halfway[3];
  for (int c = 0; c < 3; ++c) normal[c] = div(surface[c], r_srf);
  for (int c = 0; c < 3; ++c) halfway[c] = add(light_dir[c], -direction[c]);
  const float halfway_norm = norm3_fma(halfway);
  for (int c = 0; c < 3; ++c) halfway[c] = div(halfway[c], halfway_norm);
  const float specular = mul(powf(clamp01(dot3_fma(halfway, normal)), kGlintPower), kGlintScale);
  const float f = add(mul(powf(sub(1.0f, clamp01(dot3_fma(halfway, light_dir))), 5.0f), kGroundF0Rest), kGroundF0);
  const float albedo = add(mul(sub(1.0f, f), kGroundDiffuse), mul(specular, f));
  const float nl = clamp01(dot3_fma(normal, light_dir));
  float t_surface[3];
  if (p.tseg != nullptr) {  // _sample_tseg_rows at v_sel
    const float y = clamp(sub(mul(v_sel, static_cast<float>(p.tseg_h)), 0.5f), 0.0f,
                          static_cast<float>(p.tseg_h - 1.0));
    const long long floor_y = static_cast<long long>(floorf(y));
    const float fy = sub(y, static_cast<float>(floor_y));
    const float* q = p.tseg + 6 * texel_index(floor_y, p.tseg_h);
    for (int c = 0; c < 3; ++c) t_surface[c] = add(mul(__ldg(q + c), sub(1.0f, fy)), mul(__ldg(q + 3 + c), fy));
  } else {
    sample_segment(lut, position, surface, t_surface);
  }

  // the sun disk (sampleSunDisk, camera.comp:123-140; _sun_disk)
  const float cos_dir_sun = div(dot3(direction, light_dir), mul(dir_norm, tab(p, kToSunNorm)));
  const float sin_dir_sun = safe_sqrt(sub(1.0f, mul(cos_dir_sun, cos_dir_sun)));
  const float sin_sun_radius = tab(p, kSunRadius);
  const float edge0 = mul(sin_sun_radius, kSunEdge);
  const float t = clamp01(div(sub(sin_dir_sun, edge0), clamp_min(sub(sin_sun_radius, edge0), kMinSpan)));
  const float smooth = mul(mul(t, t), sub(3.0f, mul(t, 2.0f)));
  for (int c = 0; c < 3; ++c) {
    const float ground = add(mul(mul(mul(t_shared[c], albedo), nl), t_surface[c]), sky[c]);
    const float sun_disk = cos_dir_sun < 0.0f ? 0.0f : mul(t_shared[c], sub(1.0f, smooth));
    env[c] = hit ? ground : sky[c];
    disk[c] = hit ? 0.0f : sun_disk;
  }
}

// sample_aerial_lut at screen uv and ray distance -> (in-scatter, path T, sun T)
__device__ __forceinline__ void sample_aerial(const Params& p, float uv_x, float uv_y, float dist, float* out) {
  const int n_y = p.n_y, n_x = p.n_x, n_s = p.n_s;
  const float x = clamp(sub(mul(uv_x, static_cast<float>(n_x)), 0.5f), 0.0f, static_cast<float>(n_x - 1.0));
  const float y = clamp(sub(mul(uv_y, static_cast<float>(n_y)), 0.5f), 0.0f, static_cast<float>(n_y - 1.0));
  const float s = clamp(sub(mul(__fsqrt_rn(mul(clamp_min(dist, 0.0f), p.inv_t_max)), static_cast<float>(n_s)), 1.0f),
                        -1.0f, static_cast<float>(n_s - 1.0));
  const long long floor_x = static_cast<long long>(floorf(x)), floor_y = static_cast<long long>(floorf(y));
  const float s0f = floorf(s);
  const int s0 = static_cast<int>(clamp_min(s0f, -1.0f));
  const float fx = sub(x, static_cast<float>(floor_x)), fy = sub(y, static_cast<float>(floor_y));
  const float fs = sub(s, s0f);
  const float gx = sub(1.0f, fx), gy = sub(1.0f, fy), gs = sub(1.0f, fs);
  const int x0 = texel_index(floor_x, n_x), y0 = texel_index(floor_y, n_y);
  const int x1 = min(x0 + 1, n_x - 1), y1 = min(y0 + 1, n_y - 1);
  const int sa = max(s0, 0), sb = min(sa + 1, n_s - 1);
  const auto at = [&](int yy, int xx, int ss) {
    return p.volume + ((static_cast<long long>(yy) * n_x + xx) * n_s + ss) * 9;
  };
  const float *a00 = at(y0, x0, sa), *a01 = at(y0, x1, sa), *a10 = at(y1, x0, sa), *a11 = at(y1, x1, sa);
  const float *b00 = at(y0, x0, sb), *b01 = at(y0, x1, sb), *b10 = at(y1, x0, sb), *b11 = at(y1, x1, sb);
  for (int k = 0; k < 9; ++k) {
    const float top0 = add(mul(__ldg(a00 + k), gx), mul(__ldg(a01 + k), fx));
    const float bot0 = add(mul(__ldg(a10 + k), gx), mul(__ldg(a11 + k), fx));
    const float v0 = add(mul(top0, gy), mul(bot0, fy));
    if (s0 < 0) {  // toward the implicit distance-0 slice: no in-scatter, path T 1, sun T t_sun0
      const float zero = k < 3 ? 0.0f : (k < 6 ? 1.0f : tab(p, kSunT0 + k - 6));
      out[k] = add(mul(zero, gs), mul(v0, fs));
    } else {
      const float top1 = add(mul(__ldg(b00 + k), gx), mul(__ldg(b01 + k), fx));
      const float bot1 = add(mul(__ldg(b10 + k), gx), mul(__ldg(b11 + k), fx));
      const float v1 = add(mul(top1, gy), mul(bot1, fy));
      out[k] = add(mul(v0, gs), mul(v1, fs));
    }
  }
}

// Pixel i's colour, written to out
template <bool kQ8>
__device__ __forceinline__ void shade(const Params& p, long long i) {
  const float4 pos = p.position[i];
  const float depth = p.depth[i];
  const bool is_env = depth == 0.0f || pos.y > 0.0f;

  // the camera ray (camera_rays): matvec of the inverse projection and
  // the rotation, normalized, y flipped
  const int row = static_cast<int>(i / p.width), col = static_cast<int>(i % p.width);
  const float x = centred(static_cast<float>(col), p.inv_draw_w);
  const float y = centred(add(static_cast<float>(row), static_cast<float>(p.row_origin)), p.inv_draw_h);
  const float* ip = p.table + kInverseProjection;
  const float* rot = p.table + kRotation;
  float view[4];
  for (int r = 0; r < 4; ++r) view[r] = row4(ip + 4 * r, x, y, 1.0f, 1.0f);
  float direction[3];
  for (int r = 0; r < 3; ++r) direction[r] = row4(rot + 4 * r, view[0], view[1], view[2], view[3]);
  const float ray_norm = norm3_fma(direction);
  for (int c = 0; c < 3; ++c) direction[c] = div(direction[c], ray_norm);
  direction[1] = mul(direction[1], -1.0f);
  float camera[3];
  for (int c = 0; c < 3; ++c) camera[c] = tab(p, kCamera + c);
  Transmittance lut = p.lut;
  set_radii(lut, tab(p, kPlanetRadius), tab(p, kAtmosphereRadius));

  float transfer[3], surface_luminance[3] = {0.0f, 0.0f, 0.0f};
  float env[3], disk[3];
  if (is_env) {
    environment(p, lut, camera, direction, env, disk);
    for (int c = 0; c < 3; ++c) transfer[c] = add(env[c], disk[c]);  // shadowFactor = 1
  } else {
    // convertPBRProperties (convert_pbr), then the sky-space surface
    const Material m = convert_pbr(p.diffuse[i], p.specular[i], p.normal[i], pos, p.orm[i]);
    const float normal[3] = {m.normal[0], mul(m.normal[1], -1.0f), m.normal[2]};
    const float surface[3] = {add(mul(pos.x, kInvMeters), 0.0f),
                              add(mul(mul(pos.y, -1.0f), kInvMeters), tab(p, kPlanetRadius)),
                              add(mul(pos.z, kInvMeters), 0.0f)};
    float to_surface[3];
    for (int c = 0; c < 3; ++c) to_surface[c] = sub(surface[c], camera[c]);
    const float dist_surface = __fsqrt_rn(dot3(to_surface, to_surface));

    const float shadow = p.sun_shadow != nullptr
                             ? p.sun_shadow[i]
                             : pcf<kQ8>(p.sun_map, 0, shadow_frame(p.table + kShadowFrame, m.position, m.normal));
    float aerial[9];  // in-scatter, camera->surface T, surface->sun T
    sample_aerial(p, add(mul(x, 0.5f), 0.5f), add(mul(y, 0.5f), 0.5f), dist_surface, aerial);

    // geometry_luminance_transfer (camera.comp:237-278)
    const float planet_radius = tab(p, kPlanetRadius);
    float light_dir[3], to_camera[3];
    for (int c = 0; c < 3; ++c) light_dir[c] = tab(p, kLightDir + c);
    const float dir_norm = norm3_fma(direction);
    for (int c = 0; c < 3; ++c) to_camera[c] = div(-direction[c], dir_norm);
    const float b = -dot3(surface, light_dir);
    float chord[3];
    for (int c = 0; c < 3; ++c) chord[c] = add(surface[c], mul(b, light_dir[c]));
    const float rr = mul(planet_radius, planet_radius);
    bool planet_hit;
    const float t0 = nearer_root(b, sub(rr, dot3(chord, chord)), sub(dot3(surface, surface), rr), planet_hit);
    const bool shadowed_by_planet = planet_hit && t0 > 0.0f;
    float reflectance[3];
    brdf(m, normal, light_dir, to_camera, reflectance);
    const float frac_visible = div(planet_radius, norm3_fma(surface));
    const float nl = clamp01(dot3(normal, light_dir));
    const float lit = mul(mul(shadow, frac_visible), shadowed_by_planet ? 0.0f : 1.0f);
    for (int c = 0; c < 3; ++c) {
      const float surface_transfer =
          mul(mul(mul(mul(mul(lit, aerial[6 + c]), aerial[3 + c]), m.occlusion), reflectance[c]), nl);
      transfer[c] = add(surface_transfer, aerial[c]);
    }
    if (p.metallic) {  // the ad-hoc single bounce (camera.comp:379-387)
      float outgoing[3], reflected[3];
      for (int c = 0; c < 3; ++c) outgoing[c] = -direction[c];
      const float d = dot3(normal, outgoing);
      for (int c = 0; c < 3; ++c) reflected[c] = sub(mul(mul(d, normal[c]), 2.0f), outgoing[c]);
      environment(p, lut, surface, reflected, env, disk);
      float halfway[3], bounce[3];
      fresnel(m.f0, outgoing, reflected, halfway, bounce);
      for (int c = 0; c < 3; ++c) {
        const float refl = add(env[c], mul(disk[c], shadow));
        transfer[c] = add(transfer[c], mul(mul(mul(aerial[3 + c], m.metallic), bounce[c]), refl));
      }
    }
    const float* lit_color = p.color + 3 * i;
    for (int c = 0; c < 3; ++c) surface_luminance[c] = __ldg(lit_color + c);
  }
  float* out = p.out + 3 * i;
  for (int c = 0; c < 3; ++c) {
    const float luminance = mul(transfer[c], tab(p, kSpectrum + c));
    out[c] = powf(clamp_min(add(mul(luminance, 10.0f), surface_luminance[c]), 0.0f), kGamma);
  }
}

// one instance a tap format, so that the f32 taps pay no register for q8
template <bool kQ8>
__global__ void __launch_bounds__(kThreads) sky_kernel(const Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < p.n) shade<kQ8>(p, i);
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a CUDA error, 0 when the
// launch succeeded. Launches on `stream` of `device`; allocates nothing.
// `sky_format`: 0 f32, 1 f16 (sky: (sky_h, sky_w, 3)), 2 q8 (sky: the u8
// codes (sky_h, sky_w, 12), sky_scale (sky_h, sky_w)). `tseg` null: the
// ground's camera->surface transmittance samples the segment per pixel.
// `sun_shadow` null: the kernel takes the sun's PCF in `maps` (one map of
// `size`^2; `codes`, `lo` and `step` all null or all given, q8).
extern "C" int szg_sky(const void* diffuse, const void* specular, const void* normal, const void* position,
                       const void* orm, const float* depth, const float* color, const float* sun_shadow,
                       const float* table, const float* lut, int lut_h, int lut_w, const void* sky,
                       const float* sky_scale, int sky_h, int sky_w, int sky_format, const float* tseg, int tseg_h,
                       const float* volume, int n_y, int n_x, int n_s, double t_max, const float* maps, int size,
                       int f16, const void* codes, const float* lo, const float* step, int n_w, int metallic,
                       int rows, int width, int row_origin, int draw_w, int draw_h, float* out, int device,
                       void* stream) {
  if (rows < 0 || width <= 0 || lut_h <= 0 || lut_w <= 0 || sky_h <= 0 || sky_w <= 0 || n_y <= 0 || n_x <= 0 ||
      n_s <= 0 || size <= 0 || draw_w <= 0 || draw_h <= 0 || !(t_max > 0.0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (sky_format < kSkyF32 || sky_format > kSkyQ8 || (sky_format == kSkyQ8) != (sky_scale != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((tseg != nullptr && tseg_h <= 0) || (codes != nullptr && (lo == nullptr || step == nullptr || n_w <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  if (!szg::valid_device(device)) return (int)cudaErrorInvalidDevice;
  const long long n = static_cast<long long>(rows) * width;
  if (n == 0) return (int)cudaSuccess;
  szg::DeviceScope scope(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const float4*>(diffuse), static_cast<const float4*>(specular),
           static_cast<const float4*>(normal), static_cast<const float4*>(position),
           static_cast<const float4*>(orm), depth, color, sun_shadow, table,
           szg::transmittance_lut(lut, lut_h, lut_w), sky, sky_scale, tseg, volume,
           szg::PcfMaps{maps, static_cast<const __half*>(codes), lo, step, size, f16, n_w}, out, n, width,
           row_origin, metallic, sky_format, sky_h, sky_w, tseg_h, n_y, n_x, n_s,
           // as Python computes them and PyTorch casts them to f32
           static_cast<float>(1.0 / draw_w), static_cast<float>(1.0 / draw_h), static_cast<float>(1.0 / t_max),
           static_cast<float>(0.5 + 0.5 / sky_h)};
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (codes != nullptr) {
    sky_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  } else {
    sky_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
