// The transmittance LUT's samples (kernels/atmosphere.py::
// sample_transmittance_rmu, sample_transmittance_ray and
// sample_transmittance_segment), shared by the in-scattering integral and
// the sky pass: transmittance_rmu_to_uv's plain (uncontracted) mapping,
// then sample_lut_bilinear's clamp-to-edge filter of an (h, w, 3) f32 LUT,
// the texel's index the int64 conversion of floor(x), its neighbour
// edge-clamped.
#pragma once

#include "f32.h"

namespace szg {

// The LUT, the Python numbers of its mapping as PyTorch casts them to f32,
// and the radii's step-invariant terms
struct Transmittance {
  const float* lut;  // (lut_h, lut_w, 3)
  int lut_h, lut_w;
  // tex_coord_from_unit_range's 0.5 / dim and 1 - 1 / dim, the clamp's dim - 1
  float u_offset, u_scale, v_offset, v_scale, x_max, y_max;
  float planet_radius, atmosphere_radius, atm_r2, pl_r2, h, h_safe;
};

// The LUT's Python numbers, on the host
inline Transmittance transmittance_lut(const float* lut, int lut_h, int lut_w) {
  Transmittance t{};
  t.lut = lut;
  t.lut_h = lut_h;
  t.lut_w = lut_w;
  t.u_offset = static_cast<float>(0.5 / lut_w);
  t.u_scale = static_cast<float>(1.0 - 1.0 / lut_w);
  t.v_offset = static_cast<float>(0.5 / lut_h);
  t.v_scale = static_cast<float>(1.0 - 1.0 / lut_h);
  t.x_max = static_cast<float>(lut_w - 1.0);
  t.y_max = static_cast<float>(lut_h - 1.0);
  return t;
}

// The radii's terms, as the plain version computes them on 0-dim tensors
__device__ __forceinline__ void set_radii(Transmittance& t, float planet_radius, float atmosphere_radius) {
  t.planet_radius = planet_radius;
  t.atmosphere_radius = atmosphere_radius;
  t.atm_r2 = mul(atmosphere_radius, atmosphere_radius);
  t.pl_r2 = mul(planet_radius, planet_radius);
  t.h = safe_sqrt(sub(t.atm_r2, t.pl_r2));
  t.h_safe = clamp_min(t.h, static_cast<float>(1e-12));
}

// The radius's half of transmittance_rmu_to_uv and of the bilinear sample:
// shared by the samples that one radius takes
struct Row {
  float radius, r2, rho, d_min, d_max, fy;
  int y0, y1;
};

__device__ __forceinline__ Row row_at(const Transmittance& t, float radius) {
  Row r;
  r.radius = radius;
  r.r2 = mul(radius, radius);
  r.rho = safe_sqrt(sub(r.r2, t.pl_r2));
  r.d_min = sub(t.atmosphere_radius, radius);
  r.d_max = add(r.rho, t.h);
  const float x_radius = div(r.rho, t.h_safe);
  const float v = add(mul(x_radius, t.v_scale), t.v_offset);
  const float y = clamp(sub(mul(v, static_cast<float>(t.lut_h)), 0.5f), 0.0f, t.y_max);
  const long long floor_y = static_cast<long long>(floorf(y));
  r.fy = sub(y, static_cast<float>(floor_y));
  r.y0 = texel_index(floor_y, t.lut_h);
  r.y1 = min(r.y0 + 1, t.lut_h - 1);
  return r;
}

// sample_transmittance_rmu(lut, atmo, row.radius, mu)
__device__ __forceinline__ void sample_rmu(const Transmittance& t, const Row& r, float mu, float* out) {
  const float d = clamp_min(
      add(mul(-r.radius, mu), safe_sqrt(add(mul(r.r2, sub(mul(mu, mu), 1.0f)), t.atm_r2))), 0.0f);
  const float x_mu = div(sub(d, r.d_min), clamp_min(sub(r.d_max, r.d_min), static_cast<float>(1e-12)));
  const float u = add(mul(x_mu, t.u_scale), t.u_offset);
  const float x = clamp(sub(mul(u, static_cast<float>(t.lut_w)), 0.5f), 0.0f, t.x_max);
  const long long floor_x = static_cast<long long>(floorf(x));
  const float fx = sub(x, static_cast<float>(floor_x));
  const int x0 = texel_index(floor_x, t.lut_w);
  const int x1 = min(x0 + 1, t.lut_w - 1);
  const float* top = t.lut + static_cast<long long>(r.y0) * t.lut_w * 3;
  const float* bot = t.lut + static_cast<long long>(r.y1) * t.lut_w * 3;
  const float gx = sub(1.0f, fx), gy = sub(1.0f, r.fy);
  for (int c = 0; c < 3; ++c) {
    const float a = add(mul(__ldg(top + 3 * x0 + c), gx), mul(__ldg(top + 3 * x1 + c), fx));
    const float b = add(mul(__ldg(bot + 3 * x0 + c), gx), mul(__ldg(bot + 3 * x1 + c), fx));
    out[c] = add(mul(a, gy), mul(b, r.fy));
  }
}

// sample_transmittance_ray, the direction's norm given
__device__ __forceinline__ void sample_ray(const Transmittance& t, const float* position, const float* direction,
                                           float direction_norm, float* out) {
  const float radius = norm3(position);
  const float mu = div(dot3(position, direction), mul(radius, direction_norm));
  sample_rmu(t, row_at(t, radius), mu, out);
}

// sample_transmittance_segment
__device__ __forceinline__ void sample_segment(const Transmittance& t, const float* from, const float* to,
                                               float* out) {
  float diff[3];
  for (int c = 0; c < 3; ++c) diff[c] = sub(to[c], from[c]);
  const float length = norm3(diff);
  float direction[3];
  for (int c = 0; c < 3; ++c) direction[c] = div(diff[c], length);
  const bool flip = dot3(from, direction) < 0.0f;
  float d[3];
  for (int c = 0; c < 3; ++c) d[c] = flip ? -direction[c] : direction[c];
  const float d_norm = norm3(d);
  float ta[3], tb[3];
  sample_ray(t, flip ? to : from, d, d_norm, ta);
  sample_ray(t, flip ? from : to, d, d_norm, tb);
  for (int c = 0; c < 3; ++c) {
    out[c] = clamp(div(ta[c], clamp_min(tb[c], static_cast<float>(1e-20))), 0.0f, 1.0f);
  }
}

}  // namespace szg
