// The G-buffer's PBR material and its BRDF (kernels/lighting.py::
// convert_pbr, compute_fresnel, diffuse_brdf and specular_brdf), shared by
// the lighting and the sky pass, each operation rounding as f32.h says.
#pragma once

#include "f32.h"

namespace szg {

// Python numbers as PyTorch casts them to f32; a divisor's reciprocal is
// taken in f64 and rounded to f32
constexpr float kMinMetallic = static_cast<float>(1e-8);
constexpr float kDielectricF0 = static_cast<float>(0.04);
constexpr float kSpecularPowerBase = static_cast<float>(160.0);
constexpr float kInvPi = static_cast<float>(1.0 / 3.14159265359);  // kernels/lighting.py::PI

struct Material {
  float position[3], normal[3], color[3], f0[3];
  float occlusion, spec_power, metallic;
};

// convertPBRProperties (convert_pbr) of one texel of the five planes
__device__ __forceinline__ Material convert_pbr(float4 diffuse, float4 specular, float4 normal, float4 position,
                                                float4 orm) {
  Material m;
  m.position[0] = position.x, m.position[1] = position.y, m.position[2] = position.z;
  m.normal[0] = normal.x, m.normal[1] = normal.y, m.normal[2] = normal.z;
  m.color[0] = diffuse.x, m.color[1] = diffuse.y, m.color[2] = diffuse.z;
  const float s[3] = {specular.x, specular.y, specular.z};
  const float den = clamp_min(max_nan(max_nan(s[0], s[1]), s[2]), kMinMetallic);
  m.metallic = orm.z;
  const float dielectric = mul(kDielectricF0, sub(1.0f, m.metallic));
  for (int c = 0; c < 3; ++c) m.f0[c] = add(dielectric, mul(div(mul(0.5f, s[c]), den), m.metallic));
  m.occlusion = orm.x;
  m.spec_power = powf(kSpecularPowerBase, sub(1.0f, orm.y));
  return m;
}

// computeFresnel (compute_fresnel): f0 + (1 - f0) * (1 - clamp(h . light))^5
// at the halfway vector h = _normalize(light + view), which it gives back
__device__ __forceinline__ void fresnel(const float* f0, const float* light, const float* view, float* halfway,
                                        float* out) {
  float h[3];
  for (int c = 0; c < 3; ++c) h[c] = add(light[c], view[c]);
  normalize3(h, halfway);
  const float schlick = powf(sub(1.0f, clamp01(dot3(halfway, light))), 5.0f);
  for (int c = 0; c < 3; ++c) out[c] = add(f0[c], mul(sub(1.0f, f0[c]), schlick));
}

// diffuse_brdf * (1 - F) + specular_brdf * F of light from `light` seen
// along `view` at a surface of `normal`, per channel
__device__ __forceinline__ void brdf(const Material& m, const float* normal, const float* light, const float* view,
                                     float* out) {
  float halfway[3], f[3];
  fresnel(m.f0, light, view, halfway, f);
  const float hn = clamp01(dot3(halfway, normal));
  const float specular = mul(mul(add(m.spec_power, 2.0f), 0.125f), powf(hn, m.spec_power));
  for (int c = 0; c < 3; ++c) out[c] = add(mul(mul(m.color[c], kInvPi), sub(1.0f, f[c])), mul(specular, f[c]));
}

}  // namespace szg
