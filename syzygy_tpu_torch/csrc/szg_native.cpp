// szg_native: the host-engine hot loops, in C++.
//
// The reference's native code IS its host engine; the per-frame CPU work that
// survives into the TPU design is exactly what lives here:
//   * instance animation tick           (renderer/scene.cpp:463-527)
//   * TRS -> model matrix snapshot      (geometry/transform.cpp:11-15)
//   * shadow-bounds AABB over casters   (renderer/scene.cpp:95-148)
//   * triangle -> tile binning          (feeds the Pallas raster's
//                                        per-tile compact lists)
//
// Exposed as a C ABI consumed via ctypes (syzygy_tpu_torch/native.py); the
// numpy implementations remain as fallbacks and as the executable spec.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <limits>

extern "C" {

// Instance animations (matches scene.cpp:463-527 and scene/scene.py).
// kinds: 0 none, 1 diagonal wave, 2 spin along world up.
// translations/eulers are (n, 3) float32, originals likewise.
void szg_tick_animations(
    int64_t n,
    const int32_t* kinds,
    const float* original_translations,
    float* translations,
    float* eulers,
    double time_elapsed,
    double delta_time)
{
    for (int64_t i = 0; i < n; ++i) {
        if (kinds[i] == 1) {  // DIAGONAL_WAVE
            const float ox = original_translations[i * 3 + 0];
            const float oz = original_translations[i * 3 + 2];
            const double offset = (ox + 10.0 + oz + 10.0) / 3.1415;
            translations[i * 3 + 0] = ox;
            translations[i * 3 + 1] =
                original_translations[i * 3 + 1]
                + static_cast<float>(std::sin(time_elapsed + offset));
            translations[i * 3 + 2] = oz;
        } else if (kinds[i] == 2) {  // SPIN_ALONG_WORLD_UP
            eulers[i * 3 + 2] += static_cast<float>(delta_time);
        }
    }
}

// Transform::toMatrix = T * RotY(yaw) * RotX(pitch) * RotZ(roll) * S,
// row-major 4x4 out (n, 16).
void szg_trs_to_matrices(
    int64_t n,
    const float* translations,
    const float* eulers,
    const float* scales,
    float* out)
{
    for (int64_t i = 0; i < n; ++i) {
        const float pitch = eulers[i * 3 + 0];
        const float roll = eulers[i * 3 + 1];
        const float yaw = eulers[i * 3 + 2];
        const float cy = std::cos(yaw), sy = std::sin(yaw);
        const float cp = std::cos(pitch), sp = std::sin(pitch);
        const float cr = std::cos(roll), sr = std::sin(roll);
        // RotY(yaw) @ RotX(pitch) @ RotZ(roll)
        float r[9] = {
            cy * cr + sy * sp * sr, -cy * sr + sy * sp * cr, sy * cp,
            sr * cp,                cr * cp,                 -sp,
            -sy * cr + cy * sp * sr, sr * sy + cy * sp * cr, cy * cp,
        };
        float* m = out + i * 16;
        for (int row = 0; row < 3; ++row) {
            for (int col = 0; col < 3; ++col) {
                m[row * 4 + col] = r[row * 3 + col] * scales[i * 3 + col];
            }
            m[row * 4 + 3] = translations[i * 3 + row];
        }
        m[12] = 0.f; m[13] = 0.f; m[14] = 0.f; m[15] = 1.f;
    }
}

// Shadow-bounds AABB: min/max over every transformed corner of every
// caster's mesh AABB (scene.cpp:95-148). corners: (n_instances, 8, 3)
// object-space corners; matrices: (n_instances, 16) row-major.
// Returns 1 when any caster contributed.
int32_t szg_shadow_bounds(
    int64_t n_instances,
    const uint8_t* casts,
    const float* corners,
    const float* matrices,
    float* out_min,
    float* out_max)
{
    float mn[3], mx[3];
    for (int k = 0; k < 3; ++k) {
        mn[k] = std::numeric_limits<float>::max();
        mx[k] = std::numeric_limits<float>::lowest();
    }
    bool found = false;
    for (int64_t i = 0; i < n_instances; ++i) {
        if (!casts[i]) continue;
        const float* m = matrices + i * 16;
        for (int c = 0; c < 8; ++c) {
            const float* p = corners + (i * 8 + c) * 3;
            for (int row = 0; row < 3; ++row) {
                const float v = m[row * 4 + 0] * p[0] + m[row * 4 + 1] * p[1]
                              + m[row * 4 + 2] * p[2] + m[row * 4 + 3];
                mn[row] = std::min(mn[row], v);
                mx[row] = std::max(mx[row], v);
            }
        }
        found = true;
    }
    if (!found) {
        std::memset(out_min, 0, 3 * sizeof(float));
        std::memset(out_max, 0, 3 * sizeof(float));
        return 0;
    }
    std::memcpy(out_min, mn, 3 * sizeof(float));
    std::memcpy(out_max, mx, 3 * sizeof(float));
    return 1;
}

// Exact triangle -> tile binning from screen bboxes.
// bboxes: (n_tris, 4) float32 [min_x, min_y, max_x, max_y]; valid: (n_tris,)
// Outputs per-tile compact lists: counts (tiles_y * tiles_x), indices
// (tiles_y * tiles_x * capacity). Returns the number of overflowed
// (tile, triangle) pairs that were dropped.
int64_t szg_bin_triangles(
    int64_t n_tris,
    const float* bboxes,
    const uint8_t* valid,
    int32_t tiles_x,
    int32_t tiles_y,
    int32_t tile_w,
    int32_t tile_h,
    int32_t capacity,
    int32_t* counts,
    int32_t* indices)
{
    std::memset(counts, 0, sizeof(int32_t) * tiles_x * tiles_y);
    int64_t dropped = 0;
    for (int64_t t = 0; t < n_tris; ++t) {
        if (!valid[t]) continue;
        const float* bb = bboxes + t * 4;
        int32_t tx0 = std::max<int32_t>(0, (int32_t)std::floor(bb[0] / tile_w));
        int32_t ty0 = std::max<int32_t>(0, (int32_t)std::floor(bb[1] / tile_h));
        int32_t tx1 = std::min<int32_t>(tiles_x - 1, (int32_t)std::floor(bb[2] / tile_w));
        int32_t ty1 = std::min<int32_t>(tiles_y - 1, (int32_t)std::floor(bb[3] / tile_h));
        for (int32_t ty = ty0; ty <= ty1; ++ty) {
            for (int32_t tx = tx0; tx <= tx1; ++tx) {
                const int64_t tile = (int64_t)ty * tiles_x + tx;
                int32_t& cnt = counts[tile];
                if (cnt < capacity) {
                    indices[tile * capacity + cnt] = (int32_t)t;
                    ++cnt;
                } else {
                    ++dropped;
                }
            }
        }
    }
    return dropped;
}

}  // extern "C"
