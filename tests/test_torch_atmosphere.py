"""Atmosphere LUTs and samplers vs the reference (e).

Tolerances are the reference's LUT classes (``docs/PARITY.md:13-14``):
transmittance 2e-5, sky-view 2e-4. The transmittance LUT is a product of
500 exponentials; XLA's CPU ``exp`` and torch's differ in the last bit and
the reference's own LUT already sits up to ~3e-5 from the exact
(float64) product. So the port is held within 2e-5 of a float64 evaluation
of the same formula, and within 2e-5 + |reference - float64| of the
reference. Every other LUT function gets the reference's own transmittance LUT
as input, so it is compared with the reference directly.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import reference_inputs, to_numpy_dict

T_TOL = 2e-5
SKY_TOL = 2e-4


@functools.lru_cache(maxsize=None)
def states():
    """(reference AtmospherePacked, port AtmospherePacked, reference camera,
    port camera, reference origin_mm, port origin_mm) for the golden scene."""
    import jax

    from syzygy_tpu.scene.pack import prepare_frame_state as ref_prepare

    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    _, params, _, params_t, _ = reference_inputs("default")
    ref = jax.jit(ref_prepare)(params)
    port = prepare_frame_state(params_t)
    ref_origin = ref.camera.position[:3] / 1e6 * jnp.array([1.0, -1.0, 1.0]) + jnp.array(
        [0.0, ref.atmosphere.planet_radius_mm, 0.0]
    )
    zero = torch.zeros(())
    port_origin = port.camera.position[:3] / 1e6 * torch.tensor([1.0, -1.0, 1.0]) + torch.stack(
        [zero, port.atmosphere.planet_radius_mm, zero]
    )
    return ref.atmosphere, port.atmosphere, ref.camera, port.camera, ref_origin, port_origin


@functools.lru_cache(maxsize=None)
def reference_transmittance():
    from syzygy_tpu.kernels.atmosphere import compute_transmittance_lut

    return np.asarray(compute_transmittance_lut(states()[0], width=512, height=128))


def _transmittance_f64(ref_atmo, width: int, height: int) -> np.ndarray:
    """``transmittance_LUT.comp`` with the reference's own f32 texel
    geometry (radius, mu, path length) and the 500-step optical-depth
    product taken in float64: the exact value the f32 LUTs approximate."""
    from syzygy_tpu.kernels.atmosphere import ray_sphere_intersect, transmittance_uv_to_rmu

    u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    v = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    uu, vv = jnp.meshgrid(u, v)
    radius, mu = transmittance_uv_to_rmu(ref_atmo, uu, vv, width, height)
    zero = jnp.zeros_like(radius)
    origin = jnp.stack([zero, radius, zero], -1)
    direction = jnp.stack([jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0)), mu, zero], -1)
    hit, _, dist = ray_sphere_intersect(origin, direction, ref_atmo.atmosphere_radius_mm)
    f = {k: np.asarray(val, np.float64) for k, val in to_numpy_dict(ref_atmo).items()}
    origin, direction = np.asarray(origin, np.float64), np.asarray(direction, np.float64)
    dist = np.asarray(dist, np.float64)
    trans = np.ones((height, width, 3))
    for i in range(500):
        pos = origin + (dist * (i + 0.5) / 500)[..., None] * direction
        alt = np.maximum(np.linalg.norm(pos, axis=-1) - f["planet_radius_mm"], -0.001)[..., None]
        dr = np.exp(-alt / f["density_scale_rayleigh_mm"])
        dm = np.exp(-alt / f["density_scale_mie_mm"])
        do = np.maximum(0.0, 1 - np.abs(alt * 1000 - 25) / 15)
        ext = (
            f["scattering_rayleigh_per_mm"] * dr + f["absorption_rayleigh_per_mm"] * dr
            + f["scattering_mie_per_mm"] * dm + f["absorption_rayleigh_per_mm"] * dm
            + f["scattering_ozone_per_mm"] * do + f["absorption_ozone_per_mm"] * do
        )
        trans = trans * np.exp(-np.abs(dist / 500)[..., None] * ext)
    return np.where(np.asarray(hit)[..., None], trans, 1.0)


def test_transmittance_lut_close():
    from syzygy_tpu_torch.kernels.atmosphere import compute_transmittance_lut

    ref_atmo, port_atmo = states()[:2]
    port = compute_transmittance_lut(port_atmo, 512, 128).numpy()
    exact = _transmittance_f64(ref_atmo, 512, 128)
    ref = reference_transmittance()
    assert port.shape == ref.shape == (128, 512, 3)
    assert np.abs(port - exact).max() <= T_TOL
    assert (np.abs(port - ref) <= T_TOL + np.abs(ref - exact)).all()


@pytest.mark.parametrize("dims", [(128, 64), (2048, 1024)])
def test_skyview_lut_close(dims):
    """Row-wise sky-view LUT at the golden and the default dims, fed the
    reference's transmittance LUT: 2e-4 everywhere except the rows whose
    rays graze the horizon (|v - 0.5| <= 0.04: within ~0.6 degrees), where
    the in-scatter integral is discontinuity-sensitive (last-bit
    differences of asin/acos/sin/cos move it); there the bound
    is the reference's own row-wise-vs-per-texel horizon bound, 5e-3
    (``tests/test_atmosphere.py::test_skyview_rowwise``)."""
    from syzygy_tpu.kernels.atmosphere import compute_skyview_lut as ref_skyview
    from syzygy_tpu.kernels.atmosphere import pack_lut

    from syzygy_tpu_torch.kernels.atmosphere import compute_skyview_lut

    ref_atmo, port_atmo, _, _, ref_origin, port_origin = states()
    t_lut = reference_transmittance()
    w, h = dims
    ref = np.asarray(ref_skyview(ref_atmo, ref_origin, pack_lut(jnp.asarray(t_lut)), width=w, height=h))
    port = compute_skyview_lut(port_atmo, port_origin, torch.from_numpy(t_lut.copy()), w, h).numpy()
    v = (np.arange(h) + 0.5) / h
    horizon = np.abs(v - 0.5) <= 0.04
    np.testing.assert_allclose(port[~horizon], ref[~horizon], atol=SKY_TOL, rtol=0)
    np.testing.assert_allclose(port[horizon], ref[horizon], atol=5e-3, rtol=0)


def test_skyview_q8_codes_and_samples():
    """q8 packing: identical u8 codes and scales from the same LUT (both
    round half to even); bilinear samples within 1e-6."""
    from syzygy_tpu.kernels.atmosphere import pack_lut_q8 as ref_pack
    from syzygy_tpu.kernels.atmosphere import sample_lut_bilinear as ref_sample

    from syzygy_tpu_torch.kernels.atmosphere import pack_lut_q8, sample_lut_bilinear

    rng = np.random.default_rng(5)
    lut = (rng.random((64, 128, 3)) * 0.3).astype(np.float32)
    lut[3, 4] = 0.0  # an all-zero footprint corner
    ref = ref_pack(jnp.asarray(lut))
    port = pack_lut_q8(torch.from_numpy(lut))
    words = np.asarray(ref.words)
    codes = np.stack([(words[:, j] >> (8 * b)) & 255 for j in range(3) for b in range(4)], -1)
    np.testing.assert_array_equal(port.q.numpy().reshape(-1, 12), codes)
    np.testing.assert_array_equal(port.scale.numpy().reshape(-1), words[:, 3].view(np.float32))
    u, v = rng.random(4096).astype(np.float32), rng.random(4096).astype(np.float32)
    np.testing.assert_allclose(
        sample_lut_bilinear(port, torch.from_numpy(u), torch.from_numpy(v)).numpy(),
        np.asarray(ref_sample(ref, jnp.asarray(u), jnp.asarray(v))),
        atol=1e-6, rtol=0,
    )


def test_tseg_rows_close():
    from syzygy_tpu.kernels.atmosphere import pack_lut
    from syzygy_tpu.kernels.sky import compute_skyview_tseg as ref_tseg
    from syzygy_tpu.kernels.sky import pack_tseg_rows as ref_pack_rows

    from syzygy_tpu_torch.kernels.sky import compute_skyview_tseg, pack_tseg_rows

    ref_atmo, port_atmo, _, _, ref_origin, port_origin = states()
    t_lut = reference_transmittance()
    ref = np.asarray(ref_pack_rows(ref_tseg(ref_atmo, pack_lut(jnp.asarray(t_lut)), ref_origin, 64)))
    port = pack_tseg_rows(
        compute_skyview_tseg(port_atmo, torch.from_numpy(t_lut.copy()), port_origin, 64)
    ).numpy()
    np.testing.assert_allclose(port, ref, atol=T_TOL, rtol=0)


def test_aerial_lut_close():
    """Froxel volume. The reference builds its 16 slices in a compiled
    ``lax.map``, whose fused multiply-adds move near-horizon path
    transmittances by up to ~3e-3 from the same slices evaluated op by op.
    So the port is held in the classes (in-scatter 2e-4, transmittances
    2e-5) against the reference's primitives composed slice by slice, and
    within class + that compiled-vs-op-by-op spread of the production
    ``build_aerial_lut``."""
    from syzygy_tpu.kernels.atmosphere import (
        luminance_scattering_integral,
        pack_lut,
        sample_transmittance_ray,
        sample_transmittance_segment,
    )
    from syzygy_tpu.kernels.sky import build_aerial_lut as ref_build

    from syzygy_tpu_torch.kernels.sky import build_aerial_lut

    ref_atmo, port_atmo, ref_cam, port_cam, ref_origin, port_origin = states()
    t_lut = reference_transmittance()
    packed = pack_lut(jnp.asarray(t_lut))
    t_max = 4000 / 1e6
    port = build_aerial_lut(port_atmo, torch.from_numpy(t_lut.copy()), port_cam, port_origin, t_max)
    vol = port.volume.numpy()

    # the reference's one_slice (sky.py:464-483), slice by slice
    xs = ((jnp.arange(32, dtype=jnp.float32) + 0.5) / 32 - 0.5) * 2.0
    clip_uv = jnp.stack([jnp.broadcast_to(xs[None, :], (32, 32)), jnp.broadcast_to(xs[:, None], (32, 32))], -1)
    ones = jnp.ones((32, 32, 1), jnp.float32)
    view_h = jnp.concatenate([clip_uv, ones, ones], -1) @ ref_cam.inverse_projection.T
    direction = (view_h @ ref_cam.rotation.T)[..., :3]
    direction = direction / jnp.sqrt(jnp.maximum(jnp.sum(direction * direction, -1, keepdims=True), 1e-20))
    direction = direction * jnp.array([1.0, -1.0, 1.0], jnp.float32)
    origin = jnp.broadcast_to(ref_origin, direction.shape)
    light_dir = -ref_atmo.incident_direction_sun
    light_dir = light_dir / jnp.sqrt(jnp.maximum(jnp.sum(light_dir * light_dir), 1e-20))
    composed = []
    for frac in ((np.arange(16, dtype=np.float32) + 1.0) / 16) ** 2:
        dist = jnp.full((32, 32), np.float32(frac) * t_max, jnp.float32)
        pos = origin + dist[..., None] * direction
        composed.append(
            np.concatenate(
                [
                    np.asarray(luminance_scattering_integral(ref_atmo, packed, origin, direction, dist)),
                    np.asarray(sample_transmittance_segment(packed, ref_atmo, origin, pos)),
                    np.asarray(sample_transmittance_ray(packed, ref_atmo, pos, jnp.broadcast_to(light_dir, pos.shape))),
                ],
                -1,
            )
        )
    composed = np.stack(composed, 2)  # (32, 32, 16, 9)
    tol = np.array([SKY_TOL] * 3 + [T_TOL] * 6, np.float32)
    assert (np.abs(vol - composed) <= tol).all()
    built = np.asarray(ref_build(ref_atmo, packed, ref_cam, ref_origin, t_max).packed).reshape(32, 32, 16, 72)[..., :9]
    assert (np.abs(vol - built) <= tol + np.abs(composed - built)).all()
    np.testing.assert_allclose(port.t_sun0.numpy(), np.asarray(ref_build(ref_atmo, packed, ref_cam, ref_origin, t_max).t_sun0), atol=T_TOL, rtol=0)


def test_transmittance_samplers_close():
    """Ray/segment samplers (half-texel insets, direction flip) on the same
    LUT at seeded points."""
    from syzygy_tpu.kernels.atmosphere import pack_lut
    from syzygy_tpu.kernels.atmosphere import sample_transmittance_segment as ref_segment

    from syzygy_tpu_torch.kernels.atmosphere import sample_transmittance_segment

    ref_atmo, port_atmo = states()[:2]
    t_lut = reference_transmittance()
    rng = np.random.default_rng(9)

    def above_ground(n):  # 50 m .. 20 km altitude, random directions
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (d * rng.uniform(6.36005, 6.38, size=(n, 1))).astype(np.float32)

    a, b = above_ground(2048), above_ground(2048)
    ref = np.asarray(ref_segment(pack_lut(jnp.asarray(t_lut)), ref_atmo, jnp.asarray(a), jnp.asarray(b)))
    port = sample_transmittance_segment(
        torch.from_numpy(t_lut.copy()), port_atmo, torch.from_numpy(a), torch.from_numpy(b)
    ).numpy()
    np.testing.assert_allclose(port, ref, atol=T_TOL, rtol=0)
