"""The reference's own compiled-vs-op-by-op spread under each port test
that compares with a compiled reference in the sky and atmosphere paths.

For every such comparison in ``test_torch_atmosphere.py``,
``test_torch_features.py``, ``test_torch_flagship.py`` and
``test_torch_sky_exact.py``, on that test's inputs, this prints the
reference's spread (``jax.jit`` against ``jax.disable_jit``) beside the
test's bound, as the ratio spread / bound. A ratio above 1 names a
comparison that one x86 host's compiled arithmetic can fail without a fault
of the port: that test needs the op-by-op anchor of
``test_torch_common.reference_compiled_and_op_by_op``. The comparisons that
already anchor on the op-by-op value, on a float64 evaluation or on the
spread itself are listed at the end.

    JAX_PLATFORMS=cpu python tests/torch_spread_audit.py

takes a few minutes on the CPU (every reference runs twice, once op by op).
"""

from __future__ import annotations

import dataclasses
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_common import reference_compiled_and_op_by_op, rmse  # noqa: E402

LUT_ATOL, LUT_RTOL = 2e-5, 2e-4


def report(name, spread, bound):
    print(f"{name:62s} spread {spread:.3e}  bound {bound:.3e}  ratio {spread / bound:.3f}", flush=True)


def lut_ratio(compiled, op_by_op, atol=LUT_ATOL, rtol=LUT_RTOL):
    """The largest |compiled - op_by_op| over assert_allclose's bound."""
    return float(np.max(np.abs(compiled - op_by_op) / (atol + rtol * np.abs(compiled))))


def atmosphere_luts():
    import test_torch_atmosphere as ta
    from syzygy_tpu.kernels.atmosphere import compute_skyview_lut, compute_transmittance_lut, pack_lut

    ref_atmo, _, _, _, ref_origin, _ = ta.states()
    compiled, op_by_op = reference_compiled_and_op_by_op(
        lambda atmo: compute_transmittance_lut(atmo, width=512, height=128), ref_atmo
    )
    # its test holds the port within T_TOL of a float64 evaluation, and
    # within T_TOL + |reference - float64| of the compiled LUT
    exact = ta._transmittance_f64(ref_atmo, 512, 128)
    report(
        "atmosphere: transmittance LUT 512x128 (per texel; f64-anchored)",
        float(np.max(np.abs(compiled - op_by_op) / (ta.T_TOL + np.abs(compiled - exact)))), 1.0,
    )
    t_lut = pack_lut(jnp.asarray(ta.reference_transmittance()))
    for w, h in ((128, 64), (2048, 1024)):
        compiled, op_by_op = reference_compiled_and_op_by_op(
            lambda atmo, origin, lut: compute_skyview_lut(atmo, origin, lut, width=w, height=h),
            ref_atmo, ref_origin, t_lut,
        )
        horizon = np.abs((np.arange(h) + 0.5) / h - 0.5) <= 0.04
        spread = np.abs(compiled - op_by_op)
        report(f"atmosphere: sky-view LUT {w}x{h}, off the horizon (max abs)", spread[~horizon].max(), ta.SKY_TOL)
        report(f"atmosphere: sky-view LUT {w}x{h}, horizon rows (max abs)", spread[horizon].max(), 5e-3)


def sky_functions():
    import test_torch_sky_exact as se
    from syzygy_tpu.kernels import sky as reference
    from syzygy_tpu.kernels.atmosphere import compute_skyview_lut, luminance_scattering_integral_fast, raycast_atmosphere

    atmo, _, t_lut, origin = se.atmosphere_inputs()
    rng = np.random.default_rng(11)  # test_fast_integral_matches_reference's rays
    direction = rng.normal(size=(24, 32, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    o = np.broadcast_to(origin, direction.shape).copy()
    dist = np.asarray(raycast_atmosphere(atmo, jnp.asarray(o), jnp.asarray(direction)))
    pair = reference_compiled_and_op_by_op(luminance_scattering_integral_fast, atmo, t_lut, o, direction, dist)
    report("sky_exact: luminance_scattering_integral_fast (LUT class)", lut_ratio(*pair), 1.0)
    for fast, rowwise, name in ((True, True, "fast"), (True, False, "fast_texel")):
        pair = reference_compiled_and_op_by_op(
            lambda atmo, origin, lut: compute_skyview_lut(atmo, origin, lut, width=64, height=32, fast=fast, rowwise=rowwise),
            atmo, origin, t_lut,
        )
        report(f"sky_exact: per-texel sky-view LUT [{name}] (LUT class)", lut_ratio(*pair), 1.0)

    # test_environment_functions_match_reference's rays
    sky_lut = np.asarray(compute_skyview_lut(atmo, jnp.asarray(origin), jnp.asarray(t_lut), width=64, height=32))
    rng = np.random.default_rng(17)
    n = 2048
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    to_sun = -np.asarray(atmo.incident_direction_sun)
    direction[: n // 2] = to_sun + 0.02 * direction[: n // 2]
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    direction = direction[np.abs(direction[:, 1]) > 0.1]
    ground = direction[direction[:, 1] < 0]
    og = np.broadcast_to(origin, ground.shape).copy()
    _, dist = reference._hit_planet(atmo, jnp.asarray(og), jnp.asarray(ground))
    pair = reference_compiled_and_op_by_op(reference.sample_ground, atmo, t_lut, og, ground, dist)
    report("sky_exact: sample_ground (LUT class)", lut_ratio(*pair), 1.0)
    o = np.broadcast_to(origin, direction.shape).copy()
    (env_c, disk_c), (env_o, disk_o) = reference_compiled_and_op_by_op(
        reference.sample_environment, atmo, t_lut, sky_lut, o, direction
    )
    report("sky_exact: sample_environment (LUT class)", lut_ratio(env_c, env_o), 1.0)
    report("sky_exact: sample_environment's sun disk (max abs)", np.abs(disk_c - disk_o).max(), 5e-3)


def frames():
    import test_torch_features as tf
    import test_torch_sky_exact as se
    from syzygy_tpu.renderer import render_frame
    from syzygy_tpu.renderer.frame import render_frame_rows

    geometry, params, _, _, config = se.frame_inputs()
    for name, overrides in (
        ("quirk_exact", dict(aerial_lut=False, fast_sky_reflection=False)),
        ("exact_fast_reflection", dict(aerial_lut=False)),
        ("exact_fast_sky", dict(aerial_lut=False, fast_sky=True)),
        ("aerial_fast_sky", dict(fast_sky=True)),
    ):
        c = dataclasses.replace(config, **overrides)
        pair = reference_compiled_and_op_by_op(lambda g, p: render_frame(g, p, c), geometry, params)
        report(f"sky_exact: frame [{name}] (RMSE)", rmse(*pair), 1e-3)

    geometry, params, _, _, config = tf.flagship_inputs()
    for name, overrides in (
        ("lines", dict(debug_lines=True)),
        ("lines_supersample2", dict(debug_lines=True, supersample=2, width=tf.W // 2, height=tf.H // 2)),
    ):
        c = dataclasses.replace(config, **overrides)
        pair = reference_compiled_and_op_by_op(lambda g, p: render_frame(g, p, c), geometry, params)
        report(f"features: debug-line frame [{name}] (RMSE)", rmse(*pair), 1e-3)
    geometry, params, _, _, config = tf.flagship_inputs(False)
    pair = reference_compiled_and_op_by_op(lambda g, p: render_frame_rows(g, p, config, 64, 128), geometry, params)
    report("features: render_frame_rows rows [64, 192) (RMSE)", rmse(*pair), 1e-3)


ANCHORED = """Already anchored, not measured here:
  atmosphere: aerial volume, held to its slices composed op by op and to the compiled build within the spread
  atmosphere: q8 codes and samples, t_seg rows, transmittance samplers: eager reference calls (op by op)
  sky_exact: per-texel sky-view LUT [texel] and the quirk-exact pass: the spread per row
  sky_exact: sample_skyview, sample_skyview_ground, sample_sun_disk: eager reference calls (op by op)
  flagship: the metallic-bounce pass and its sky stages: the op-by-op pass and the spread
  flagship: frames against flagship_*_512x288.npz (stored goldens, not a reference run on this host)
  features: frame without the atmosphere (no sky pass); compute demos, gradients (no sky or atmosphere)"""


if __name__ == "__main__":
    atmosphere_luts()
    sky_functions()
    frames()
    print(ANCHORED)
