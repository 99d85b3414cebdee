"""The two small reference functions of ``syzygy_tpu`` that nothing on the
frame calls, against their ports: ``kernels/atmosphere.py::
sample_transmittance_raymarch_step`` and ``math/geometry.py::random_quat``.

Tolerances: the raymarch step is held within 1e-6 absolute of the
reference's op-by-op value (``jax.disable_jit``, its f32 formulas one op at
a time) and within 1e-5 beyond the reference's own compiled-vs-op-by-op
spread of its compiled value, whose fusions contract differently on other
x86 hosts (``test_torch_common.reference_compiled_and_op_by_op``; the
compiled division of two LUT samples moves by up to ~2e-4 on the steps
here). The quaternion's arithmetic is fed the reference's own uniforms and
held bitwise where torch's and XLA's ``sin``/``cos`` of both angles agree.
Where one differs in the last bit, x and y are held to 2 f32 ulp, and w
and z, which are scaled by s = sqrt((1 - |xy|^2) / |uv|^2), to 2 ulp plus
that last bit carried through s: 1 - |xy|^2 cancels, and turns 2^-23 of
|xy|^2 into 2^-23 / (1 - |xy|^2) of s.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import reference_compiled_and_op_by_op

LUTS = os.path.join(os.path.dirname(__file__), "goldens", "atmosphere_luts.npz")
N_STEPS = 4096
N_KEYS = 32


@functools.lru_cache(maxsize=None)
def raymarch_inputs():
    """(reference atmosphere, port atmosphere, LUT, radius, mu, mu_sun,
    step distance) as numpy: the default atmosphere packed by the
    reference, the golden transmittance LUT, seeded steps (half of them
    up rays, half down, one in eight under 1e-7)."""
    from syzygy_tpu.scene.atmosphere import Atmosphere, atmosphere_raw, pack_atmosphere

    from syzygy_tpu_torch.scene.atmosphere import AtmospherePacked

    ref_atmo = pack_atmosphere(atmosphere_raw(Atmosphere()))
    port_atmo = AtmospherePacked(**{k: torch.tensor(np.asarray(v)) for k, v in ref_atmo._asdict().items()})
    lut = np.load(LUTS)["transmittance"]
    rng = np.random.default_rng(11)
    planet, top = float(ref_atmo.planet_radius_mm), float(ref_atmo.atmosphere_radius_mm)
    radius = rng.uniform(planet, top, N_STEPS).astype(np.float32)
    mu = rng.uniform(-1.0, 1.0, N_STEPS).astype(np.float32)
    mu_sun = rng.uniform(-1.0, 1.0, N_STEPS).astype(np.float32)
    step = rng.uniform(0.0, top - planet, N_STEPS).astype(np.float32)
    step[::8] = rng.uniform(0.0, 1e-7, step[::8].shape).astype(np.float32)
    return ref_atmo, port_atmo, lut, radius, mu, mu_sun, step


def _reference_step(atmo, lut, radius, mu, mu_sun, step):
    from syzygy_tpu.kernels.atmosphere import RaymarchStep, sample_transmittance_raymarch_step

    return sample_transmittance_raymarch_step(atmo, lut, RaymarchStep(radius, mu, mu_sun), step)


def test_raymarch_step_matches_reference():
    from syzygy_tpu_torch.kernels.atmosphere import RaymarchStep, sample_transmittance_raymarch_step

    ref_atmo, port_atmo, lut, radius, mu, mu_sun, step = raymarch_inputs()
    compiled, op_by_op = reference_compiled_and_op_by_op(
        _reference_step, ref_atmo, jnp.asarray(lut), *(jnp.asarray(a) for a in (radius, mu, mu_sun, step))
    )
    t = [torch.from_numpy(a) for a in (radius, mu, mu_sun, step)]
    port = sample_transmittance_raymarch_step(
        port_atmo, torch.from_numpy(lut), RaymarchStep(t[0], t[1], t[2]), t[3]
    ).numpy()
    assert port.shape == (N_STEPS, 3) and port.dtype == np.float32
    tiny = step < 1e-7
    up = mu > 0.0
    # every branch of the reference is taken: up, down, and the tiny step
    assert tiny.sum() > 100 and (up & ~tiny).sum() > 1000 and (~up & ~tiny).sum() > 1000
    assert np.all(port[tiny] == 1.0) and np.all(op_by_op[tiny] == 1.0)
    assert np.all((port >= 0.0) & (port <= 1.0))
    # the steps span the LUT's range, not only its saturated corners
    assert np.ptp(port[~tiny]) > 0.5
    err_op = np.abs(port - op_by_op).max()
    spread = np.abs(op_by_op - compiled)
    excess = np.abs(port - compiled) - spread
    print(
        f"raymarch step: max |port - op by op| {err_op:.3e}, |port - compiled| "
        f"{np.abs(port - compiled).max():.3e}, the reference's own spread {spread.max():.3e}, "
        f"largest excess over it {excess.max():.3e}"
    )
    assert err_op <= 1e-6
    assert np.all(excess <= 1e-5)


@functools.lru_cache(maxsize=None)
def reference_quats():
    """(uniforms (N, 4), quaternions (N, 4)) of the reference for keys 0..N-1:
    the uniforms drawn in ``random_quat``'s own split order (r1, theta1,
    r2, theta2), the quaternions from ``random_quat(key)`` itself."""
    from syzygy_tpu.math.geometry import random_quat

    uniforms, quats = [], []
    for seed in range(N_KEYS):
        key = jax.random.PRNGKey(seed)
        draws = []
        for k in jax.random.split(key):
            ka, kb = jax.random.split(k)
            draws += [jax.random.uniform(ka), jax.random.uniform(kb)]
        uniforms.append(np.array([np.asarray(d) for d in draws], np.float32))
        quats.append(np.asarray(random_quat(key)))
    return np.stack(uniforms), np.stack(quats)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in f32 units in the last place (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_random_quat_math_matches_reference_draws():
    from syzygy_tpu_torch.math.geometry import quat_from_uniforms

    uniforms, want = reference_quats()
    got = np.stack([quat_from_uniforms(torch.from_numpy(u)).numpy() for u in uniforms])
    assert got.dtype == np.float32 and got.shape == (N_KEYS, 4)
    # The angles are bitwise the reference's; where torch's sin/cos of one
    # differs from XLA's, the components it feeds may move by the last bit.
    theta = (uniforms[:, [1, 3]] * np.float32(2.0)) * np.float32(np.pi)
    theta_t = torch.from_numpy(np.ascontiguousarray(theta))
    trig_agrees = np.all(
        (torch.cos(theta_t).numpy() == np.asarray(jnp.cos(jnp.asarray(theta))))
        & (torch.sin(theta_t).numpy() == np.asarray(jnp.sin(jnp.asarray(theta)))),
        axis=1,
    )
    exact = np.all(got == want, axis=1)
    print(f"random_quat: {exact.sum()} of {N_KEYS} keys bitwise, sin/cos agree on {trig_agrees.sum()}")
    assert np.all(exact[trig_agrees])
    assert exact.sum() >= N_KEYS // 2
    assert np.all(_ulps(got[:, 1:3], want[:, 1:3]) <= 2)
    r1 = np.sqrt(uniforms[:, 0].astype(np.float64))
    carried = np.abs(want[:, [0, 3]]) * 2.0**-23 / (1.0 - r1 * r1)[:, None]
    ulp = np.spacing(np.abs(want[:, [0, 3]]))
    assert np.all(np.abs(got[:, [0, 3]] - want[:, [0, 3]]) <= 2 * ulp + carried)


def test_random_quat_unit_norm():
    from syzygy_tpu_torch.math.geometry import random_quat

    norms, quats = [], set()
    for seed in range(100):
        q = random_quat(torch.Generator().manual_seed(seed), "cpu")
        assert q.shape == (4,) and q.dtype == torch.float32 and q.device.type == "cpu"
        norms.append(float(torch.linalg.vector_norm(q.double())))
        quats.add(tuple(q.tolist()))
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)
    assert len(quats) == 100  # each seed its own rotation
    again = random_quat(torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(again, random_quat(torch.Generator().manual_seed(7), "cpu"))
