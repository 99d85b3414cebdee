"""Port host packing and frame state vs the reference.

(a) ``pack_geometry``/``pack_frame_params`` built by the port's own numpy
host code equal the reference's arrays bitwise (the plain atlas, i.e. the
reference's ``pack_geometry(quad_pack=False, joint_pack=False)``).
(b) Every ``FrameState`` leaf within 1e-6 relative of the reference's
(``prepare_frame_state`` under ``jax.jit``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from test_torch_common import (
    GOLDEN_W,
    GOLDEN_H,
    port_dense_scene,
    port_golden_scene,
    reference_dense_scene,
    reference_golden_scene,
    reference_inputs,
    to_numpy_dict,
)

SCENES = {
    "default": (lambda: reference_golden_scene()[:2], lambda: port_golden_scene()[:2]),
    "dense": (reference_dense_scene, port_dense_scene),
}


def _flatten(d, prefix=""):
    for key, value in d.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield prefix + key, value


@pytest.mark.parametrize("which", ["default", "dense"])
def test_pack_geometry_bitwise(which):
    """Tolerance: exact (same dtypes, same bits) for every leaf."""
    from syzygy_tpu.scene import pack_geometry

    from syzygy_tpu_torch.scene.pack import GeometryStatic, pack_geometry_host

    ref_scene, port_scene = (make() for make in SCENES[which])
    ref = to_numpy_dict(pack_geometry(*ref_scene, quad_pack=False, joint_pack=False))
    port = pack_geometry_host(*port_scene)
    assert set(port) == set(GeometryStatic._fields) - {"tex_rects_mips"}  # no pyramid on either side
    assert "tex_rects_mips" not in ref
    for name in port:
        assert port[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)


@pytest.mark.parametrize("which", ["default", "dense"])
def test_pack_frame_params_bitwise(which):
    """Tolerance: exact for every leaf, the debug-line leaves included."""
    from syzygy_tpu.scene import pack_frame_params

    from syzygy_tpu_torch.scene.pack import pack_frame_params as port_pack

    ref_scene, port_scene = (make() for make in SCENES[which])
    ref = dict(_flatten(to_numpy_dict(pack_frame_params(ref_scene[0], GOLDEN_W / GOLDEN_H))))
    port = dict(
        _flatten(to_numpy_dict(port_pack(port_scene[0], GOLDEN_W / GOLDEN_H)))
    )
    assert set(ref) == set(port)
    for name, value in port.items():
        assert np.asarray(value).dtype == ref[name].dtype, name
        np.testing.assert_array_equal(value, ref[name], err_msg=name)


def test_geometry_upload_keeps_arrays():
    """``pack_geometry`` on a device carries the host arrays unchanged."""
    from syzygy_tpu_torch.scene.pack import pack_geometry, pack_geometry_host

    scene, lib = port_golden_scene()[:2]
    host = pack_geometry_host(scene, lib)
    dev = pack_geometry(scene, lib, "cpu")
    assert dev.tex_rects_mips is None
    for name, value in host.items():
        np.testing.assert_array_equal(getattr(dev, name).numpy(), value, err_msg=name)


@pytest.mark.parametrize("which", ["default", "dense"])
def test_frame_state_close(which):
    """Tolerance: 1e-6 relative to each leaf's magnitude."""
    from syzygy_tpu.scene.pack import prepare_frame_state as reference_prepare

    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    _, params, _, params_t, _ = reference_inputs(which)
    ref = dict(_flatten(to_numpy_dict(jax.jit(reference_prepare)(params))))
    port_state = prepare_frame_state(params_t)
    port = dict(_flatten(to_numpy_dict(port_state)))
    assert set(ref) == set(port)
    for name, value in port.items():
        value = np.asarray(value)
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(value, ref[name], rtol=1e-6, atol=1e-6 * scale, err_msg=name)


def test_frame_state_follows_device_of_params():
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    _, _, _, params_t, _ = reference_inputs("default")
    state = prepare_frame_state(params_t)
    assert state.models.device == torch.device("cpu")
    assert state.camera.projection.dtype == torch.float32


def test_geometry_helpers_match_reference():
    """math/geometry on seeded random inputs vs the reference: 1e-6
    relative to each output's magnitude (transcendentals differ in the
    last bit between XLA and torch)."""
    import jax.numpy as jnp

    from syzygy_tpu.math import geometry as ref

    from syzygy_tpu_torch.math import geometry as port

    rng = np.random.default_rng(21)
    eulers = rng.uniform(-3, 3, size=(16, 3)).astype(np.float32)
    mats = rng.normal(size=(16, 4, 4)).astype(np.float32) + 4 * np.eye(4, dtype=np.float32)
    eye, center = rng.normal(size=(2, 3)).astype(np.float32) * 10
    lo = rng.uniform(-5, 0, size=3).astype(np.float32)
    hi = lo + rng.uniform(1, 5, size=3).astype(np.float32)
    t = torch.from_numpy

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-6 * max(1.0, float(np.abs(b).max())))

    close(port.orientate4(t(eulers)), ref.orientate4(eulers))
    close(port.inverse4(t(mats)), ref.inverse4(mats))
    close(port.forward_from_eulers(t(eulers)), ref.forward_from_eulers(eulers))
    close(port.eulers_from_forward(t(eulers)), ref.eulers_from_forward(eulers))
    close(port.view_vk(t(eye), t(eulers[0])), ref.view_vk(eye, eulers[0]))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    close(port.perspective_vk(f32(70.0), f32(1.7), f32(0.1), f32(1e4)), ref.perspective_vk(70.0, 1.7, 0.1, 1e4))
    close(
        port.look_at_vk(t(eye), t(center), port.world_up("cpu")),
        ref.look_at_vk(eye, center, ref.WORLD_UP),
    )
    close(port.look_at_vk_safe(t(eye), t(center)), ref.look_at_vk_safe(eye, center))
    view = ref.view_vk(jnp.zeros(3), eulers[1])
    close(
        port.ortho_aabb_vk(t(np.array(view)), port.AABB(t((lo + hi) / 2), t((hi - lo) / 2))),
        ref.ortho_aabb_vk(view, ref.AABB((lo + hi) / 2, (hi - lo) / 2)),
    )


def test_light_stacks_match_reference():
    """make_directional + stack_directional / stack_spot (fixed capacity,
    zero-light padding, counts) vs the reference: 1e-6 relative."""
    import jax.numpy as jnp

    from syzygy_tpu.math.geometry import AABB as RefAABB
    from syzygy_tpu.scene import lights as ref

    from syzygy_tpu_torch.math.geometry import AABB
    from syzygy_tpu_torch.scene import lights as port

    t = lambda x: torch.tensor(x, dtype=torch.float32)
    center, half = [1.0, -2.0, 3.0], [4.0, 5.0, 6.0]
    eulers = [0.7, 0.0, -1.1]
    r_dir = ref.make_directional([1.0, 0.9, 0.8, 1.0], 3.0, eulers, RefAABB(jnp.asarray(center), jnp.asarray(half)))
    p_dir = port.make_directional(t([1.0, 0.9, 0.8, 1.0]), t(3.0), t(eulers), AABB(t(center), t(half)))
    r_stack, r_count = ref.stack_directional([r_dir], capacity=4)
    p_stack, p_count = port.stack_directional([p_dir], "cpu", capacity=4)
    assert int(p_count) == int(r_count) == 1
    for name in r_stack._fields:
        a, b = getattr(p_stack, name).numpy(), np.asarray(getattr(r_stack, name))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * max(1.0, float(np.abs(b).max())), err_msg=name)

    params = ref.SpotlightParams(color=(1.0, 0.0, 0.0, 1.0), euler_angles=(0.3, 0.0, 0.5), position=(1.0, -4.0, 2.0))
    raw, n = ref.spot_raw([params], capacity=3)
    r_spots, r_n = ref.stack_spot([ref.make_spot(params)], capacity=3)
    p_raw = port.SpotRaw(*[torch.from_numpy(np.asarray(x)) for x in raw])
    p_batched = port.make_spot_batched(p_raw)
    p_spots, p_n = port.stack_spot([type(p_batched)(*[x[0] for x in p_batched])], "cpu", capacity=3)
    assert int(p_n) == int(r_n) == n == 1
    for name in r_spots._fields:
        a, b = getattr(p_spots, name).numpy(), np.asarray(getattr(r_spots, name))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * max(1.0, float(np.abs(b).max())), err_msg=name)


@pytest.mark.parametrize("framing", ["flagship", "dense", "seeded"])
def test_eulers_from_forward_bitwise(framing):
    """Tolerance: exact. The camera framings of ``bench.py`` (the chess
    flagship's (13, -8, -14) -> (0, -1, 0), the dense field's (18, -16,
    -22) -> (0, -6, 0)) and 64 seeded forward vectors, one at a time as a
    camera is framed: the port's (pitch, 0, yaw) carry the reference's
    bits. Its pitch is XLA's ``asin`` decomposition, 2 * atan2(x, 1 +
    sqrt((1 - x)(1 + x))), on the same ``atan2f``."""
    import jax.numpy as jnp

    from syzygy_tpu.math.geometry import eulers_from_forward as ref

    from syzygy_tpu_torch.math.geometry import eulers_from_forward as port

    if framing == "flagship":
        forwards = [np.float32([0.0, -1.0, 0.0]) - np.float32([13.0, -8.0, -14.0])]
    elif framing == "dense":
        forwards = [np.float32([0.0, -6.0, 0.0]) - np.float32([18.0, -16.0, -22.0])]
    else:
        forwards = list(np.random.default_rng(8).normal(size=(64, 3)).astype(np.float32) * 10)
    for f in forwards:
        expect = np.asarray(ref(jnp.asarray(f)))
        got = port(torch.from_numpy(np.ascontiguousarray(f))).numpy()
        np.testing.assert_array_equal(got.view(np.int32), expect.view(np.int32), err_msg=str(f))
