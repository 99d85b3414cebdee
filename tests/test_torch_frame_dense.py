"""(f) for the raster-bound scene: the dense sphere field (64 x sphere(8,
16), 14,336 triangles) through the port's ``render_frame`` vs the
reference's, golden config, afternoon sun (time 0.6): RMSE <= 1e-3 and
max abs <= 2e-2, as for the default scene."""

from __future__ import annotations

import numpy as np

from test_torch_common import port_dense_scene, reference_dense_scene, reference_golden_scene, rmse


def test_dense_frame_matches_reference():
    from syzygy_tpu.renderer import render_frame as reference_render
    from syzygy_tpu.scene import pack_frame_params as ref_params
    from syzygy_tpu.scene import pack_geometry as ref_geometry

    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    scene, lib = reference_dense_scene(sun_time=0.6)
    config = reference_golden_scene()[2]
    ref = np.asarray(reference_render(ref_geometry(scene, lib), ref_params(scene, 2.0), config))

    scene, lib = port_dense_scene(sun_time=0.6)
    config = RenderConfig(width=256, height=128, shadow_dim=256, skyview_width=128, skyview_height=64)
    port = render_frame(
        pack_geometry(scene, lib, "cpu"), upload_frame_params(pack_frame_params(scene, 2.0), "cpu"), config
    ).numpy()
    assert port.shape == ref.shape and np.isfinite(port).all()
    assert rmse(port, ref) <= 1e-3
    assert np.abs(port - ref).max() <= 2e-2
