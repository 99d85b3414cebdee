"""The ``RenderConfig`` modes of the PCF and the sky's LUT storage, as
whole frames of the golden scene and config (256x128).

* ``pcf_q8`` and ``lut_f16`` change the image: the port against the
  reference under the same mode, RMSE <= 1e-4 and max <= 2e-2, and each
  moves the port's frame away from its default frame.
* ``share_sun_pcf`` leaves the port's default frame bitwise as it is.
* ``render_frame_rows`` and ``render_frame_packed`` honour the modes:
  stacked row blocks and the packed entry point are bitwise
  ``render_frame`` under all of them at once.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_common import port_golden_scene, reference_golden_scene, rmse

MODE_RMSE = 1e-4
MODE_MAX = 2e-2
IMAGE_MODES = {"pcf_q8": dict(pcf_q8=True), "lut_f16": dict(lut_f16=True)}
LAYOUT_MODES = {"share_sun_pcf": dict(share_sun_pcf=True)}
ALL_MODES = dict(pcf_q8=True, lut_f16=True, share_sun_pcf=True)


@functools.lru_cache(maxsize=None)
def reference_frame(mode: str) -> np.ndarray:
    from syzygy_tpu.renderer import render_frame
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    scene, lib, config = reference_golden_scene()
    config = dataclasses.replace(config, **IMAGE_MODES[mode])
    return np.asarray(render_frame(pack_geometry(scene, lib), pack_frame_params(scene, 2.0), config))


@functools.lru_cache(maxsize=None)
def port_inputs():
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry

    scene, lib, config = port_golden_scene()
    return pack_geometry(scene, lib, "cpu"), pack_frame_params(scene, 2.0), config


@functools.lru_cache(maxsize=None)
def _port_frame(overrides: tuple) -> np.ndarray:
    from syzygy_tpu_torch.renderer.frame import render_frame
    from syzygy_tpu_torch.scene.pack import upload_frame_params

    geometry, host, config = port_inputs()
    config = dataclasses.replace(config, **dict(overrides))
    return render_frame(geometry, upload_frame_params(host, "cpu"), config).numpy()


def port_frame(**overrides) -> np.ndarray:
    return _port_frame(tuple(sorted(overrides.items())))


@pytest.mark.parametrize("mode", list(IMAGE_MODES))
def test_image_modes_match_reference(mode):
    port, ref = port_frame(**IMAGE_MODES[mode]), reference_frame(mode)
    assert port.shape == ref.shape == (128, 256, 3)
    assert np.isfinite(port).all()
    moved = rmse(port, port_frame())
    print(f"{mode}: RMSE {rmse(port, ref):.3e}, max {np.abs(port - ref).max():.3e}, vs the default {moved:.3e}")
    assert rmse(port, ref) <= MODE_RMSE
    assert np.abs(port - ref).max() <= MODE_MAX
    assert moved > 0.0  # the mode is live


@pytest.mark.parametrize("mode", list(LAYOUT_MODES))
def test_layout_modes_keep_the_frame(mode):
    np.testing.assert_array_equal(port_frame(**LAYOUT_MODES[mode]), port_frame())


@pytest.mark.parametrize("entry", ["rows", "packed"])
def test_entry_points_honour_the_modes(entry):
    """Both go through ``render_frame_linear``; under every mode at
    once they stay bitwise ``render_frame`` (the golden target needs no
    padding: 128 rows, 256 columns)."""
    from syzygy_tpu_torch.renderer.frame import render_frame_packed, render_frame_rows
    from syzygy_tpu_torch.scene.pack import flatten_frame_params, frame_param_spec, upload_frame_params

    geometry, host, config = port_inputs()
    config = dataclasses.replace(config, **ALL_MODES)
    whole = port_frame(**ALL_MODES)
    if entry == "rows":
        params = upload_frame_params(host, "cpu")
        out = torch.cat([render_frame_rows(geometry, params, config, r0, 64) for r0 in (0, 64)]).numpy()
    else:
        spec = frame_param_spec(host)
        out = render_frame_packed(geometry, flatten_frame_params(host, spec), spec, config).numpy()
    np.testing.assert_array_equal(out, whole)
