"""The storage of ``tests/goldens/flagship_1080p.npz``'s date: the JAX
package's own quirk-exact frame under today's default storage against its
frame under f32 storage, and the port beside it under each (256x144,
``tools/parity_1080p.py``'s verdict scaled to the frame)."""

from __future__ import annotations

import numpy as np

from test_torch_common import port_config, to_numpy_dict
from test_torch_flagship import reference_flagship

FRAME_W, FRAME_H = 256, 144

GOLDEN_STORAGE = dict(pcf_f16=False, skyview_q8=False, skyview_f16=False, shadowless_strength_eps=0.0)


def parity_verdict(frame, other):
    """``tools/parity_1080p.py:98-125``: pixels over 0.01, and the RMSE of
    the rest."""
    d = np.abs(frame - other)
    outliers = d.max(axis=-1) > 0.01
    return outliers, float(np.sqrt((d[~outliers] ** 2).mean()))


def test_reference_leaves_its_f32_frame_under_todays_storage():
    """Why ``chip_smoke.py`` holds the frame it compares with
    ``flagship_1080p.npz`` to ``GOLDEN_STORAGE`` and an f32 atlas. The
    golden holds the JAX package's frame at the f32 storage of its date;
    f16 PCF tables and an f16 atlas, the q8 sky-view and the dim-light
    shadow skip became defaults later. Here the reference itself renders
    ``tools/parity_1080p.py``'s config at 256x144 under both storages:

    * its frame under today's defaults fails that tool's verdict against
      its own f32-storage frame: the self-shadowing on the pieces' lit
      sides moves at about 0.5% of the pixels (the 1080p frame on the card
      showed 0.54% against the golden), where 0.01% may;
    * the f16 PCF alone does it: with ``pcf_f16=False`` and every other
      default the verdict passes;
    * the port follows the reference on each side with no pixel over 0.01
      and a shaded RMSE <= 1e-3, and moves the same pixels between the two
      storages as the reference does."""
    from syzygy_tpu.renderer import RenderConfig, render_frame
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    from syzygy_tpu_torch.interop import from_reference
    from syzygy_tpu_torch.renderer.frame import render_frame as port_frame

    scene, lib = reference_flagship()
    params = pack_frame_params(scene, FRAME_W / FRAME_H)
    exact = dict(
        width=FRAME_W, height=FRAME_H, skyview_width=256, skyview_height=128,
        n_shadow_maps=4, aerial_lut=False, fast_sky_reflection=False,
    )
    ref, port = {}, {}
    for name, storage, atlas_f16 in (("today", {}, True), ("f32", GOLDEN_STORAGE, False), ("f32_pcf", dict(pcf_f16=False), True)):
        config = RenderConfig(**exact, **storage)
        geometry = pack_geometry(scene, lib, quad_pack=False, joint_pack=False, atlas_f16=atlas_f16)
        ref[name] = np.asarray(render_frame(geometry, params, config))
        if name != "f32_pcf":
            geo_t, params_t = from_reference(to_numpy_dict(geometry), to_numpy_dict(params), "cpu")
            port[name] = port_frame(geo_t, params_t, port_config(config)).numpy()
    allowed = FRAME_W * FRAME_H // 10_000

    moved_ref, _ = parity_verdict(ref["today"], ref["f32"])
    share = moved_ref.sum() / moved_ref.size
    print(f"reference, today's storage vs f32 storage: {moved_ref.sum()} pixels over 0.01 ({share:.2%}), {allowed} allowed")
    assert moved_ref.sum() > 10 * allowed and 0.002 < share < 0.012
    still, shaded = parity_verdict(ref["f32_pcf"], ref["f32"])
    assert still.sum() <= allowed and shaded <= 1e-3

    for name in ("today", "f32"):
        outliers, shaded = parity_verdict(port[name], ref[name])
        print(f"port vs reference, {name} storage: {outliers.sum()} pixels over 0.01, shaded RMSE {shaded:.3e}")
        assert outliers.sum() <= allowed and shaded <= 1e-3
    moved_port, _ = parity_verdict(port["today"], port["f32"])
    assert (moved_port ^ moved_ref).sum() <= allowed
    crossed, _ = parity_verdict(port["today"], ref["f32"])
    assert (crossed ^ moved_ref).sum() <= allowed
