"""Reference inputs -> port tensors, for feeding both packages identical data.

The caller converts the JAX package's ``GeometryStatic`` and ``FrameParams``
to dicts of numpy arrays on its side (``np.asarray`` per leaf; nested
``atmosphere``/``spots`` as dicts too), so this module never sees JAX.
"""

from __future__ import annotations

import numpy as np

from syzygy_tpu_torch.device import to_tensor
from syzygy_tpu_torch.scene.atmosphere import AtmosphereRaw
from syzygy_tpu_torch.scene.lights import SpotRaw
from syzygy_tpu_torch.scene.pack import FrameParams, FrameParamSpec, geometry_to_device


def from_reference(geometry_np: dict, params_np: dict, device):
    """(GeometryStatic, FrameParams) tensors on ``device`` from the
    reference's leaves, ``tex_rects_mips`` and the debug segments
    included. The geometry dict must hold the plain atlas
    (``pack_geometry(quad_pack=False, joint_pack=False)``); the joint
    tables, which the port does not have, are ignored."""
    if geometry_np["tex_atlas"].shape[-1] != 4:
        raise ValueError("pass the reference geometry packed with quad_pack=False")
    geometry = geometry_to_device(geometry_np, device)

    def up(x):
        return to_tensor(x, device)

    fields = {}
    for name in FrameParams._fields:
        value = params_np[name]
        if name == "atmosphere":
            fields[name] = AtmosphereRaw(*[up(value[k]) for k in AtmosphereRaw._fields])
        elif name == "spots":
            fields[name] = SpotRaw(*[up(value[k]) for k in SpotRaw._fields])
        else:
            fields[name] = up(value)
    return geometry, FrameParams(**fields)


def packed_from_reference(buffer, spec):
    """The reference's flattened ``(buffer, spec)`` pair
    (``flatten_frame_params``/``frame_param_spec``) -> (numpy f32 buffer,
    the port's :class:`FrameParamSpec`) for ``render_frame_packed``."""
    return np.asarray(buffer, np.float32), FrameParamSpec(
        tuple(tuple(s) for s in spec.shapes), tuple(spec.dtypes), tuple(spec.offsets), int(spec.total)
    )
