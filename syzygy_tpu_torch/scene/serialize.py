"""Scene serialization: save/load the full editable state as JSON.

Port of ``syzygy_tpu/scene/serialize.py``, in the same format (version 1),
so a file either package writes loads in the other: the cameras, the
atmosphere, the sun animation, every instance's transforms, originals and
material overrides, the spotlights, and each instance's mesh by name for
an asset source to resolve. ``camera`` (one camera) is the legacy key.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from syzygy_tpu_torch.assets.types import MaterialData
from syzygy_tpu_torch.scene.atmosphere import Atmosphere, SunAnimation
from syzygy_tpu_torch.scene.camera import Camera
from syzygy_tpu_torch.scene.lights import SpotlightParams
from syzygy_tpu_torch.scene.scene import InstanceAnimation, MeshInstance, Scene, TransformHost

VERSION = 1


def _tolist(x):
    return np.asarray(x, np.float32).tolist()


def _transform_dict(t: TransformHost) -> dict:
    return {
        "translation": _tolist(t.translation),
        "euler_angles": _tolist(t.euler_angles),
        "scale": _tolist(t.scale),
    }


def _transform_from(d: dict) -> TransformHost:
    return TransformHost.make(d["translation"], d["euler_angles"], d["scale"])


def _tuples(d: dict) -> dict:
    """JSON lists back to the tuples the dataclasses hold."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def scene_to_dict(scene: Scene) -> dict:
    return {
        "version": VERSION,
        "cameras": [dataclasses.asdict(c) for c in scene.cameras],
        "camera_index": scene.camera_index,
        "camera_speed": scene.camera_speed,
        "atmosphere": dataclasses.asdict(scene.atmosphere),
        "sun_animation": dataclasses.asdict(scene.sun_animation),
        "render_atmosphere": scene.render_atmosphere,
        "time_elapsed": scene.time_elapsed,
        "spotlights": [dataclasses.asdict(p) for p in scene.spotlights],
        "spotlights_render": scene.spotlights_render,
        "geometry": [
            {
                "name": inst.name,
                "mesh": inst.mesh.name if inst.mesh is not None else None,
                "render": inst.render,
                "casts_shadow": inst.casts_shadow,
                "animation": inst.animation.name,
                "originals": [_transform_dict(t) for t in inst.originals],
                "transforms": [_transform_dict(t) for t in inst.transforms],
                "material_overrides": [
                    (dataclasses.asdict(m) if m is not None else None)
                    for m in (inst.material_overrides or [])
                ] or None,
            }
            for inst in scene.geometry
        ],
    }


def scene_from_dict(data: dict, mesh_source) -> Scene:
    """Rebuild a scene; ``mesh_source`` maps a mesh name to a Mesh (a dict's
    ``__getitem__``, a loaded glTF's meshes by name)."""
    if data.get("version") != VERSION:
        raise ValueError(f"unsupported scene version {data.get('version')}")
    scene = Scene(
        cameras=[Camera(**_tuples(d)) for d in (data.get("cameras") or [data["camera"]])],
        camera_index=int(data.get("camera_index", 0)),
        camera_speed=data["camera_speed"],
        atmosphere=Atmosphere(**_tuples(data["atmosphere"])),
        sun_animation=SunAnimation(**data["sun_animation"]),
        render_atmosphere=data["render_atmosphere"],
        time_elapsed=data["time_elapsed"],
        spotlights=[SpotlightParams(**_tuples(p)) for p in data["spotlights"]],
        spotlights_render=data["spotlights_render"],
    )
    for g in data["geometry"]:
        overrides = g.get("material_overrides")
        scene.geometry.append(
            MeshInstance(
                mesh=mesh_source(g["mesh"]) if g["mesh"] is not None else None,
                name=g["name"],
                render=g["render"],
                casts_shadow=g["casts_shadow"],
                animation=InstanceAnimation[g["animation"]],
                originals=[_transform_from(t) for t in g["originals"]],
                transforms=[_transform_from(t) for t in g["transforms"]],
                material_overrides=(
                    [MaterialData(**m) if m is not None else None for m in overrides] if overrides else None
                ),
            )
        )
    return scene


def mesh_source_of(scene: Scene):
    """A mesh source that gives back ``scene``'s own meshes: the n-th call
    for a name returns the mesh of the n-th instance of that name. A glTF
    scene bakes each node's matrix into a mesh of its own, so instances of
    one name can hold different meshes (the chess pieces do); a source
    keyed by name alone would give every one of them the same mesh."""
    queues: dict[str, list] = {}
    for inst in scene.geometry:
        if inst.mesh is not None:
            queues.setdefault(inst.mesh.name, []).append(inst.mesh)
    served: dict[str, int] = {}

    def source(name: str):
        meshes = queues[name]
        n = served.get(name, 0)
        served[name] = n + 1
        return meshes[min(n, len(meshes) - 1)]

    return source


class _NumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def save_scene(path: str, scene: Scene) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene), f, indent=1, cls=_NumpyEncoder)


def load_scene(path: str, mesh_source) -> Scene:
    with open(path) as f:
        return scene_from_dict(json.load(f), mesh_source)
