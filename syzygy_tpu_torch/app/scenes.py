"""Builtin scenes by name (``--scene``), as ``syzygy_tpu/app/scenes.py``."""

from __future__ import annotations

BUILTIN_SCENES = ("default", "sphere", "chessboard", "flagship")


def builtin_scene(name: str):
    """One of the named builtin scenes -> (scene, library).

    ``default``: the editor's default scene (2 cubes, floor, red spot);
    ``chessboard``: the textured showcase board; ``flagship``: the chess
    set through the glTF path; ``sphere``: one 5x-scaled UV sphere."""
    if name == "default":
        from syzygy_tpu_torch.scene.scene import default_scene

        return default_scene()
    if name == "chessboard":
        from syzygy_tpu_torch.assets.showcase import chessboard_scene

        return chessboard_scene()
    if name == "flagship":
        from syzygy_tpu_torch.assets.chess import flagship_scene

        return flagship_scene()
    if name == "sphere":
        from syzygy_tpu_torch.assets.defaults import register_default_textures, sphere_mesh
        from syzygy_tpu_torch.assets.types import TextureLibrary
        from syzygy_tpu_torch.scene.scene import Scene, TransformHost

        library = TextureLibrary()
        scene = Scene()
        scene.add_mesh_instance(
            sphere_mesh(register_default_textures(library)),
            "Sphere",
            [TransformHost.make((0.0, -8.0, 0.0), scale=(5.0, 5.0, 5.0))],
        )
        return scene, library
    raise KeyError(f"no builtin scene named {name!r}")
