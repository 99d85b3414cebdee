"""Procedural showcase scene: a chessboard at sunset.

Port of ``syzygy_tpu/assets/showcase.py``: an 8x8 textured board and
sphere/cube "armies" from the engine's procedural meshes, lit by a late
afternoon sun.
"""

from __future__ import annotations

import numpy as np

from syzygy_tpu_torch.assets.defaults import (
    cube_mesh,
    plane_mesh,
    register_default_textures,
    sphere_mesh,
)
from syzygy_tpu_torch.assets.types import MaterialData, TextureLibrary
from syzygy_tpu_torch.scene.scene import Scene, TransformHost


def _board_texture(squares: int = 8, px_per_square: int = 16) -> np.ndarray:
    dim = squares * px_per_square
    y, x = np.mgrid[0:dim, 0:dim]
    light = ((x // px_per_square + y // px_per_square) % 2) == 0
    tex = np.zeros((dim, dim, 4), np.uint8)
    tex[..., :3] = np.where(light[..., None], 225, 60)
    # warm tint on the light squares, cool on the dark
    tex[..., 0] = np.where(light, 235, 70)
    tex[..., 2] = np.where(light, 200, 85)
    tex[..., 3] = 255
    return tex


def _piece_texture(rgb) -> np.ndarray:
    tex = np.zeros((8, 8, 4), np.uint8)
    tex[..., 0], tex[..., 1], tex[..., 2] = rgb
    tex[..., 3] = 255
    return tex


def _orm_texture(roughness: int, metallic: int) -> np.ndarray:
    tex = np.zeros((8, 8, 4), np.uint8)
    tex[..., 0] = 255
    tex[..., 1] = roughness
    tex[..., 2] = metallic
    return tex


def chessboard_scene():
    """Scene + library: 8x8 board, two sphere 'armies', late-afternoon sun."""
    library = TextureLibrary()
    defaults = register_default_textures(library)

    board_mat = MaterialData(
        color=library.register("board_color", _board_texture(), srgb=True),
        normal=defaults.normal,
        orm=library.register("board_orm", _orm_texture(40, 0), srgb=False),
    )
    white_mat = MaterialData(
        color=library.register(
            "white_piece", _piece_texture((235, 228, 210)), srgb=True
        ),
        normal=defaults.normal,
        orm=library.register("white_orm", _orm_texture(30, 160), srgb=False),
    )
    black_mat = MaterialData(
        color=library.register(
            "black_piece", _piece_texture((60, 45, 40)), srgb=True
        ),
        normal=defaults.normal,
        orm=library.register("black_orm", _orm_texture(25, 200), srgb=False),
    )

    board = plane_mesh(board_mat)
    white_sphere = sphere_mesh(white_mat, rings=24, segments=48)
    black_sphere = sphere_mesh(black_mat, rings=24, segments=48)
    white_cube = cube_mesh(white_mat)
    black_cube = cube_mesh(black_mat)

    scene = Scene()
    # board: 16x16 world units, top at y = 0 (+y down)
    inst = scene.add_mesh_instance(
        board, "Board", [TransformHost.make((0, 0, 0), scale=(8.0, 1.0, 8.0))],
        casts_shadow=False,
    )
    # undo setMesh's flat-plane scale blow-up for authored sizing
    inst.transforms[0].scale[:] = (8.0, 1.0, 8.0)

    rng = np.random.default_rng(42)

    def square_center(file, rank):
        return (-7.0 + 2.0 * file, 0.0, -7.0 + 2.0 * rank)

    pieces = []
    # two back ranks of "major pieces" (cubes) and pawns (spheres)
    for side, cube, sphere, back, pawn in (
        (0, white_cube, white_sphere, 0, 1),
        (1, black_cube, black_sphere, 7, 6),
    ):
        for f in range(8):
            x, _, z = square_center(f, back)
            h = 0.9 if f in (3, 4) else 0.7
            pieces.append((cube, (x, -h, z), (0.45, h, 0.45)))
        for f in range(0, 8, 2):
            x, _, z = square_center(f + (side + rng.integers(0, 1)) % 2, pawn)
            pieces.append((sphere, (x, -0.45, z), (0.45, 0.45, 0.45)))
    # a couple of pieces mid-game
    pieces.append((white_sphere, (1.0, -0.45, 1.0), (0.45, 0.45, 0.45)))
    pieces.append((black_cube, (-3.0, -0.7, -1.0), (0.45, 0.7, 0.45)))

    by_mesh = {}
    for mesh, pos, scale in pieces:
        by_mesh.setdefault(id(mesh), (mesh, []))[1].append(
            TransformHost.make(pos, scale=scale)
        )
    for mesh, transforms in by_mesh.values():
        scene.add_mesh_instance(mesh, mesh.name, transforms)

    # late-afternoon sun for long shadows
    scene.sun_animation.time = 0.30
    scene.sun_animation.frozen = True
    return scene, library
