"""``chess-gltf``: the repository's procedural chess set, read through the glTF path.

A frozen copy of the port's ``assets/chess.py`` generator: six
lathe-built piece silhouettes in marble and dark wood (32 pieces), a
two-surface board slab, native-resolution textures of several sizes
(value noise from fixed generator seeds), and a glTF node hierarchy
(board root, 32 piece children, knights rotated), 14,316 triangles.
:func:`inputs` encodes it as one multi-material .glb; :func:`build`
hands those bytes to a renderer's glTF API, which parses them itself.
"""

from __future__ import annotations

import numpy as np

from frame_bench.reference.assets.types import GeometrySurface, MaterialData, Mesh, TextureLibrary
from frame_bench.scenes.glb import encode_glb


def inputs() -> dict:
    """The scene's inputs as plain data: the .glb bytes."""
    meshes, nodes, library = chess_set()
    return {"glb": encode_glb(meshes, library=library, nodes=nodes)}


def build(api, data: dict):
    """(scene, library) from :func:`inputs` through ``api``'s glTF loader."""
    f = api.GLTFFile.from_bytes(data["glb"], ".")
    return api.gltf_scene(f, "syzygy_flagship_chess")


# ---------------------------------------------------------------------------
# procedural textures (value noise, all numpy, deterministic)
# ---------------------------------------------------------------------------


def _value_noise(rng, size: int, cells: int) -> np.ndarray:
    """Smooth [0,1] noise: bilinear-upsampled random grid."""
    grid = rng.uniform(0.0, 1.0, (cells + 1, cells + 1)).astype(np.float32)
    xs = np.linspace(0, cells, size, endpoint=False, dtype=np.float32)
    x0 = xs.astype(np.int64)
    fx = xs - x0
    fx = fx * fx * (3 - 2 * fx)  # smoothstep
    top = grid[x0][:, x0] * (1 - fx)[None, :] + grid[x0][:, x0 + 1] * fx[None, :]
    bot = (
        grid[x0 + 1][:, x0] * (1 - fx)[None, :]
        + grid[x0 + 1][:, x0 + 1] * fx[None, :]
    )
    return top * (1 - fx)[:, None] + bot * fx[:, None]


def _fbm(rng, size: int, octaves=4, base_cells=4) -> np.ndarray:
    acc = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        acc += amp * _value_noise(rng, size, base_cells * (2**o))
        total += amp
        amp *= 0.5
    return acc / total


def _wood(rng, size: int, rings: float, tint_a, tint_b) -> np.ndarray:
    """Wood grain: rings of a distorted radial field between two tints."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    warp = _fbm(rng, size, octaves=4) * 0.35
    field = (x * 0.3 + y * 1.7 + warp) * rings
    grain = 0.5 + 0.5 * np.sin(2 * np.pi * field)
    grain = grain[..., None] ** 1.5
    a = np.asarray(tint_a, np.float32)[None, None]
    b = np.asarray(tint_b, np.float32)[None, None]
    rgb = a + (b - a) * grain
    alpha = np.ones((size, size, 1), np.float32)
    return np.concatenate([rgb, alpha], axis=-1)


def _height_to_normal(height: np.ndarray, strength: float) -> np.ndarray:
    """Tangent-space normal map (unsigned, green-up) from a height field."""
    dx = np.roll(height, -1, axis=1) - np.roll(height, 1, axis=1)
    dy = np.roll(height, -1, axis=0) - np.roll(height, 1, axis=0)
    n = np.stack(
        [-dx * strength, dy * strength, np.ones_like(height)], axis=-1
    )
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgb = n * 0.5 + 0.5  # unsigned encode; green-up handled by the decoder
    alpha = np.ones((*height.shape, 1), np.float32)
    return np.concatenate([rgb, alpha], axis=-1).astype(np.float32)


def _orm(size: int, roughness: np.ndarray | float, metallic: float) -> np.ndarray:
    tex = np.zeros((size, size, 4), np.float32)
    tex[..., 0] = 1.0  # occlusion saturated (assets.cpp:781)
    tex[..., 1] = roughness
    tex[..., 2] = metallic
    tex[..., 3] = 1.0
    return tex


def _board_color(size: int = 512) -> np.ndarray:
    rng = np.random.default_rng(7)
    light = _wood(rng, size, 9.0, (0.72, 0.58, 0.41), (0.55, 0.41, 0.27))
    dark = _wood(
        np.random.default_rng(13), size, 7.0, (0.23, 0.14, 0.09), (0.33, 0.21, 0.13)
    )
    sq = size // 8
    yy, xx = np.mgrid[0:size, 0:size]
    is_light = (((xx // sq) + (yy // sq)) % 2 == 0)[..., None]
    out = np.where(is_light, light, dark)
    # thin bevel lines between squares
    edge = ((xx % sq < 2) | (yy % sq < 2))[..., None]
    out = np.where(edge, out * 0.7, out)
    out[..., 3] = 1.0
    return out.astype(np.float32)


def _board_normal(size: int = 256) -> np.ndarray:
    rng = np.random.default_rng(21)
    height = _fbm(rng, size, octaves=5) * 0.5
    sq = size // 8
    yy, xx = np.mgrid[0:size, 0:size]
    height += ((xx % sq < 1) | (yy % sq < 1)) * -0.8  # grooves
    return _height_to_normal(height, strength=1.2)


def _marble(rng, size: int, base, vein) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    warp = _fbm(rng, size, octaves=5) * 2.2
    veins = 0.5 + 0.5 * np.sin(2 * np.pi * (x * 2.5 + warp))
    veins = (veins[..., None]) ** 3.0
    a = np.asarray(base, np.float32)[None, None]
    b = np.asarray(vein, np.float32)[None, None]
    rgb = a + (b - a) * veins
    alpha = np.ones((size, size, 1), np.float32)
    return np.concatenate([rgb, alpha], axis=-1)


# ---------------------------------------------------------------------------
# lathe geometry
# ---------------------------------------------------------------------------


def lathe_mesh(
    profile: np.ndarray,  # (P, 2) [radius, height-above-board >= 0]
    material: MaterialData,
    segments: int = 24,
    name: str = "lathe",
) -> Mesh:
    """Surface of revolution around the vertical axis.

    Profile heights are "above the board"; engine +y is down, so a point at
    height h lands at y = -h. Faces are wound CW on screen for the engine's
    front-face convention (mirrors the procedural meshes in ``defaults.py``).
    """
    profile = np.asarray(profile, np.float32)
    p = profile.shape[0]
    ang = np.linspace(0.0, 2 * np.pi, segments + 1, dtype=np.float32)
    cos, sin = np.cos(ang), np.sin(ang)  # (S+1,)

    r = profile[:, 0][:, None]  # (P, 1)
    h = profile[:, 1][:, None]
    x = r * cos[None, :]
    z = r * sin[None, :]
    y = -h.repeat(segments + 1, axis=1)
    positions = np.stack([x, y, z], axis=-1).reshape(-1, 3)

    u = (ang / (2 * np.pi))[None, :].repeat(p, axis=0)
    arc = np.concatenate(
        [np.zeros(1, np.float32), np.cumsum(np.linalg.norm(np.diff(profile, axis=0), axis=1))]
    )
    v = (arc / max(arc[-1], 1e-6))[:, None].repeat(segments + 1, axis=1)
    uvs = np.stack([u, v], axis=-1).reshape(-1, 2)

    def vid(i, j):
        return i * (segments + 1) + j

    tris = []
    for i in range(p - 1):
        for j in range(segments):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            tris.append([a, d, b])
            tris.append([a, c, d])
    triangles = np.asarray(tris, np.int32)

    normals = _smooth_normals(positions, triangles)
    colors = np.ones((positions.shape[0], 4), np.float32)
    surfaces = [
        GeometrySurface(first_tri=0, tri_count=len(triangles), material=material)
    ]
    return Mesh(positions, normals, uvs, colors, triangles, surfaces, name)


def _smooth_normals(positions: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, oriented to face outward (engine CW
    front faces with +y down give outward = accumulated face normal)."""
    v0 = positions[triangles[:, 0]]
    v1 = positions[triangles[:, 1]]
    v2 = positions[triangles[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, triangles[:, k], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(norm, 1e-12)).astype(np.float32)


# piece silhouettes: (radius, height) pairs, board square = 2.0 world units
_PROFILES = {
    "pawn": [
        (0.00, 0.00), (0.55, 0.00), (0.55, 0.08), (0.34, 0.18), (0.22, 0.42),
        (0.30, 0.50), (0.18, 0.58), (0.26, 0.74), (0.17, 0.92), (0.00, 1.02),
    ],
    "rook": [
        (0.00, 0.00), (0.60, 0.00), (0.60, 0.10), (0.40, 0.22), (0.32, 0.70),
        (0.45, 0.78), (0.45, 1.05), (0.36, 1.05), (0.36, 0.92), (0.00, 0.92),
    ],
    "knight": [
        (0.00, 0.00), (0.58, 0.00), (0.58, 0.10), (0.36, 0.22), (0.28, 0.58),
        (0.42, 0.72), (0.38, 1.05), (0.22, 1.28), (0.00, 1.30),
    ],
    "bishop": [
        (0.00, 0.00), (0.58, 0.00), (0.58, 0.09), (0.35, 0.20), (0.22, 0.62),
        (0.32, 0.72), (0.24, 0.82), (0.28, 1.08), (0.12, 1.28), (0.16, 1.35),
        (0.00, 1.48),
    ],
    "queen": [
        (0.00, 0.00), (0.62, 0.00), (0.62, 0.10), (0.38, 0.24), (0.24, 0.72),
        (0.36, 0.86), (0.26, 0.96), (0.34, 1.30), (0.42, 1.46), (0.22, 1.52),
        (0.14, 1.62), (0.00, 1.72),
    ],
    "king": [
        (0.00, 0.00), (0.64, 0.00), (0.64, 0.10), (0.40, 0.25), (0.26, 0.78),
        (0.38, 0.92), (0.28, 1.02), (0.36, 1.38), (0.44, 1.56), (0.20, 1.62),
        (0.12, 1.78), (0.20, 1.86), (0.00, 1.94),
    ],
}

_BACK_RANK = ["rook", "knight", "bishop", "queen", "king", "bishop", "knight", "rook"]


def chess_set(
    library: TextureLibrary | None = None, segments: int = 24
) -> tuple[list[Mesh], list[dict], TextureLibrary]:
    """Meshes + glTF-writer node specs + textures for the full set.

    Returns (meshes, nodes, library): meshes[0] is the board; nodes place
    one board root and 32 piece children (engine coordinates, +y down,
    board top at y = 0, squares 2.0 wide).
    """
    library = library or TextureLibrary()
    rng = np.random.default_rng(3)

    board_mat = MaterialData(
        color=library.register("chess_board_color", _board_color(512), srgb=True),
        normal=library.register("chess_board_normal", _board_normal(256)),
        orm=library.register(
            "chess_board_orm",
            _orm(128, 0.35 + 0.2 * _value_noise(rng, 128, 8), 0.0),
        ),
    )
    white_mat = MaterialData(
        color=library.register(
            "chess_white_color",
            _marble(np.random.default_rng(11), 256, (0.84, 0.80, 0.72), (0.58, 0.55, 0.50)),
            srgb=True,
        ),
        normal=library.register(
            "chess_white_normal",
            _height_to_normal(_fbm(np.random.default_rng(17), 128, 4) * 0.2, 0.8),
        ),
        orm=library.register("chess_white_orm", _orm(64, 0.25, 0.05)),
    )
    black_mat = MaterialData(
        color=library.register(
            "chess_black_color",
            _wood(np.random.default_rng(23), 256, 11.0, (0.16, 0.10, 0.07), (0.28, 0.18, 0.11)),
            srgb=True,
        ),
        normal=library.register(
            "chess_black_normal",
            _height_to_normal(_fbm(np.random.default_rng(29), 128, 5) * 0.25, 0.9),
        ),
        orm=library.register("chess_black_orm", _orm(64, 0.32, 0.05)),
    )

    rim_mat = MaterialData(
        color=library.register(
            "chess_rim_color",
            _wood(np.random.default_rng(31), 128, 5.0, (0.20, 0.12, 0.08), (0.30, 0.19, 0.12)),
            srgb=True,
        ),
        normal=black_mat.normal,
        orm=library.register("chess_rim_orm", _orm(32, 0.5, 0.0)),
    )
    # board slab: 17.6 x 17.6 x 0.6 box with the board texture on top
    board = _board_mesh(board_mat, rim_mat)
    meshes = [board]
    mesh_index: dict[str, int] = {}
    for side, mat in (("white", white_mat), ("black", black_mat)):
        for kind, profile in _PROFILES.items():
            m = lathe_mesh(
                np.asarray(profile, np.float32),
                mat,
                segments=segments,
                name=f"{side}_{kind}",
            )
            mesh_index[f"{side}_{kind}"] = len(meshes)
            meshes.append(m)

    def square(file, rank):  # file 0..7 -> x, rank 0..7 -> z
        return (-7.0 + 2.0 * file, 0.0, -7.0 + 2.0 * rank)

    children = []
    for side, back_rank, pawn_rank in (("white", 0, 1), ("black", 7, 6)):
        for f, kind in enumerate(_BACK_RANK):
            x, y, z = square(f, back_rank)
            spec = {
                "mesh": mesh_index[f"{side}_{kind}"],
                "name": f"{side}_{kind}_{f}",
                "translation": (x, y, z),
            }
            if kind == "knight":  # face the opposing side
                spec["rotation_y"] = np.pi / 2 if side == "white" else -np.pi / 2
            children.append(spec)
        for f in range(8):
            x, y, z = square(f, pawn_rank)
            children.append(
                {
                    "mesh": mesh_index[f"{side}_pawn"],
                    "name": f"{side}_pawn_{f}",
                    "translation": (x, y, z),
                }
            )

    nodes = [
        {
            "mesh": 0,
            "name": "Board",
            "translation": (0.0, 0.0, 0.0),
            "children": children,
        }
    ]
    return meshes, nodes, library


def _board_mesh(material: MaterialData, rim_material: MaterialData) -> Mesh:
    """Board slab. TWO surfaces (multi-primitive in the .glb): the top face
    carries the 8x8 board texture, the rim + bottom a dark wood — this is
    the per-surface-material path the reference drives through descriptor
    sets (``renderer/scene.hpp:109-147``)."""
    half, depth = 8.8, 0.6
    # faces as (origin, ux, uy, normal), windings per defaults.cube_mesh
    top_face = ([-half, 0, half], [2 * half, 0, 0], [0, 0, -2 * half], [0, -1, 0])
    rim_faces = [
        ([-half, 0, -half], [2 * half, 0, 0], [0, depth, 0], [0, 0, -1]),
        ([half, 0, half], [-2 * half, 0, 0], [0, depth, 0], [0, 0, 1]),
        ([half, 0, -half], [0, 0, 2 * half], [0, depth, 0], [1, 0, 0]),
        ([-half, 0, half], [0, 0, -2 * half], [0, depth, 0], [-1, 0, 0]),
        ([-half, depth, -half], [2 * half, 0, 0], [0, 0, 2 * half], [0, 1, 0]),
    ]
    positions, normals, uvs, tris = [], [], [], []

    def add_face(origin, ux, uy, n, uv_quad):
        o, vx, vy, n = (np.asarray(v, np.float32) for v in (origin, ux, uy, n))
        base = len(positions)
        positions.extend([o, o + vx, o + vx + vy, o + vy])
        normals.extend([n] * 4)
        uvs.extend(uv_quad)
        tris.append([base, base + 1, base + 2])
        tris.append([base, base + 2, base + 3])

    # top uvs map the full slab to [0,1]^2 (playable 8x8 fills the middle)
    add_face(*top_face, uv_quad=[[0, 1], [1, 1], [1, 0], [0, 0]])
    for f in rim_faces:
        add_face(*f, uv_quad=[[0, 0], [2, 0], [2, 0.12], [0, 0.12]])

    positions = np.asarray(positions, np.float32)
    triangles = np.asarray(tris, np.int32)
    surfaces = [
        GeometrySurface(first_tri=0, tri_count=2, material=material),
        GeometrySurface(first_tri=2, tri_count=10, material=rim_material),
    ]
    return Mesh(
        positions,
        np.asarray(normals, np.float32),
        np.asarray(uvs, np.float32),
        np.ones((positions.shape[0], 4), np.float32),
        triangles,
        surfaces,
        "ChessBoard",
    )
