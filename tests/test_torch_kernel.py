"""The CUDA raster kernel vs its plain torch version, without JAX.

This file imports only torch and the port, so it also runs on a GPU host
that has no JAX (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel.py

Tests marked ``cuda`` skip without a GPU; the unmarked ones check on the
CPU the row-block origin semantics the kernel shares with
``rasterize_plain``, and ``kernels/build.py`` with a stand-in compiler.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from syzygy_tpu_torch.kernels.raster import (
    LAUNCHES,
    rasterize,
    rasterize_plain,
    setup_triangles,
)

W, H = 256, 192


def _random_setup(device, grid_height=None, grid_origin=(0, 0)):
    """Seeded clip-space triangles, some crossing the near plane (w < eps)
    so the clip fan's second slots are exercised."""
    rng = np.random.default_rng(17)
    n = 48
    xyz = rng.uniform([-1.3, -1.3, 0.05], [1.3, 1.3, 0.95], size=(n, 3, 3))
    w = rng.uniform(-0.2, 2.0, size=(n, 3, 1))
    clip = np.concatenate([xyz * np.abs(w), w], axis=-1).astype(np.float32).reshape(-1, 4)
    return setup_triangles(
        torch.from_numpy(clip).to(device),
        torch.arange(n * 3, dtype=torch.int32, device=device).reshape(n, 3),
        torch.ones(n, dtype=torch.bool, device=device), W, H, 0,
        grid_height=grid_height, grid_origin=grid_origin,
    )


def _dense_setup(device):
    """The dense sphere field (64 x sphere(8, 16)) seen by its camera."""
    from syzygy_tpu_torch.kernels.resolve import transform_positions
    from syzygy_tpu_torch.math.geometry import eulers_from_forward, matmul4
    from syzygy_tpu_torch.scene.pack import (
        pack_frame_params,
        pack_geometry,
        prepare_frame_state,
        upload_frame_params,
    )
    from syzygy_tpu_torch.scene.scene import dense_sphere_field

    scene, lib = dense_sphere_field(rings=8, segments=16)
    eye = torch.tensor([18.0, -16.0, -22.0])
    scene.camera.position = tuple(eye.tolist())
    scene.camera.euler_angles = tuple(
        eulers_from_forward(torch.tensor([0.0, -6.0, 0.0]) - eye).tolist()
    )
    geometry = pack_geometry(scene, lib, device)
    state = prepare_frame_state(upload_frame_params(pack_frame_params(scene, W / H), device))
    clip, _ = transform_positions(
        geometry.positions, geometry.vert_instance, state.models,
        matmul4(state.camera.projection, state.camera.view),
    )
    return setup_triangles(clip, geometry.triangles, geometry.tri_valid, W, H, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the raster kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["random", "dense"])
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_matches_plain(cuda, scene, depth_only):
    """Bitwise: the kernel and the plain version run the same plane
    arithmetic (fmas at the same places) in the same depth order; one
    launch is counted."""
    setup = _random_setup(cuda) if scene == "random" else _dense_setup(cuda)
    count = (lambda: LAUNCHES.depth) if depth_only else (lambda: LAUNCHES.visibility)
    before = count()
    kern = rasterize(setup, W, H, depth_only=depth_only)
    assert count() == before + 1
    plain = rasterize_plain(setup, W, H, depth_only=depth_only)
    torch.cuda.synchronize()
    fields = ("depth",) if depth_only else ("depth", "tri", "b0", "b1")
    for name in fields:
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    assert (kern.depth > 0).any()


def _check_row_block(device):
    """Rows [64, 128) rastered as a block at global origin (64, 0) equal
    those rows of the whole frame: the affine forms are global, only the
    tile ranges depend on the origin."""
    full = rasterize(_random_setup(device), W, H)
    block_setup = _random_setup(device, grid_height=64, grid_origin=(64, 0))
    part = rasterize(block_setup, W, 64, origin=(64, 0))
    for name in ("depth", "tri", "b0", "b1"):
        assert torch.equal(getattr(part, name), getattr(full, name)[64:128]), name
    assert (part.tri >= 0).any()


@pytest.mark.cuda
def test_kernel_row_block_origin(cuda):
    _check_row_block(cuda)


def test_plain_row_block_origin():
    _check_row_block(torch.device("cpu"))


_FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
  case "$a" in *gather.cu) src=gather ;; *raster.cu) src=raster ;; esac
done
echo "$src" >> "$CALLS"
if [ "$src" = "$FAIL_ON" ]; then echo "error: refused" >&2; exit 2; fi
echo binary > "$out"
echo "ptxas info    : Used 32 registers" >&2
"""


def test_build_compiles_each_source_once(tmp_path, monkeypatch):
    """``kernels/build.py`` with a stand-in compiler: one nvcc per missing
    source, each library and its ptxas log under a content-hash name, no
    rebuild when present, and no partial file left when a compile fails."""
    from syzygy_tpu_torch.kernels import build

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "nvcc").write_text(_FAKE_NVCC)
    (bin_dir / "nvcc").chmod(0o755)
    calls = tmp_path / "calls"
    monkeypatch.setenv("PATH", f"{bin_dir}:{__import__('os').environ['PATH']}")
    monkeypatch.setenv("CALLS", str(calls))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))

    paths = build.build()
    assert sorted(paths) == sorted(build.SOURCES)
    assert sorted(calls.read_text().split()) == sorted(build.SOURCES)
    for name, path in paths.items():
        assert path == build.library_path(name) and (tmp_path / "build" / path.split("/")[-1]).exists()
        assert "registers" in build.ptxas_report(name)
    build.build()  # everything present: no compiler runs
    assert len(calls.read_text().split()) == len(build.SOURCES)

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build2"))
    monkeypatch.setenv("FAIL_ON", "gather")
    with pytest.raises(RuntimeError, match="csrc/gather.cu"):
        build.build()
    assert sorted(p.name.split("_")[1] for p in (tmp_path / "build2").iterdir()) == ["raster", "raster"]
