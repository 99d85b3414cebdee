"""The port's multi-device rendering (``parallel/sharding.py``) on gloo CPU ranks.

Each case starts its ranks through the port's own rank worker
(``syzygy_tpu_torch.parallel.ranks.run``: one process per rank, which
imports no JAX), each with one torch thread; the blocks they are compared
with are rendered here with one thread too, since the CPU's thread
chunking can move the last bit. Every run has its own timeout, on
``init_process_group`` and on the wait.

Tolerances: the sharded batch is bitwise the stack of the port's own
``render_frame_rows`` blocks at the same row blocks, cropped, on every
rank; each split site (camera setup, resolve records, shadow maps) is
bitwise its whole version; against the reference's
``render_frames_sharded`` on the 8-device virtual CPU mesh the frames
hold atol 1e-4 without the atmosphere, and with it the class of the
port's single-device frame against the reference's.
"""

from __future__ import annotations

import contextlib
import functools
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_common import rmse
from test_torch_frame import FRAME_MAX, FRAME_RMSE

from syzygy_tpu_torch.parallel import ranks
from syzygy_tpu_torch.parallel.dryrun import SMALL, case_params
from syzygy_tpu_torch.parallel.sharding import _local_rows

# the transmittance LUT at its default 512x128 costs ~7 s a frame on one
# CPU thread; the shards and the direct blocks share whatever is chosen
CONFIG = SMALL | dict(transmittance_width=64, transmittance_height=16)
TIMEOUT = 240.0


@functools.lru_cache(maxsize=None)
def sharded(dp, sp, width, height, **extra):
    return tuple(ranks.run(
        dp * sp, "syzygy_tpu_torch.parallel.dryrun:render_case",
        dict(dp=dp, sp=sp, width=width, height=height, frames=dp, device="cpu", config=CONFIG | extra),
        device="cpu", timeout=TIMEOUT,
    ))


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@one_thread()
def stacked_blocks(dp, sp, width, height, **extra):
    """The batch as this process renders it with render_frame_rows, block
    by block at the ranks' row blocks, cropped, on one thread."""
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame_rows
    from syzygy_tpu_torch.scene.pack import pack_geometry, upload_frame_params

    scene, library, params = case_params("default", dp, 1.0 / 60.0, width / height)
    geometry = pack_geometry(scene, library, "cpu")
    config = RenderConfig(width=width, height=height, **(CONFIG | extra))
    rows = _local_rows(config, sp)
    frames = []
    for p in params:
        blocks = [render_frame_rows(geometry, upload_frame_params(p, "cpu"), config, s * rows, rows) for s in range(sp)]
        frames.append(torch.cat(blocks)[:height, :width])
    return torch.stack(frames)


MESHES = [(1, 2, 128, 128), (2, 2, 128, 128), (1, 4, 192, 136), (2, 1, 128, 64)]


@pytest.mark.parametrize("dp,sp,width,height", MESHES, ids=lambda v: str(v))
def test_sharded_frames_bitwise_stacked_blocks(dp, sp, width, height):
    """(1, 4) at 192x136 pads 3 tile rows to 4: the last rank renders only
    rows past the frame (``tests/test_frame.py:110-137``)."""
    results = sharded(dp, sp, width, height)
    want = stacked_blocks(dp, sp, width, height)
    assert tuple(want.shape) == (dp, height, width, 3)
    for rank, result in enumerate(results):
        assert torch.equal(result["images"], want), f"rank {rank}"
    assert bool(torch.isfinite(want).all())
    if dp == 2:
        assert not torch.equal(want[0], want[1])  # two different frames


def test_sharded_supersample_bitwise_stacked_blocks():
    """``supersample=2`` at sp=2 (``tests/test_frame.py:256``): each block
    filters its own rows."""
    results = sharded(1, 2, 128, 64, supersample=2)
    want = stacked_blocks(1, 2, 128, 64, supersample=2)
    assert tuple(want.shape) == (1, 64, 128, 3)
    for result in results:
        assert torch.equal(result["images"], want)


@pytest.mark.slow
def test_sharded_1080p_bitwise_stacked_blocks():
    """The dry run's 1920x1080 case at (1, 4): 1088 padded rows to 1280."""
    results = sharded(1, 4, 1920, 1080)
    want = stacked_blocks(1, 4, 1920, 1080)
    for result in results:
        assert torch.equal(result["images"], want)


@functools.lru_cache(maxsize=None)
def partition(sp, maps):
    return ranks.run(
        sp, "syzygy_tpu_torch.parallel.dryrun:partition_case", dict(sp=sp, maps=list(maps), device="cpu"),
        device="cpu", timeout=TIMEOUT,
    )


# map slots 0 and 1 (sun and moon, whose maps hold nothing in this frame)
# and 2 (the scene's spot): three active slots over two ranks (more maps
# than ranks, the last share short); slot 2 alone active of three over
# four ranks (fewer: the last rank rasters nothing, two raster an
# inactive slot's empty map)
PARTITIONS = [(2, (0, 1, 2)), (4, (2,))]


@pytest.mark.parametrize("sp,maps", PARTITIONS, ids=["sp2", "sp4"])
def test_setup_partition_bitwise(sp, maps):
    """``setup_triangles(group=)`` vs the whole setup, every field
    (``tests/test_raster.py:331-384``)."""
    for result in partition(sp, maps):
        for name, value in result["whole"]["setup"].items():
            assert torch.equal(result["split"]["setup"][name], value), name


@pytest.mark.parametrize("sp,maps", PARTITIONS, ids=["sp2", "sp4"])
def test_records_partition_bitwise(sp, maps):
    for result in partition(sp, maps):
        assert torch.equal(result["split"]["records"], result["whole"]["records"])


@pytest.mark.parametrize("sp,maps", PARTITIONS, ids=["more_maps_than_ranks", "fewer_maps_than_ranks"])
def test_light_partition_bitwise(sp, maps):
    for result in partition(sp, maps):
        split, whole = result["split"]["shadow_maps"], result["whole"]["shadow_maps"]
        assert torch.equal(split, whole)
        assert float(whole[2].max()) > 0.0  # the spot's map holds the cubes
        assert not bool(whole[[i for i in range(whole.shape[0]) if i not in maps]].any())


@functools.lru_cache(maxsize=None)
def sharded_clear_sky(dp, sp, width, height):
    """As :func:`sharded`, the scene and the config without the atmosphere."""
    return tuple(ranks.run(
        dp * sp, "syzygy_tpu_torch.parallel.dryrun:render_case",
        dict(dp=dp, sp=sp, width=width, height=height, frames=dp, device="cpu", atmosphere=False,
             config=CONFIG | dict(render_atmosphere=False)),
        device="cpu", timeout=TIMEOUT,
    ))


@pytest.mark.parametrize("atmosphere", [False, True], ids=["clear_sky", "atmosphere"])
def test_matches_reference_sharded(atmosphere):
    """The port's (2, 2) batch vs the reference's ``render_frames_sharded``
    on the same frames over its 8-device virtual CPU mesh. Without the
    atmosphere: the reference's own atol 1e-4 between its sharded and
    single-device frames (``tests/test_frame.py:106``). With it: the class
    the port's whole frame holds against the reference's
    (``test_torch_frame.py``: RMSE 1e-3, max 2e-2), since at this config
    the single-device frames already differ by up to 1.9e-3 on sky pixels
    near the horizon."""
    import __graft_entry__ as ge

    from syzygy_tpu.parallel import batch_params, make_mesh, render_frames_sharded, replicate_to_mesh
    from syzygy_tpu.renderer import RenderConfig
    from syzygy_tpu.scene import pack_frame_params

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    width = height = 128
    scene, geometry, _, _ = ge._flagship(width, height)
    scene.render_atmosphere = atmosphere
    params = []
    for _ in range(2):
        scene.tick(1.0 / 60.0)
        params.append(pack_frame_params(scene, width / height))
    mesh = make_mesh(dp=2, sp=2)
    extra = {} if atmosphere else dict(render_atmosphere=False)
    config = RenderConfig(width=width, height=height, **CONFIG, **extra)
    want = np.asarray(render_frames_sharded(replicate_to_mesh(geometry, mesh), batch_params(params), config, mesh))
    got = (sharded if atmosphere else sharded_clear_sky)(2, 2, width, height)[0]["images"].numpy()
    assert got.shape == want.shape == (2, height, width, 3)
    if atmosphere:
        assert rmse(got, want) <= FRAME_RMSE
        assert np.abs(got - want).max() <= FRAME_MAX
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one rank in this process, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_is_render_frame(world_of_one):
    """(1, 1) in-process: the whole padded frame as one block, bitwise
    ``render_frame``; geometry replicated unchanged; the batch stacked."""
    from syzygy_tpu_torch.parallel import batch_params, make_mesh, render_frames_sharded, replicate_to_mesh
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame
    from syzygy_tpu_torch.scene.pack import pack_geometry, upload_frame_params

    scene, library, params = case_params("default", 1, 0.0, 2.0)
    geometry = pack_geometry(scene, library, "cpu")
    mesh = make_mesh(1, 1, "cpu")
    replicated = replicate_to_mesh(geometry, mesh)
    for name, value in geometry._asdict().items():
        assert (value is None and getattr(replicated, name) is None) or torch.equal(getattr(replicated, name), value)
    batch = batch_params(params)
    assert batch.translations.shape == (1, *params[0].translations.shape)
    config = RenderConfig(width=128, height=64, **CONFIG)
    out = render_frames_sharded(replicated, batch, config, mesh)
    assert torch.equal(out[0], render_frame(geometry, upload_frame_params(params[0], "cpu"), config))


def test_make_mesh_refuses_other_world_sizes(world_of_one):
    from syzygy_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="need 2 ranks, have 1"):
        make_mesh(1, 2, "cpu")


def test_failing_rank_raises():
    with pytest.raises(RuntimeError, match="unknown scene"):
        ranks.run(
            2, "syzygy_tpu_torch.parallel.dryrun:render_case",
            dict(dp=1, sp=2, width=128, height=128, frames=1, device="cpu", scene="nowhere"),
            device="cpu", timeout=TIMEOUT,
        )


@pytest.mark.slow
def test_dryrun_cli_cpu():
    """``python -m syzygy_tpu_torch.parallel.dryrun 2 --device cpu``: its
    three cases (``__graft_entry__.dryrun_multichip``'s), one line each."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "syzygy_tpu_torch.parallel.dryrun", "2", "--device", "cpu"],
        cwd=root, capture_output=True, text=True, timeout=1800,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [line for line in out.stdout.splitlines() if line.startswith("dryrun OK")]
    assert len(lines) == 2 and "(1, 1080, 1920, 3)" in lines[1], out.stdout
