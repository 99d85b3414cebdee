"""Multi-device rendering over ``torch.distributed``: image rows and frames.

Port of ``syzygy_tpu/parallel/sharding.py``. One process (rank) per
device, the ranks of the default process group laid out on a (dp, sp)
grid, rank r at (r // sp, r % sp):

* ``sp`` (spatial): the ranks of one dp row render one frame, each a
  block of whole tile rows (:func:`_local_rows`); the blocks are rejoined
  with ``all_gather`` over the row's group. The shadow rasters (light
  parallelism) and, with ``RenderConfig.shard_triangle_setup``, the camera
  triangle setup and the resolve records are split over the same group
  and rejoined in slot order (``group=`` of :func:`render_frame_rows`).
* ``dp`` (data): the dp rows render different frames of the batch, one
  after another on each rank (never batched into one graph, as the
  reference's ``_map_frames``), gathered over the dp groups.

Every rank computes its frame state and atmosphere LUTs itself. The
sharded frame is bitwise the stack of :func:`render_frame_rows` blocks at
the same row blocks, cropped: each rank runs the same code on its block,
and each shard site rejoins bitwise what the unsharded code computes.

Backends: NCCL keeps the collectives on the device; gloo, which gathers
host tensors only, takes them through host memory. NCCL refuses two ranks
on one GPU, so several ranks sharing a card run gloo.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from syzygy_tpu_torch.device import as_device, to_tensor
from syzygy_tpu_torch.kernels.raster import TILE_H
from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame_rows
from syzygy_tpu_torch.scene.pack import FrameParams, GeometryStatic


class Group:
    """One communicator of the mesh: its ``torch.distributed`` group, its
    size, this rank's index in it, and where its collectives move data."""

    def __init__(self, ranks: list[int], pg, transport: torch.device):
        self.ranks = ranks
        self.pg = pg
        self.size = len(ranks)
        self.index = ranks.index(dist.get_rank())
        self.transport = transport

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's ``x`` in group order, on ``x``'s
        device. Every rank passes the same shape and dtype."""
        if self.size == 1:
            return x[None]
        src = x.detach().contiguous().to(self.transport)
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.pg)
        return torch.stack(out).to(x.device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (dp, sp) grid and its two groups."""

    dp: int
    sp: int
    device: torch.device
    dp_index: int
    sp_index: int
    sp_group: Group  # the ranks of this rank's dp row (one frame's row blocks)
    dp_group: Group  # the ranks of this rank's sp column (the frames)


def _transport(device: torch.device) -> torch.device:
    return torch.device("cpu") if dist.get_backend() == "gloo" else device


def make_mesh(dp: int = 1, sp: int = 1, device=None) -> Mesh:
    """A (dp, sp) mesh over the default process group, which must hold
    dp * sp ranks. ``device`` is this rank's device (default: CUDA device
    ``rank % device_count``). Every rank must call it, with the same dp
    and sp: it creates every group on every rank in one order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp * sp:
        raise ValueError(f"need {dp * sp} ranks, have {world}")
    if device is None:
        device = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    device = as_device(device)
    transport = _transport(device)
    rows = [list(range(d * sp, (d + 1) * sp)) for d in range(dp)]
    cols = [list(range(s, world, sp)) for s in range(sp)]
    # dist.new_group is collective over the default group: every rank
    # creates every group, in the same order, and keeps its own
    groups = [(ranks, dist.new_group(ranks)) for ranks in rows + cols]
    mine = [Group(ranks, pg, transport) for ranks, pg in groups if rank in ranks]
    return Mesh(dp, sp, device, rank // sp, rank % sp, mine[0], mine[1])


def _local_rows(config: RenderConfig, sp: int) -> int:
    """Rows per rank: the padded height rounded up to ``sp`` whole tile
    rows each, so every (height, sp) shards; rows past the frame are
    rendered off-screen and cropped after the gather."""
    return -(-config.padded_height // (sp * TILE_H)) * TILE_H


def _tree_map(fn, *trees):
    """``fn`` over the leaves of (nested) NamedTuples; None stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_tree_map(fn, *leaves) for leaves in zip(*trees)])
    return fn(*trees)


def render_frames_sharded(
    geometry: GeometryStatic, params_batch: FrameParams, config: RenderConfig, mesh: Mesh
) -> torch.Tensor:
    """Render a batch of frames over the mesh: (B, height, width, 3) on
    every rank, on its device. ``params_batch`` has a leading batch axis B
    on every leaf (:func:`batch_params`), B a multiple of dp; dp row d
    renders frames [d * B / dp, (d + 1) * B / dp)."""
    config.check()
    b = len(params_batch.translations)
    if b % mesh.dp:
        raise ValueError(f"a batch of {b} frames does not split over dp={mesh.dp}")
    per = b // mesh.dp
    rows = _local_rows(config, mesh.sp)
    row0 = mesh.sp_index * rows

    def upload(x):
        return x.to(mesh.device) if isinstance(x, torch.Tensor) else to_tensor(x, mesh.device)

    blocks = []
    for k in range(per):  # one frame after another (the reference's _map_frames)
        frame = mesh.dp_index * per + k
        params = _tree_map(lambda x: upload(x[frame]), params_batch)
        blocks.append(render_frame_rows(geometry, params, config, row0, rows, group=mesh.sp_group))
    mine = torch.stack(blocks)  # (per, rows / ss, padded_width / ss, 3)
    joined = torch.cat(mesh.sp_group.all_gather(mine).unbind(0), dim=1)
    frames = joined[:, : config.height, : config.width]
    return torch.cat(mesh.dp_group.all_gather(frames).unbind(0), dim=0)


def replicate_to_mesh(tree, mesh: Mesh):
    """Rank 0's ``tree`` (a NamedTuple of arrays or tensors, e.g. the
    geometry) on every rank's device, broadcast over the default group.
    Every rank passes a tree of the same structure, shapes and dtypes
    (checked first, on every rank)."""

    def spec(x):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        return tuple(t.shape), str(t.dtype)

    leaves = []
    _tree_map(lambda x: leaves.append(spec(x)), tree)
    specs = [None] * dist.get_world_size()
    dist.all_gather_object(specs, leaves)
    if any(s != specs[0] for s in specs):
        raise ValueError("replicate_to_mesh: the ranks hold trees of different shapes or dtypes")

    def one(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
        # the mesh's groups run the default group's backend, so its transport
        buf = t.detach().contiguous().reshape(-1).view(torch.uint8).to(mesh.sp_group.transport)
        dist.broadcast(buf, src=0)
        return buf.to(mesh.device).view(t.dtype).reshape(t.shape)

    return _tree_map(one, tree)


def batch_params(params_list) -> FrameParams:
    """Stack per-frame FrameParams along a leading batch axis (numpy
    leaves stay numpy, tensors stay tensors)."""

    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack([np.asarray(x) for x in xs])

    return _tree_map(stack, *params_list)
