"""Spatial (image-height) sharding of the eval forward over ranks.

Counterpart of cerberusdet_tpu/parallel/spatial.py. There, the input's H
axis is annotated as sharded over a mesh axis and GSPMD partitions every
conv, inserting the halo exchanges at the shard boundaries. Here the mesh
is a set of ranks of a torch.distributed group (parallel/mesh.py:
init_distributed; Gloo or NCCL), each holding the whole model:

- rank r of n takes rows [r * H / n, (r + 1) * H / n) of the image;
- before every conv and max pool taller than one row (`frame`), it takes
  the rows its window reaches from the ranks above and below (`halo`: one
  all_gather of every rank's edge rows; a window taller than a shard takes
  rows from further ranks), with the op's padding value beyond the image;
- Detect gathers each level's map over the ranks before its decode
  (`gather_rows`), and TransformerBlock, which attends over every position,
  gathers its input, runs on the whole map and keeps its own rows; so
  every rank returns the whole, replicated result, as out_shardings=P()
  makes JAX's;
- the other layers are local in H: pointwise convs, BatchNorm, the
  activations, concats, the nearest upsample, and the space-to-depth
  reshapes of Focus and Contract, whose 2 x 2 cells start on even rows
  because H divides by n * 32 (`check_spatial_shape`).

The layers find the sharding through `active()`, set for the duration of
CerberusModel.forward(x, spatial=mesh); with none set, every layer runs the
one-device forward unchanged. Int8 activations carried between the blocks
(quant/ptq.py:propagate_act_quant) are exchanged as int8, and the int8 conv
kernel runs on each rank's framed rows (nn/module.py:conv2d_int8).

Two meshes: `make_spatial_mesh` (every rank of a group shards H) and
`make_data_spatial_mesh` (ranks laid out row-major as (data, spatial): each
row of n_spatial ranks shards H of its own rows of the batch, and the
predictions are gathered over the data axis). Eval only, as in the JAX
package: training over a spatial mesh does not exist there either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

SPATIAL_AXIS = "sp"  # the height axis's name, as the JAX package names its mesh axis

_LOCAL = threading.local()


@dataclasses.dataclass
class SpatialMesh:
    """This rank's place in a spatial mesh: `group` (the ranks that shard
    H with it; None for a mesh of one), its `index` there and their count
    `size`; on a (data, spatial) mesh, likewise `data_group`, `data_index`
    and `data_size` (the ranks that hold the other rows of the batch at the
    same rows of H)."""

    group: Optional[object]
    index: int
    size: int
    data_group: Optional[object] = None
    data_index: int = 0
    data_size: int = 1


def make_spatial_mesh(group=None) -> SpatialMesh:
    """1-D mesh whose one axis shards the image height: the ranks of
    `group` (the default group when None; a mesh of one without a joined
    process group), in rank order."""
    if not dist.is_initialized():
        return SpatialMesh(None, 0, 1)
    if group is None:
        group = dist.group.WORLD
    return SpatialMesh(group, dist.get_rank(group), dist.get_world_size(group))


def make_data_spatial_mesh(n_spatial: int) -> SpatialMesh:
    """2-D (data x spatial) mesh: the ranks of the default group laid out
    row-major as (len // n_spatial, n_spatial); each row shards H, each
    column splits the batch. Every rank must call it (it makes the rows'
    and the columns' process groups)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % n_spatial:
        raise ValueError(f"{n} ranks not divisible by n_spatial={n_spatial}")
    if n == 1:
        return SpatialMesh(None, 0, 1)
    n_data = n // n_spatial
    me = dist.get_rank()
    sp_group = data_group = None
    for i in range(n_data):  # every rank makes every group, in one order
        g = dist.new_group(list(range(i * n_spatial, (i + 1) * n_spatial)))
        if me // n_spatial == i:
            sp_group = g
    for j in range(n_spatial):
        g = dist.new_group(list(range(j, n, n_spatial)))
        if me % n_spatial == j:
            data_group = g
    return SpatialMesh(sp_group, me % n_spatial, n_spatial, data_group, me // n_spatial,
                       n_data)


def check_spatial_shape(h: int, n_devices: int, max_stride: int = 32) -> None:
    """H must split evenly across devices at EVERY feature level."""
    quantum = n_devices * max_stride
    if h % quantum:
        raise ValueError(
            f"spatial sharding needs H divisible by n_devices*max_stride = "
            f"{n_devices}*{max_stride} = {quantum}; got H={h}"
        )


def active() -> Optional[SpatialMesh]:
    """The spatial mesh of the forward running on this thread, None when
    the forward is not sharded (or the mesh has one rank)."""
    return getattr(_LOCAL, "mesh", None)


@contextlib.contextmanager
def sharded(mesh: Optional[SpatialMesh]):
    """Run the layers inside over `mesh` (a no-op for None or a mesh of one)."""
    before = active()
    _LOCAL.mesh = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _LOCAL.mesh = before


def halo(x: torch.Tensor, top: int, bottom: int, fill) -> torch.Tensor:
    """This rank's rows of x (B, C, h, W) with `top` rows of the ranks
    above and `bottom` rows of the ranks below, `fill` where those rows lie
    beyond the image: one all_gather of every rank's first min(bottom, h)
    and last min(top, h) rows (the same on every rank), so a halo taller
    than a shard takes the rows of further ranks."""
    mesh = active()
    if mesh is None or (top == 0 and bottom == 0):
        return x
    b, c, h, w = x.shape
    mt, mb = min(top, h), min(bottom, h)
    edge = torch.cat([x[:, :, :mb], x[:, :, h - mt:]], 2).contiguous()
    parts = [torch.empty_like(edge) for _ in range(mesh.size)]
    dist.all_gather(parts, edge, group=mesh.group)
    r = mesh.index
    rows = []
    if top:
        above = [parts[q][:, :, mb:] for q in range(max(0, r - -(-top // h)), r)]
        got = sum(t.shape[2] for t in above)
        if got < top:
            above.insert(0, x.new_full((b, c, top - got, w), fill))
        rows.append(torch.cat(above, 2)[:, :, -top:])
    rows.append(x)
    if bottom:
        below = [parts[q][:, :, :mb] for q in range(r + 1, min(mesh.size, r + 1 + -(-bottom // h)))]
        got = sum(t.shape[2] for t in below)
        if got < bottom:
            below.append(x.new_full((b, c, bottom - got, w), fill))
        rows.append(torch.cat(below, 2)[:, :, :bottom])
    return torch.cat(rows, 2)


def frame(x: torch.Tensor, k: int, s: int, padding, fill, own_padding: bool = False):
    """x (B, C, h, W), this rank's rows, framed for a window k rows tall at
    stride s with `padding` (p, or (p, pw) on (H, W)) on the global map:
    returns (xf, padding, keep). Run the op on xf with the returned padding
    and keep its output rows `keep` (a slice).

    Without a spatial mesh, or for a window that stays in a shard's rows
    (a 1x1 conv), that is x, the padding and every row unchanged. Else xf
    holds x's halo rows, `fill` beyond the image, and the padding is 0 on
    H; or, when `own_padding` (an op that pads both sides itself, as
    conv_s8 does), it stays, and keep is the rows [start, start + h // s)
    that the op's own padding rows do not feed. The rank's first row is a
    multiple of s (check_spatial_shape), so its outputs are the global rows
    from its first row // s on, each of which reaches p rows above and
    k - s - p below the rank's rows at most. With own_padding, the frame
    adds (-p) % s rows on top so that the op's stride grid falls on the
    global one."""
    p, pw = (padding, padding) if isinstance(padding, int) else padding
    top, bottom = p, max(0, k - s - p)
    if active() is None or top == bottom == 0:
        return x, padding, slice(None)
    if not own_padding:
        return halo(x, top, bottom, fill), (0, pw), slice(None)
    top += (-p) % s
    start = top // s
    return halo(x, top, bottom, fill), padding, slice(start, start + x.shape[2] // s)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of x (B, C, h, W), in rank order: the whole map."""
    mesh = active()
    if mesh is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, 2)


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole map x (B, C, H, W)."""
    mesh = active()
    if mesh is None:
        return x
    h = x.shape[2] // mesh.size
    return x[:, :, mesh.index * h:(mesh.index + 1) * h]


def make_spatial_forward(model, mesh: SpatialMesh, tasks: Optional[Sequence[str]] = None,
                         dtype: torch.dtype = torch.bfloat16):
    """The all-heads (or task-subset) eval forward of a CerberusModel with
    the image's H axis sharded over `mesh`, parameters replicated (each
    rank holds the model), outputs replicated.

    Returns run(img): img (B, 3, H, W), the whole batch on every rank, on
    the model's device -> {task: (B, N, 4 + nc) decoded float32
    predictions}, the same on every rank (no NMS). Each rank computes its
    rows of H (and, on a 2-D mesh from make_data_spatial_mesh, its rows of
    the batch, which must divide by the data axis) in `dtype`. H must
    divide by the spatial ranks times the deepest stride."""
    n_sp = mesh.size

    @torch.no_grad()
    def run(img: torch.Tensor):
        check_spatial_shape(img.shape[2], n_sp, int(max(model.strides)))
        if img.shape[0] % mesh.data_size:
            raise ValueError(
                f"batch {img.shape[0]} not divisible by the mesh "
                f"'data' axis ({mesh.data_size})")
        bl, hl = img.shape[0] // mesh.data_size, img.shape[2] // n_sp
        x = img[mesh.data_index * bl:(mesh.data_index + 1) * bl,
                :, mesh.index * hl:(mesh.index + 1) * hl].to(dtype)
        was_training = model.training
        model.eval()
        try:
            out = model(x, tasks=tasks, spatial=mesh)
        finally:
            model.train(was_training)
        preds = {t: pred for t, (pred, _feats) in out.items()}
        if mesh.data_size == 1:
            return preds
        gathered = {}
        for t, pred in preds.items():
            parts = [torch.empty_like(pred) for _ in range(mesh.data_size)]
            dist.all_gather(parts, pred.contiguous(), group=mesh.data_group)
            gathered[t] = torch.cat(parts, 0)
        return gathered

    return run
