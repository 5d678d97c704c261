"""Data parallelism: ranks of a process group, and replicas on a device mesh.

Counterpart of cerberusdet_tpu/parallel/mesh.py. There, one program runs
over a 1-D `data` axis of a jax.sharding.Mesh: parameters are replicated,
batches are split by rows, XLA inserts the all-reduces, and a process per
host feeds its own rows (HostShardSampler). The port keeps those semantics
with two forms of parallelism:

- Ranks (training and val): one process per card in a torch.distributed
  group (torchrun, `init_distributed`). Each rank holds a replica of the
  state and steps it on its own rows, and the step is the one logical step
  over the global batch that JAX's mesh computes: the loss takes the global
  target-score sum and row count (train/loss.py), BatchNorm the global
  statistics (nn/module.py), and the flat gradients are summed over the
  ranks (train/step.py), not averaged as DDP averages them. NCCL on the
  card, Gloo on the CPU. A Gloo group on the card runs eagerly only: its
  collectives run on the host, which a CUDA graph cannot hold.
- Replicas (serving): `make_mesh` lists devices, repeats allowed as XLA's
  virtual CPU devices are; infer/inference.py keeps a copy of the fused
  model on each and runs each batch's rows split over them, which is what
  GSPMD's batch partitioning of the serving program does on the TPU.

The kernels need no rule of their own: a rank or a replica launches them
on its own rows, which is what the JAX package's custom partitionings of
the NMS and TAL kernels (ops/nms_pallas.py, ops/tal_pallas.py) do.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Mesh = List[torch.device]


def init_distributed(backend: Optional[str] = None, device=None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None):
    """Join the process group (or return it, once joined) and return it.

    Rank and world size come from the arguments, else from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT),
    else a group of one. The device is `device`, else the card of
    LOCAL_RANK; the backend is `backend`, else NCCL on the card and Gloo
    on the CPU (Gloo takes CUDA tensors too: two ranks on one card, which
    NCCL refuses). On the card the process's current device is set, and one
    collective runs at once, so that NCCL builds its communicator here and
    not inside a captured step."""
    from cerberusdet_tpu_torch import resolve_device

    if dist.is_initialized():
        return dist.group.WORLD
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw: Dict[str, Any] = dict(backend=backend, rank=rank, world_size=world_size)
    if init_method is not None:
        kw["init_method"] = init_method
    elif "MASTER_ADDR" in env:
        kw["init_method"] = "env://"
    elif world_size == 1:
        kw["store"] = dist.HashStore()  # a group of one needs no rendezvous
    else:
        raise ValueError(f"a group of {world_size} needs init_method or torchrun's "
                         "MASTER_ADDR / MASTER_PORT")
    dist.init_process_group(**kw)
    probe = torch.zeros(1, device=device if device.type == "cuda" else "cpu")
    dist.all_reduce(probe)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dist.group.WORLD


def rank_device(device=None) -> torch.device:
    """`device` as a rank takes it: None or the card unnumbered is the
    process's current card (init_distributed set it)."""
    from cerberusdet_tpu_torch import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def group_rank(group=None) -> int:
    """This process's rank in `group` (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


def group_size(group=None) -> int:
    """The ranks in `group` (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def collective_device(group) -> torch.device:
    """Where `group`'s collectives take their host-made tensors: the current
    card for NCCL, the CPU for Gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The serving mesh: the given devices (names or torch.device; a device
    may repeat, as XLA's virtual CPU devices do), by default every visible
    card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices, e.g. ['cpu']")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def replicate(obj, mesh):
    """Replicate a model or a train state.

    mesh a list of devices (make_mesh): a list of replicas of the module
    `obj`, one per device, the first `obj` itself when it is on that
    device, the others deep copies (a repeated device gets a copy of its
    own). mesh a process group: rank 0's values broadcast in place into
    every tensor of `obj` (a module, or train/step.py's TrainState with its
    optimizer buffers and EMA); returns `obj`."""
    if isinstance(mesh, (list, tuple)):
        first = next(obj.parameters()).device
        return [obj if i == 0 and first == d else copy.deepcopy(obj).to(d)
                for i, d in enumerate(mesh)]
    if hasattr(obj, "opt_state"):
        from cerberusdet_tpu_torch.train.step import state_tensors

        tensors = [t for _, t in state_tensors(obj)]
    else:
        tensors = list(obj.parameters()) + list(obj.buffers())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=dist.get_global_rank(mesh, 0), group=mesh)
    return obj


def _rows(x, lo: int, hi: int, device):
    x = x[lo:hi]
    if device is None:
        return x
    return torch.as_tensor(x).to(device, non_blocking=True)


def shard_batch(batch: Dict[str, Any], mesh: Union[Mesh, int], index: Optional[int] = None):
    """Split every array of `batch` (numpy or tensors) evenly by rows over
    the mesh: a list of one batch per shard, each moved to its device. mesh
    an int n: n shards left where they are (the ranks of a group). With
    `index`, that shard alone. The row count must divide by the shards."""
    n = mesh if isinstance(mesh, int) else len(mesh)
    devices = [None] * n if isinstance(mesh, int) else list(mesh)
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} rows does not divide over {n} shards")
    k = b // n
    picks = range(n) if index is None else [index]
    shards = [{key: _rows(v, i * k, (i + 1) * k, devices[i]) for key, v in batch.items()}
              for i in picks]
    return shards if index is None else shards[0]


def shard_task_batches(batches: Dict[str, Dict[str, Any]], mesh: Union[Mesh, int],
                       index: Optional[int] = None):
    """shard_batch of each task's batch: {task: shards} ({task: shard} with index)."""
    return {t: shard_batch(b, mesh, index) for t, b in batches.items()}


def pad_batch_to(batch: Dict[str, Any], size: int) -> Dict[str, Any]:
    """Pad the leading dim of every array to `size` with zeros (divisibility
    by the shards) and add 'img_mask', 1 for real rows and 0 for padding
    (float32; numpy, or a tensor on the images' device for a tensor batch),
    which makes a padded step compute exactly the unpadded step: the loss
    drops padded rows and normalises by the valid-row count
    (train/loss.py) and BatchNorm leaves them out of its statistics
    (nn/module.py), as in the JAX package."""
    n = next(iter(batch.values())).shape[0]

    def pad(x):
        if x.shape[0] == size:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((size - x.shape[0],) + tuple(x.shape[1:]))])
        widths = [(0, size - x.shape[0])] + [(0, 0)] * (np.ndim(x) - 1)
        return np.pad(np.asarray(x), widths)

    out = {k: pad(v) for k, v in batch.items() if k != "img_mask"}
    if "mask" in out:
        out["mask"][n:] = False
    img_mask = np.zeros(size, np.float32)
    img_mask[:n] = 1.0
    img = out.get("img", next(iter(out.values())))
    out["img_mask"] = (torch.from_numpy(img_mask).to(img.device)
                       if isinstance(img, torch.Tensor) else img_mask)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of `group`, differentiable: its gradient
    is the sum over the ranks of theirs, so that a rank's backward through
    a global statistic carries every rank's loss."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def broadcast_object(obj, group=None):
    """Rank 0's `obj` (any picklable value) on every rank; `obj` itself
    without a group."""
    if group is None or dist.get_world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def broadcast_decision(stop: bool, fitness: float, group=None) -> Tuple[bool, float]:
    """Rank 0's (stop, fitness) on every rank, so that every rank leaves the
    epoch loop together (the JAX trainer's _broadcast_decision); the
    identity without a group."""
    if group is None or dist.get_world_size(group) == 1:
        return stop, fitness
    t = torch.tensor([float(stop), float(fitness)], dtype=torch.float64,
                     device=collective_device(group))
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    v = t.cpu().numpy()
    return bool(v[0] > 0.5), float(v[1])


def all_gather_rows(a: np.ndarray, group) -> List[np.ndarray]:
    """Every rank's array `a` (ragged in its leading dim; the same trailing
    shape and dtype on every rank), in rank order: the sizes are gathered
    first, each array padded to the largest, gathered, and trimmed (the JAX
    package's val merge)."""
    dev = collective_device(group)
    world = dist.get_world_size(group)
    n = torch.tensor([len(a)], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(sizes, n, group=group)
    sizes = [int(s) for s in sizes]
    top = max(sizes)
    # the rows as bytes: one uint8 gather whatever the dtype (bool included)
    row = int(np.prod(a.shape[1:], dtype=np.int64))
    raw = np.ascontiguousarray(a).reshape(len(a), row).view(np.uint8)
    buf = torch.zeros((top, raw.shape[1]), dtype=torch.uint8, device=dev)
    buf[:len(a)] = torch.from_numpy(raw).to(dev)
    parts = [torch.zeros_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf, group=group)
    return [p[:s].cpu().numpy().view(a.dtype).reshape((s,) + a.shape[1:])
            for p, s in zip(parts, sizes)]
