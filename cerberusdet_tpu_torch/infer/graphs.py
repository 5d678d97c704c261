"""A device function captured once as a CUDA graph and replayed.

The port's counterpart of a program that the JAX package jits: XLA compiles
it once per input shape and static arguments and every later call of that
key runs the compiled program. Here the first call of a key runs the
function eagerly once on a side stream, which builds the kernels, fills the
wrappers' caches and lets cuDNN and the allocator settle, and then captures
it into a torch.cuda.CUDAGraph over static input buffers. Each later call
copies its inputs into those buffers and replays the graph. The serving
program (infer/inference.py) and the train step (train/step.py) are
captured so.

A graph holds the addresses of every tensor it reads: parameters and
buffers may change only in place (`copy_`) after a capture, never be
replaced; a caller that names the tensors its graph reads has each replay
check them. A capture that fails raises; nothing falls back to eager
launches. The captured cudaGraph_t is kept beside its instantiation, so
that what a replay runs can be listed node by node (`graph.raw_cuda_graph()`).

Each capture, copy in and replay is a span (utils/tracing.py), and the
stage marks that the function records (tracing.mark) are captured with it:
every replay re-times them, and the host reads those of at most one
replay a tracing.READ_GAP_S into the ring once they are complete: before
the next replay, or at `marks.collect()` (once the host has waited for the
outputs).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from cerberusdet_tpu_torch.utils import tracing

NamedTensors = Sequence[Tuple[str, torch.Tensor]]


class CapturedProgram:
    """`fn(static) -> outputs` captured over static inputs shaped and
    strided as `example` (a tensor, or a nest of dicts, lists and tuples of
    tensors) on `device`, in the graph memory pool `pool`
    (torch.cuda.graph_pool_handle()), which graphs that never run at once
    may share. `fn` gets the static inputs in `example`'s structure; its
    outputs may be any nest of tensors (a tuple, a dict, a NamedTuple),
    which every replay rewrites in place.

    `first` holds the outputs of the eager run that begins the capture,
    until the first replay: a caller for which that run is the key's first
    call returns them. A capture records without running, so nothing that
    `fn` changes in place changes twice.

    counted: kernel wrappers with a `launches` attribute (the kernels that
    `fn` launches). A capture records launches without running them, so the
    counts it added are taken back and added again at every replay: a
    wrapper's count stays the number of times its kernel ran on the card.

    watched: (name, tensor) of the state that `fn` reads or updates by
    address besides its inputs (parameters, buffers, optimizer state). Their
    addresses after the capture are kept, and a replay given the caller's
    current (name, tensor) raises if any was replaced since."""

    def __init__(self, fn: Callable[[Any], Any], example, device: torch.device, pool,
                 counted: Sequence = (), watched: Optional[NamedTensors] = None):
        with tracing.span("capture"):
            self._build(fn, example, device, pool, counted, watched)

    def _build(self, fn, example, device, pool, counted, watched) -> None:
        leaves, self._spec = pytree.tree_flatten(example)
        # with the example's strides: a convolution's kernels follow its input's layout
        self._inputs: List[torch.Tensor] = [torch.empty_like(t, device=device) for t in leaves]
        self._copy_in(leaves)
        self.input = pytree.tree_unflatten(self._inputs, self._spec)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.first = fn(self.input)
        current.wait_stream(side)
        for t in pytree.tree_leaves(self.first):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(current)
        self.counted = tuple(counted)
        before = [w.launches for w in self.counted]
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.marks = tracing.StageMarks()
        with torch.cuda.device(device):
            with torch.cuda.graph(self.graph, pool=pool), self.marks.capturing():
                self.output = fn(self.input)
            self.graph.instantiate()
        self.launches = [w.launches - n for w, n in zip(self.counted, before)]
        for w, n in zip(self.counted, before):
            w.launches = n
        self._addresses = None if watched is None else addresses(watched)
        self.replays = 0

    def _copy_in(self, leaves) -> None:
        for s, t in zip(self._inputs, leaves):
            if tuple(t.shape) != tuple(s.shape) or t.dtype != s.dtype:
                raise ValueError(f"a captured program takes {tuple(s.shape)} {s.dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
            s.copy_(t, non_blocking=True)

    def run(self, inputs, watched: Optional[NamedTensors] = None):
        """Copy `inputs` (any device; the example's structure, shapes and
        dtypes) into the static inputs and replay. Returns the static
        outputs, which the next replay of any graph in the same pool may
        overwrite: read them first. A copy from the host's pageable memory
        returns once CUDA has staged it, which may wait for the work already
        queued; the call returns once the replay is queued."""
        leaves, spec = pytree.tree_flatten(inputs)
        if spec != self._spec:
            raise ValueError(f"a captured program takes inputs structured as {self._spec}, "
                             f"got {spec}")
        self.check(watched)
        with tracing.span("copy_in"):
            self._copy_in(leaves)
        self.replay()
        return self.output

    def check(self, watched: Optional[NamedTensors]) -> None:
        """Raise if a tensor of `watched` is not the one the graph captured."""
        if watched is not None and self._addresses is not None:
            check_addresses(self._addresses, watched)

    def replay(self, n: int = 1) -> None:
        """Replay the graph n times on the static inputs as they stand; the
        previous replay's stage marks are read first, where complete."""
        self.marks.collect()
        with tracing.span("replay") as s:
            for _ in range(n):
                self.graph.replay()
            s.value = self.marks.launched(s.seq)
        self.first = None
        for w, k in zip(self.counted, self.launches):
            w.launches += k * n
        self.replays += n


def addresses(watched: NamedTensors) -> List[Tuple[str, int]]:
    """(name, data pointer) of each named tensor."""
    return [(name, t.data_ptr()) for name, t in watched]


def check_addresses(was: List[Tuple[str, int]], watched: NamedTensors) -> None:
    """Raise, naming the first tensor of `watched` that is not at the address
    `was` recorded for it (or is missing, or new)."""
    now = addresses(watched)
    for i in range(max(len(was), len(now))):
        if i >= len(was) or i >= len(now) or was[i] != now[i]:
            name = (now if i < len(now) else was)[i][0]
            raise RuntimeError(f"{name} is not the tensor that the captured graph reads: it "
                               "was replaced after the capture; update state in place "
                               "(copy_, load_state_dict)")
