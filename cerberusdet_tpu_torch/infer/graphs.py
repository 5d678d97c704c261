"""A device function captured once as a CUDA graph and replayed.

The port's counterpart of a program that the JAX package jits: XLA compiles
it once per input shape and static arguments and every later call of that
key runs the compiled program. Here the first call of a key runs the
function eagerly once on a side stream, which builds the kernels, fills the
wrappers' caches and lets cuDNN and the allocator settle, and then captures
it into a torch.cuda.CUDAGraph over a static input buffer. Each later call
copies its input into that buffer and replays the graph.

A graph holds the addresses of every tensor it reads: parameters and
buffers may change only in place (`copy_`) after a capture, never be
replaced. A capture that fails raises; nothing falls back to eager launches.
The captured cudaGraph_t is kept beside its instantiation, so that what a
replay runs can be listed node by node (`graph.raw_cuda_graph()`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


class CapturedProgram:
    """`fn(static_input) -> tensor` captured over a static input of
    `example`'s shape and dtype on `device`, in the graph memory pool `pool`
    (torch.cuda.graph_pool_handle()), which graphs that never run at once
    may share.

    counted: kernel wrappers with a `launches` attribute (the kernels that
    `fn` launches). A capture records launches without running them, so the
    counts it added are taken back and added again at every replay: a
    wrapper's count stays the number of times its kernel ran on the card."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], example: torch.Tensor,
                 device: torch.device, pool, counted: Sequence = ()):
        self.input = torch.empty(example.shape, dtype=example.dtype, device=device)
        self.input.copy_(example)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn(self.input)
        current.wait_stream(side)
        self.counted = tuple(counted)
        before = [w.launches for w in self.counted]
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.device(device):
            with torch.cuda.graph(self.graph, pool=pool):
                self.output = fn(self.input)
            self.graph.instantiate()
        self.launches = [w.launches - n for w, n in zip(self.counted, before)]
        for w, n in zip(self.counted, before):
            w.launches = n
        self.replays = 0

    def run(self, batch: torch.Tensor) -> torch.Tensor:
        """Copy `batch` (any device, the example's shape and dtype) into the
        static input and replay. Returns the static output, which the next
        replay of any graph in the same pool may overwrite: read it first."""
        self.input.copy_(batch)
        self.replay()
        return self.output

    def replay(self, n: int = 1) -> None:
        """Replay the graph n times on the static input as it stands."""
        for _ in range(n):
            self.graph.replay()
        for w, k in zip(self.counted, self.launches):
            w.launches += k * n
        self.replays += n
