"""Profiling and model-info utilities, and the benchmarks' honest loop.

Counterpart of cerberusdet_tpu/utils/profiling.py (the reference's
torch_utils.py:103-166 time_sync / Profile / module micro-bench and
:220-245 model_info). Where the JAX package reads XLA's compiled program,
the port reads what PyTorch gives:

  * conv_count: the kernel nodes of a captured torch.cuda.CUDAGraph (the
    benchmarks' guard that no task branch drops out of what is timed), where
    JAX counts the convolutions of the compiled HLO;
  * flops_estimate / model_info / dump_model_graph: FLOPs by
    torch.utils.flop_counter on the all-heads eval forward, where JAX reads
    XLA's cost analysis;
  * trace: a torch.profiler trace exported as a Chrome trace
    (tools/summarize_trace.py reads it), where JAX writes a jax.profiler
    trace.

HonestLoop is the method of the JAX package's bench.py:123-150 and
tools/bench_serving.py:31-57 on the card: the function captured once as a
CUDA graph over a static input, each replay chained to the previous one
through that input, K replays timed between CUDA events, best of 3.
"""

from __future__ import annotations

import gc
import gzip
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from cerberusdet_tpu_torch.infer.graphs import CapturedProgram

# kernel-name fragments of the convolutions in a captured graph: the port's
# int8 kernels (csrc/conv_int8.cu), then cuDNN's. cuDNN names its sm90 conv
# kernels by engine and tile ("sm90_xmma_fprop_implicit_gemm_...",
# "cutlass_tensorop_..._fprop_...", "implicit_convolve_sgemm",
# "conv2d_grouped_direct_kernel") and runs a 1x1 conv as a cuBLASLt GEMM,
# "nvjet_tst_<tile>_..." (torch 2.11 with CUDA 12.8 on an H100; the forward's
# one matrix product, the DFL's bin expectation, is a gemv). Names that vary
# by version are listed by conv_nodes as unmatched, and the benchmarks print
# them once.
CONV_S8_KERNEL = "conv_s8_kernel"
QUANT_PACK_KERNEL = "quant_pack"
CUDNN_CONV_PATTERNS = ("fprop", "implicit_gemm", "convolve", "conv2d", "nvjet")

_SHOWN_UNMATCHED: set = set()  # unmatched kernel names already printed in this process


def time_sync() -> float:
    """Wall clock after the card's pending work has finished."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


class Profile:
    """Accumulating timing context (torch_utils.py:110-127):
    with Profile() as p: ... ; p.t holds cumulative seconds."""

    def __init__(self, t: float = 0.0):
        self.t = t
        self.dt = 0.0

    def __enter__(self):
        self.start = time_sync()
        return self

    def __exit__(self, *exc):
        self.dt = time_sync() - self.start
        self.t += self.dt


def card_name_power() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def device_label(device: torch.device) -> str:
    """The card's name and power limit, or the CPU: what every printed
    number is measured on."""
    return card_name_power() if device.type == "cuda" else "cpu (host clock; no card)"


# ------------------------------------------------------------ captured graphs
def graph_kernel_names(graph) -> List[str]:
    """Names of the kernel nodes of a captured torch.cuda.CUDAGraph that
    kept its cudaGraph_t (keep_graph=True), read through the driver API."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [(f, ctypes.c_uint) for f in (
            "gx", "gy", "gz", "bx", "by", "bz", "smem")] + [
            (f, ctypes.c_void_p) for f in ("params", "extra", "kern", "ctx")]

    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p, name = KernelNodeParams(), ctypes.c_char_p()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)),
              "cuGraphKernelNodeGetParams")
        check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)), "cuFuncGetName")
        names.append(name.value.decode())
    return names


def classify_conv_kernels(names: Sequence[str]) -> Dict[str, Any]:
    """Kernel names -> {"conv_s8", "quant_pack_s8", "cudnn": counts, "convs":
    conv_s8 + cudnn, "kernels": all, "unmatched": the sorted distinct names
    that are none of these}."""
    out: Dict[str, Any] = {"conv_s8": 0, "quant_pack_s8": 0, "cudnn": 0}
    unmatched = set()
    for n in names:
        if CONV_S8_KERNEL in n:
            out["conv_s8"] += 1
        elif QUANT_PACK_KERNEL in n:
            out["quant_pack_s8"] += 1
        elif any(p in n for p in CUDNN_CONV_PATTERNS):
            out["cudnn"] += 1
        else:
            unmatched.add(n)
    out["convs"] = out["conv_s8"] + out["cudnn"]
    out["kernels"] = len(names)
    out["unmatched"] = sorted(unmatched)
    return out


def conv_nodes(graph) -> Dict[str, Any]:
    """classify_conv_kernels over a captured graph's kernel nodes."""
    return classify_conv_kernels(graph_kernel_names(graph))


def conv_count(graph) -> int:
    """Convolution kernel nodes of a captured graph: the guard shared by
    the benchmarks (the port's counterpart of counting HLO convolutions)."""
    return conv_nodes(graph)["convs"]


def print_unmatched_once(nodes: Dict[str, Any], width: int = 160) -> None:
    """Print the kernel names conv_nodes did not count as convolutions, each
    once in a process, so that a cuDNN whose conv kernels carry other names
    shows them."""
    new = [n for n in nodes["unmatched"] if n not in _SHOWN_UNMATCHED]
    if not new:
        return
    _SHOWN_UNMATCHED.update(new)
    print(f"[conv_count] {len(new)} kernel names not counted as convolutions "
          f"(patterns {CUDNN_CONV_PATTERNS}):", flush=True)
    for n in new:
        print("    " + (n if len(n) <= width else n[:width] + "..."), flush=True)


def model_convs(model) -> Tuple[int, int]:
    """(Conv and PlainConv modules, int8 Convs) of a CerberusModel: the
    convolutions of its all-heads forward, which runs every block once."""
    from cerberusdet_tpu_torch.nn.layers import Conv, PlainConv

    convs = [m for m in model.modules() if isinstance(m, (Conv, PlainConv))]
    return len(convs), sum(isinstance(m, Conv) and m.int8 for m in convs)


def check_convs(nodes: Dict[str, Any], n_convs: int, n_int8: int, what: str) -> None:
    """The benchmarks' guard on a captured graph: at least one conv kernel
    node per convolution of the all-heads forward, and exactly one conv_s8
    and one quant_pack_s8 node per int8 Conv. Raises otherwise, after
    printing the kernel names it did not count."""
    ok = nodes["convs"] >= n_convs and (nodes["conv_s8"], nodes["quant_pack_s8"]) == (
        n_int8, n_int8)
    if not ok:
        print_unmatched_once(nodes)
        raise AssertionError(
            f"{what}: the captured graph holds {nodes['convs']} conv kernel nodes "
            f"({nodes['conv_s8']} conv_s8, {nodes['cudnn']} cuDNN) and "
            f"{nodes['quant_pack_s8']} quant_pack_s8 nodes; the all-heads forward has "
            f"{n_convs} convolutions, {n_int8} of them int8")


def pool_mib(pool) -> float:
    """MiB of device memory the allocator holds in the graph memory pool
    `pool` (its segments)."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id") or ()) == tuple(pool)) / 2**20


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensor_leaves(x)]
    return []


class HonestLoop:
    """fn(x) -> a nest of output tensors, timed as dependent iterations.

    Each iteration computes `sink`, the float32 mean of every output leaf,
    and chains itself to the next through its input: x += 0 * sink. On the
    card the iteration is captured once as a CUDA graph over a static copy
    of x (infer/graphs.py:CapturedProgram, in a graph memory pool of its
    own); `time` replays it K times between CUDA events. On the CPU the
    iterations run eagerly and `time` reads the host clock. `counted`: the
    kernel wrappers fn launches, whose counts the replays keep.

    close() (or leaving a `with` block) frees the graph and its pool, so
    that the next variant finds the memory; read what a check needs before.
    """

    def __init__(self, fn: Callable, x: torch.Tensor, counted: Sequence = ()):
        self.fn = fn
        self.prog: Optional[CapturedProgram] = None
        self.pool = None
        self.x = x
        if x.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.prog = CapturedProgram(self.body, x, x.device, self.pool, counted)
            self.x = self.prog.input

    def body(self, x: torch.Tensor):
        out = self.fn(x)
        sink = sum(leaf.float().mean() for leaf in tensor_leaves(out))
        x.add_((sink * 0.0).to(x.dtype))
        return out

    @property
    def output(self):
        """The outputs of the last replay (the card only)."""
        return self.prog.output

    def step(self, k: int = 1) -> None:
        if self.prog is not None:
            self.prog.replay(k)
        else:
            for _ in range(k):
                self.body(self.x)

    def conv_nodes(self) -> Optional[Dict[str, Any]]:
        """conv_nodes of the captured graph; None on the CPU."""
        return None if self.prog is None else conv_nodes(self.prog.graph)

    def pool_mib(self) -> Optional[float]:
        return None if self.pool is None else pool_mib(self.pool)

    def time(self, iters: int, rounds: int = 3) -> Tuple[Optional[float], float]:
        """(device ms, host ms) per iteration, each the best of `rounds`
        rounds of `iters` dependent iterations after one warm round; the
        device ms by CUDA events around the replays (None on the CPU), the
        host ms by the host clock of the same rounds ending in a
        synchronise."""
        on_card = self.prog is not None
        self.step(iters)
        time_sync()
        best_dev, best_host = math.inf, math.inf
        for _ in range(rounds):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
            t0 = time_sync()
            if on_card:
                start.record()
            self.step(iters)
            if on_card:
                end.record()
            best_host = min(best_host, (time_sync() - t0) * 1e3 / iters)
            if on_card:
                best_dev = min(best_dev, start.elapsed_time(end) / iters)
        return (best_dev if on_card else None), best_host

    def close(self) -> None:
        if self.prog is not None:
            self.prog.graph.reset()
            self.prog = None
            self.x = None
            gc.collect()
            torch.cuda.empty_cache()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def honest_time(fn: Callable, x: torch.Tensor, iters: int, n_convs: int, n_int8: int,
                counted: Sequence = (), what: str = "honest_time") -> Dict[str, Any]:
    """HonestLoop(fn, x, counted) timed over `iters` iterations a round,
    with the guard on the card: the graph's conv nodes against the
    all-heads forward's n_convs convolutions, n_int8 of them int8 (the
    kernel names it does not count printed once). Returns {"ms" (device;
    None on the CPU), "host_ms", "conv_nodes" (None on the CPU), "pool_mib"}."""
    with HonestLoop(fn, x, counted) as loop:
        nodes = loop.conv_nodes()
        if nodes is not None:
            print_unmatched_once(nodes)
            check_convs(nodes, n_convs, n_int8, what)
            nodes = {k: v for k, v in nodes.items() if k != "unmatched"}
        ms, host_ms = loop.time(iters)
        pool = loop.pool_mib()
    return {"ms": ms, "host_ms": host_ms, "conv_nodes": nodes, "pool_mib": pool}


# ------------------------------------------------------------ FLOPs and bytes
def flops_estimate(fn: Callable, *args) -> Optional[float]:
    """FLOPs of fn(*args) by torch.utils.flop_counter (2 per multiply-add of
    the convolutions and matrix products it sees; the int8 kernels are not
    seen). None where the counter fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
    except RuntimeError:
        return None
    return float(counter.get_total_flops())


def _eval_forward(model, imgsz: int):
    """The all-heads eval forward on one zero image in the model's dtype and
    device, restoring the model's mode after."""
    ref = next(model.parameters())
    x = torch.zeros((1, 3, imgsz, imgsz), dtype=ref.dtype, device=ref.device)

    def fwd():
        was = model.training
        model.eval()
        try:
            out = model(x)
        finally:
            model.train(was)
        return {t: pred for t, (pred, _f) in out.items()}

    return fwd


def model_info(model, imgsz: int = 640, verbose: bool = False) -> Dict[str, Any]:
    """Params / GFLOPs summary (torch_utils.py:220-245). FLOPs measured on the
    all-task eval forward at `imgsz`."""
    flops = flops_estimate(_eval_forward(model, imgsz))
    info = {
        "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
        "gflops": (flops / 1e9) if flops else None,
        "imgsz": imgsz,
        "n_blocks": len(model.block_nodes) + len(model.task_ids),
    }
    if verbose:
        g = f"{info['gflops']:.1f}" if info["gflops"] else "n/a"
        print(f"CerberusDet: {info['n_blocks']} blocks, "
              f"{info['params_m']:.1f}M params, {g} GFLOPs @{imgsz}")
    return info


def _bytes_mode():
    """A dispatch mode that sums the bytes of every tensor each operator
    reads and writes (XLA's "bytes accessed": operands and results per op)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class BytesMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tensor_leaves([list(args), list((kwargs or {}).values()), out]):
                self.bytes += t.numel() * t.element_size()
            return out

    return BytesMode()


def dump_model_graph(model, save_dir, imgsz: int = 640) -> Optional[Dict[str, Any]]:
    """Write the model graph and its cost as run artifacts, where the JAX
    package writes XLA's StableHLO text and cost analysis (the reference's
    TensorBoard add_graph, models_manager.py:412-418): model_graph.txt.gz,
    the module tree and the all-heads forward's plan of blocks, and
    model_graph.cost.json (imgsz, params_m, flops, bytes_accessed,
    n_blocks) of the all-heads eval forward on one image at `imgsz`.

    Returns the cost dict, or None (after saying why) if the forward fails:
    an artifact never stops a run."""
    from torch.utils.flop_counter import FlopCounterMode

    save_dir = Path(save_dir)
    plan = "\n".join(f"{s.uid} <- {', '.join(s.in_uids)}" for s in model.plan())
    with gzip.open(save_dir / "model_graph.txt.gz", "wt") as f:
        f.write(f"{model}\n\n# all-heads forward, blocks in order\n{plan}\n")
    try:
        counter, nbytes = FlopCounterMode(display=False), _bytes_mode()
        with torch.no_grad(), counter, nbytes:
            _eval_forward(model, imgsz)()
    except RuntimeError as e:
        print(f"dump_model_graph: the cost of the forward was not measured: {e}",
              file=sys.stderr)
        return None
    info = {
        "imgsz": imgsz,
        "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
        "flops": float(counter.get_total_flops()),
        "bytes_accessed": float(nbytes.bytes),
        "n_blocks": len(model.block_nodes) + len(model.task_ids),
    }
    (save_dir / "model_graph.cost.json").write_text(json.dumps(info, indent=1))
    return info


# ------------------------------------------------------------ timing and traces
def profile_op(fn: Callable, *args, iters: int = 10) -> Dict[str, float]:
    """Micro-benchmark fn(*args) (torch_utils.py:130-166): `iters` calls,
    each fed args[0] plus 0 times an element of the previous call's first
    output, so that each waits for the one before. ms per call by CUDA
    events on the card, by the host clock on the CPU."""
    out = fn(*args)
    x0 = args[0]
    on_card = x0.device.type == "cuda"
    time_sync()
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    prev = out
    for _ in range(iters):
        leaves = tensor_leaves(prev)
        eps = (leaves[0].reshape(-1)[0] * 0).to(x0.dtype) if leaves else 0.0
        prev = fn(x0 + eps, *args[1:])
    if on_card:
        end.record()
    time_sync()
    if on_card:
        return {"ms": start.elapsed_time(end) / iters}
    return {"ms": (time.perf_counter() - t0) * 1e3 / iters}


def trace(log_dir, fn: Callable, *args, iters: int = 5):
    """Trace `iters` calls of fn(*args) with torch.profiler (CPU and, when
    the card is in use, CUDA activity) after one untraced call, and write
    <log_dir>/<host>_<pid>.pt.trace.json.gz (a Chrome trace; read it with
    tools/summarize_trace.py or chrome://tracing). Returns (fn's last
    result, the trace's path)."""
    from torch.profiler import ProfilerActivity, profile

    out = fn(*args)
    time_sync()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(iters):
            out = fn(*args)
        time_sync()
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    path = Path(log_dir) / f"{socket.gethostname()}_{os.getpid()}.pt.trace.json.gz"
    prof.export_chrome_trace(str(path))
    return out, path
