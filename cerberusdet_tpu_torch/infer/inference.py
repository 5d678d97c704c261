"""Public inference API with the reference's output contract.

Counterpart of cerberusdet_tpu/infer/inference.py: forward over all heads ->
per-task NMS -> global class-id remap -> cross-task suppression -> boxes
scaled to the original shapes -> [{box, score, label, label_name, task}] per
image. Everything up to the formatting runs on the device; `predict` syncs
once, to copy the fixed-shape result to the host. On the card that device
part is one CUDA graph per key, captured at the key's first request and
replayed after (infer/graphs.py), as the JAX package jits `_predict_impl`.
Over a mesh of devices (parallel/mesh.py:make_mesh) each device holds a
replica of the model and runs its own rows of the batch, each replica its
own captured program, as GSPMD partitions the JAX package's program.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.infer.graphs import CapturedProgram
from cerberusdet_tpu_torch.manager.weights import load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.ops.boxes import scale_boxes_np
from cerberusdet_tpu_torch.ops.conv_int8_cuda import conv_s8, quant_pack_s8, quant_s8
from cerberusdet_tpu_torch.ops.nms import cross_task_suppress, non_max_suppression
from cerberusdet_tpu_torch.ops.nms_cuda import greedy_nms_cuda
from cerberusdet_tpu_torch.parallel.mesh import replicate
from cerberusdet_tpu_torch.quant import (
    calibrate_amax,
    conv_layers,
    fused_conv_weights,
    quantize_params,
    select_all,
    select_deep,
)
from cerberusdet_tpu_torch.utils import tracing

DTYPES = (torch.bfloat16, torch.float32, torch.float64)
# the kernel wrappers that predict_device reaches on the card
SERVING_KERNELS = (greedy_nms_cuda, quant_pack_s8, conv_s8, quant_s8)


def build_category_map(names: Dict[str, Sequence[str]]):
    """{task: [names]} -> ({task: {local_id: global_id}}, all_names)."""
    categories_map: Dict[str, Dict[int, int]] = {}
    all_names: List[str] = []
    offset = 0
    for task, task_names in names.items():
        categories_map[task] = {i: i + offset for i in range(len(task_names))}
        all_names.extend(task_names)
        offset += len(task_names)
    return categories_map, all_names


class CerberusDetInference:
    """Multi-task detector inference on one device.

    Construct from `model` (a CerberusModel; it is fused in place and cast to
    `dtype`) with `params` = None (the model's own weights) or a JAX-layout
    parameter tree of arrays (manager/weights.py); or from `weights`, a
    `.ckpt.npz` written by either package. `device` None means the card.
    The compute dtype is bfloat16 with `half` (the default) and float32
    without, as in the JAX package; `dtype` (bfloat16, float32 or float64)
    overrides `half` when given. The decode and NMS run in float32 as in the
    JAX package.

    On the card, `predict` runs one CUDA graph per key (`program_key`: the
    batch's shape and dtype, the compute dtype, the int8 mode and the
    static arguments conf_thres, iou_thres, iou_thres_between_tasks,
    agnostic and max_det, as the JAX package's jit cache keys
    `_predict_impl`). The first request of a key runs `predict_device`
    eagerly once and captures it; later requests copy their batch into the
    graph's static input, replay, and copy the result to the host in one
    transfer. The graphs share one memory pool. They hold the addresses of
    the model's parameters and buffers: after a capture the weights may
    change only in place (`copy_`), and load_jax_params and quantization
    run before it (construction does both). On the CPU, and with
    use_kernel=False, `predict` runs `predict_device` eagerly.

    warmup_batch=n runs one `predict` on zeros of batch n at `img_size` at
    construction, which builds the kernels and, on the card, captures the
    program of that batch and the default thresholds, as the JAX package's
    warm-up compiles it. With warmup_batch None there is no warm-up: that
    is the one difference from the JAX package, which always warms up (at
    batch 1 by default); here a forward on the CPU at 640 px would cost
    seconds.

    int8: "off" | "deep" | "all", post-training quantization of the fused
    Convs (quant/ptq.py): "all" every Conv, "deep" those with at least 256
    input channels. Activation scales are calibrated by running the fused
    model in `dtype` over `calib_batches` (a list of (B, H, W, 3) float
    arrays in [0, 1]; one batch of uniform noise when omitted, as in the
    JAX package); the weights are quantized from their fused float32 values,
    and the model is annotated so that int8 crosses the blocks
    (quant/ptq.py:propagate_act_quant, which the JAX package runs by passing
    model=). A params tree that is already quantized needs no int8 argument,
    and its annotations, if any, come with it.

    mesh: a list of devices (parallel/mesh.py:make_mesh; a device may
    repeat) to serve over, as the JAX package's mesh= does: the model is
    built, fused and quantized once on the mesh's first device (`device`,
    which must be that one when given) and replicated onto every device
    (`replicas`), and `predict` splits each batch by rows over the
    replicas, runs each replica's program on its rows (its own CUDA graph
    per key on the card: the NMS kernel on that replica's candidates, the
    int8 kernels on its activations), and concatenates the results in row
    order. The batch must divide by the mesh's size.
    """

    def __init__(self, model: Optional[CerberusModel] = None, params=None,
                 weights: Optional[str] = None,
                 names: Optional[Dict[str, Sequence[str]]] = None,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 iou_thres_between_tasks: float = 0.8, img_size: int = 640,
                 half: bool = True, max_det: int = 300,
                 dtype: Optional[torch.dtype] = None, device=None, int8: str = "off",
                 calib_batches=None, warmup_batch: Optional[int] = None, mesh=None):
        if mesh is not None:
            mesh = [torch.device(d) for d in mesh]
            if device is not None and resolve_device(device) != mesh[0]:
                raise ValueError(f"device {device} is not the mesh's first device {mesh[0]}")
            device = mesh[0]
        self.device = resolve_device(device)
        if dtype is None:
            dtype = torch.bfloat16 if half else torch.float32
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
        if int8 not in ("off", "deep", "all"):
            raise ValueError(f"int8 must be 'off', 'deep' or 'all', got {int8!r}")
        if model is None:
            if weights is None:
                raise ValueError("provide (model, params) or a weights path")
            from cerberusdet_tpu_torch.manager.checkpoint import load_checkpoint

            ckpt = load_checkpoint(weights)
            meta = ckpt["meta"]
            model = CerberusModel(meta["cfg"], meta["task_ids"], meta["nc"],
                                  device=self.device)
            params = ckpt["ema"] if ckpt.get("ema") else ckpt["params"]
            names = names or dict(zip(meta["task_ids"], meta["names"]))
        if names is None:
            raise ValueError("names required when passing (model, params)")
        if params is not None:
            load_jax_params(model, params)
        # always fused at inference (exact; the reference fuses in attempt_load),
        # in the weights' own precision before the cast to the compute dtype
        model.fuse()
        fused = fused_conv_weights(model) if int8 != "off" else None
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.dtype = dtype
        if int8 != "off":
            if calib_batches is None:
                # uniform noise covers the [0, 1] input range; real images
                # give better scales
                print("CerberusDetInference: int8 enabled without "
                      "calib_batches — calibrating on random noise; pass "
                      "real batches for best accuracy")
                calib_batches = [np.random.default_rng(0).uniform(
                    0, 1, (2, img_size, img_size, 3)).astype(np.float32)]
            amax = calibrate_amax(self.model, calib_batches, dtype=dtype)
            quantize_params(self.model, amax,
                            select=select_all if int8 == "all" else select_deep(),
                            weights=fused, propagate=True)
            del fused
        self.int8 = int8
        self.mesh = mesh
        self.replicas = replicate(self.model, mesh) if mesh is not None else [self.model]
        self._int8_convs = [[m for _, m in conv_layers(r) if m.int8] for r in self.replicas]
        self.int8_convs = self._int8_convs[0]
        self.programs: Dict[tuple, CapturedProgram] = {}
        self._pools: Dict[torch.device, object] = {}
        self._lock = threading.Lock()
        self.names = dict(names)
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.iou_thres_between_tasks = iou_thres_between_tasks
        self.max_det = max_det
        self.img_size = img_size
        self.stride = int(max(model.strides))
        self.categories_map, self.all_class_names = build_category_map(self.names)
        self.task_order = list(self.names.keys())
        if warmup_batch is not None:
            self.predict(np.zeros((warmup_batch, img_size, img_size, 3), np.float32))

    @property
    def _pool(self):
        """The graph memory pool of the programs on `device` (None before
        the first capture)."""
        return self._pools.get(self.device)

    def program_key(self, batch: torch.Tensor, conf_thres: float, iou_thres: float,
                    iou_bt: float, agnostic: bool, max_det: int,
                    replica: Optional[int] = None) -> tuple:
        """The key of `predict`'s captured program for this request; over a
        mesh, `batch` is a replica's rows and the key ends with the
        replica's index."""
        key = (tuple(batch.shape), batch.dtype, self.dtype, self.int8, float(conf_thres),
               float(iou_thres), float(iou_bt), bool(agnostic), int(max_det))
        return key if self.mesh is None else key + (int(replica or 0),)

    @torch.no_grad()
    def predict_device(self, batch: torch.Tensor, conf_thres: float, iou_thres: float,
                       iou_bt: float, agnostic: bool, max_det: int,
                       use_kernel: Optional[bool] = None, replica: int = 0):
        """The device part: batch (B, H, W, 3) on the device -> merged
        (B, T*max_det, 6), task_idx (B, T*max_det), keep (B, T*max_det).
        use_kernel as in `predict`; replica: the mesh replica that runs it
        (its device holds the batch)."""
        x = batch.permute(0, 3, 1, 2).to(self.dtype)
        int8_convs = self._int8_convs[replica]
        for m in int8_convs:
            m.use_kernel = use_kernel
        try:
            out = self.replicas[replica](x)
        finally:
            for m in int8_convs:
                m.use_kernel = None
        tracing.mark("forward")
        dets_all, task_idx_all = [], []
        for ti, task in enumerate(self.task_order):
            pred, _ = out[task]
            dets, _ = non_max_suppression(
                pred, nc=len(self.names[task]), conf_thres=float(conf_thres),
                iou_thres=float(iou_thres), agnostic=agnostic, max_det=max_det,
                use_kernel=use_kernel)
            offset = self.categories_map[task][0]
            cls_global = torch.where(dets[..., 4:5] > 0, dets[..., 5:6] + offset, 0.0)
            dets_all.append(torch.cat([dets[..., :5], cls_global], dim=-1))
            task_idx_all.append(torch.full(dets.shape[:2], ti, dtype=torch.int32,
                                           device=dets.device))
        tracing.mark("nms")
        merged = torch.cat(dets_all, dim=1)
        task_idx = torch.cat(task_idx_all, dim=1)
        # task-major with max_det rows per task: the last task's rows never act
        scan_rows = (len(self.task_order) - 1) * max_det
        keep = cross_task_suppress(merged, task_idx, float(iou_bt), scan_rows=scan_rows)
        tracing.mark("cross_task")
        return merged, task_idx, keep

    def predict(self, batch,
                original_shape: Union[Tuple[int, int], List[Tuple[int, int]], None] = None,
                max_det: Optional[int] = None, agnostic_nms: bool = False,
                conf_thres: Optional[float] = None, iou_thres: Optional[float] = None,
                iou_thres_between_tasks: Optional[float] = None,
                use_kernel: Optional[bool] = None) -> List[List[Dict]]:
        """batch: (B, H, W, 3) float NHWC in [0, 1], numpy or tensor
        (CerberusPreprocessor's output). Returns per image a list of
        {box, score, label, label_name, task} dicts, by descending score.
        use_kernel=False runs the plain NMS loop and the plain int8 convs
        instead of their kernels, eagerly (a test hook; see ops/nms.py and
        nn/module.py:conv2d_int8). Over a mesh the batch's rows are split
        evenly over the replicas (the row count must divide by the mesh's
        size)."""
        conf_thres = self.conf_thres if conf_thres is None else conf_thres
        iou_thres = self.iou_thres if iou_thres is None else iou_thres
        iou_bt = (self.iou_thres_between_tasks if iou_thres_between_tasks is None
                  else iou_thres_between_tasks)
        max_det = self.max_det if max_det is None else max_det
        batch = torch.as_tensor(batch)
        with tracing.span("predict", batch.shape[0]):
            return self._predict(batch, original_shape, (
                float(conf_thres), float(iou_thres), float(iou_bt), bool(agnostic_nms),
                int(max_det)), use_kernel)

    def _predict(self, batch: torch.Tensor, original_shape, args: tuple,
                 use_kernel: Optional[bool]) -> List[List[Dict]]:
        n = len(self.replicas)
        if batch.shape[0] % n:
            raise ValueError(f"a batch of {batch.shape[0]} does not divide over the "
                             f"{n}-device mesh")
        parts = batch.chunk(n) if n > 1 else (batch,)
        devices = self.mesh or [self.device]
        if self.device.type == "cuda" and use_kernel is not False:
            with self._lock:
                progs = [self._program(i, part, args) for i, part in enumerate(parts)]
                outs = [p.run(part) for p, part in zip(progs, parts)]
                with tracing.span("copy_out"):
                    hosts = [o.cpu() for o in outs]  # every replica's replay queued first
                for p in progs:
                    p.marks.collect()  # complete: the copy out waited for the replays
        else:
            hosts = [pack_outputs(*self.predict_device(part.to(devices[i]), *args, use_kernel,
                                                       replica=i)).cpu()
                     for i, part in enumerate(parts)]
        m = len(self.task_order) * args[-1]
        with tracing.span("unpack"):
            merged, task_idx, keep = (np.concatenate(x) for x in zip(*[
                unpack_outputs(h.numpy(), part.shape[0], m) for h, part in zip(hosts, parts)]))

        net_shape = tuple(batch.shape[1:3])
        results: List[List[Dict]] = []
        with tracing.span("format"):
            for i in range(len(merged)):
                det = merged[i][keep[i]]
                tidx = task_idx[i][keep[i]]
                order = np.argsort(-det[:, 4])
                det, tidx = det[order], tidx[order]
                if len(det) and original_shape is not None:
                    shape = (original_shape[i] if isinstance(original_shape, list)
                             else original_shape)
                    det[:, :4] = scale_boxes_np(net_shape, det[:, :4], shape).round()
                image_results = []
                for row, ti in zip(det, tidx):
                    c = int(row[5])
                    image_results.append({
                        "box": [int(v) for v in row[:4]],
                        "score": float(row[4]),
                        "label": c,
                        "label_name": self.all_class_names[c],
                        "task": self.task_order[int(ti)],
                    })
                results.append(image_results)
        return results

    def _program(self, replica: int, part: torch.Tensor, args: tuple) -> CapturedProgram:
        """The captured program of `replica` for rows `part` and the static
        arguments `args`, captured at its key's first request."""
        key = self.program_key(part, *args, replica=replica)
        prog = self.programs.get(key)
        if prog is None:
            dev = (self.mesh or [self.device])[replica]
            if dev not in self._pools:
                self._pools[dev] = torch.cuda.graph_pool_handle()

            def device_fn(x):
                out = pack_outputs(*self.predict_device(x, *args, replica=replica))
                tracing.mark("pack")
                return out

            prog = CapturedProgram(device_fn, part, dev, self._pools[dev], SERVING_KERNELS)
            self.programs[key] = prog
        return prog


def pack_outputs(merged: torch.Tensor, task_idx: torch.Tensor,
                 keep: torch.Tensor) -> torch.Tensor:
    """predict_device's outputs as the bytes of one buffer, for one copy to
    the host: merged float32, task_idx int32, keep bool."""
    return torch.cat([merged.float().reshape(-1).view(torch.uint8),
                      task_idx.to(torch.int32).reshape(-1).view(torch.uint8),
                      keep.reshape(-1).view(torch.uint8)])


def unpack_outputs(buf: np.ndarray, b: int, m: int):
    """pack_outputs's buffer on the host -> (merged (b, m, 6), task_idx (b, m), keep (b, m))."""
    n = b * m
    return (buf[:24 * n].view(np.float32).reshape(b, m, 6),
            buf[24 * n:28 * n].view(np.int32).reshape(b, m),
            buf[28 * n:].view(np.bool_).reshape(b, m))
