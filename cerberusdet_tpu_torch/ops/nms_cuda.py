"""Batched greedy NMS: the plain PyTorch loop and its CUDA kernel for Hopper.

The kernel (csrc/nms.cu) replaces cerberusdet_tpu/ops/nms_pallas.py:_nms_kernel.
On this card it is bound by the chain of max_det dependent steps and, within
a step, by the IoU test of every live candidate against the pick, not by
bytes. Its design: one thread block per image; the positive candidates
compacted into shared memory (boxes, scores, indices), so a step touches
only shared memory; one pass a step that suppresses and finds the next pick
at once, with one barrier; the survivors re-compacted as they thin out;
scores <= 0 handled after the positive picks run out, as the plain loop
handles them. Candidates beyond the shared memory's 10240 slots continue in
a scratch buffer in global memory that the wrapper allocates. The IoU
follows the plain loop's operation order with FMA contraction off, so both
select the same indices bit for bit.

The kernel is built with nvcc from the package's sources at first use, into
cerberusdet_tpu_torch/build/, as a shared library with a plain C interface
loaded through ctypes (ops/cuda_build.py). `greedy_nms_cuda` launches it for
tensors on the card (or raises) and runs the plain loop for tensors on the
CPU; its attribute `launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from cerberusdet_tpu_torch.ops import cuda_build
from cerberusdet_tpu_torch.ops.boxes import box_area

MAX_K = 16384  # original indices are 16-bit in the kernel's slots

SOURCE = cuda_build.CSRC / "nms.cu"


def greedy_nms(boxes, scores, iou_thres: float, max_det: int):
    """Exact greedy NMS, batched; the plain version of the kernel.

    boxes (B, K, 4) xyxy (class offsets applied by the caller), scores (B, K)
    with <= 0 meaning invalid. Each of max_det steps takes the argmax of the
    live scores (lowest index on ties), records it with valid = score > 0 and
    zeroes the pick and every box with IoU > iou_thres.
    Returns (idx (B, max_det) int32, valid (B, max_det) bool)."""
    b = scores.shape[0]
    rows = torch.arange(b, device=scores.device)
    live = scores.clone()
    area = box_area(boxes)
    idx = torch.zeros((b, max_det), dtype=torch.int32, device=scores.device)
    valid = torch.zeros((b, max_det), dtype=torch.bool, device=scores.device)
    for i in range(max_det):
        j = live.argmax(dim=1)
        s = live[rows, j]
        p = boxes[rows, j][:, None, :]                                  # (B, 1, 4)
        iw = (torch.minimum(p[..., 2], boxes[..., 2])
              - torch.maximum(p[..., 0], boxes[..., 0])).clamp(min=0.0)
        ih = (torch.minimum(p[..., 3], boxes[..., 3])
              - torch.maximum(p[..., 1], boxes[..., 1])).clamp(min=0.0)
        inter = iw * ih
        iou = inter / (area[rows, j][:, None] + area - inter + 1e-7)
        live = torch.where(iou > iou_thres, 0.0, live)
        live[rows, j] = 0.0
        idx[:, i] = j.to(torch.int32)
        valid[:, i] = s > 0.0
    return idx, valid


def build(verbose: bool = False):
    """Compile csrc/nms.cu (once) and return the library's path."""
    return cuda_build.build(SOURCE, verbose)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def greedy_nms_cuda(boxes, scores, iou_thres: float, max_det: int):
    """Greedy NMS through the CUDA kernel for tensors on the card; the plain
    `greedy_nms` for tensors on the CPU. Same contract as `greedy_nms`;
    on the card boxes must be float32 (B, K, 4) and scores float32 (B, K),
    contiguous, with 1 <= K <= MAX_K."""
    if boxes.device.type == "cpu" and scores.device.type == "cpu":
        return greedy_nms(boxes, scores, iou_thres, max_det)
    if boxes.device.type != "cuda" or boxes.device != scores.device:
        raise ValueError(f"NMS kernel needs both tensors on one CUDA device, got "
                         f"{boxes.device} and {scores.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"NMS kernel takes float32, got {boxes.dtype}/{scores.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"NMS kernel shapes: boxes {tuple(boxes.shape)} must be "
                         f"(B, K, 4) and scores {tuple(scores.shape)} (B, K)")
    b, k = scores.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"NMS kernel supports 1..{MAX_K} candidates, got {k}")
    if max_det < 1:
        raise ValueError(f"max_det must be positive, got {max_det}")
    if not (boxes.is_contiguous() and scores.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError("NMS kernel needs contiguous inputs and 16-byte aligned boxes")
    fn = cuda_build.load(SOURCE, "cerberus_nms_f32", _ARGTYPES)
    scratch_bytes = cuda_build.load(SOURCE, "cerberus_nms_scratch_bytes", [ctypes.c_int])(k)
    idx = torch.empty((b, max_det), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((b, max_det), dtype=torch.bool, device=boxes.device)
    if b == 0:
        return idx, valid
    # the candidates beyond the kernel's shared-memory slots (K > 10240)
    scratch = torch.empty(b * scratch_bytes, dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), b, k, max_det, float(iou_thres),
                 scratch.data_ptr(), idx.data_ptr(), valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: CUDA error {err}")
    greedy_nms_cuda.launches += 1
    return idx, valid


greedy_nms_cuda.launches = 0
