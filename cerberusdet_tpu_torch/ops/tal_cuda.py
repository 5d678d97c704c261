"""Task-aligned assigner: the CUDA kernels for Hopper and the plain version.

The kernels (csrc/tal.cu) replace cerberusdet_tpu/ops/tal_pallas.py:
_pass1_kernel and _pass2_kernel. They run as three launches, each with its
own launch count: `select_kernel` (per valid gt row, the top-k of
align * in_gt: per-warp top-k lists by warp reductions, then one merge),
`assign_kernel` (per anchor, the resolved gt and the gathered targets, per
gt the maxima of align and CIoU) and `norm_kernel` (the normalised target
scores). csrc/tal.cu says how the work is split and why it is exact. Bound:
at the flagship shapes the launches and the dependent steps of the top-k and
of the multi-claim argmax, not bytes (~12 MB) or operations (~0.2 G).

`task_aligned_assign` launches them for tensors on the card, or raises on
anything they do not take, and runs the plain version, `TaskAlignedAssigner`
of train/tal.py (imported here, beside the kernels), for tensors on the CPU
or when asked to with use_kernel=False. Both compute arctan(w / (h + eps))
once per box (ops/boxes.box_atan) and use the same values.
"""

from __future__ import annotations

import ctypes

import torch

from cerberusdet_tpu_torch.ops import cuda_build
from cerberusdet_tpu_torch.ops.boxes import box_atan
from cerberusdet_tpu_torch.train.tal import AssignResult, TaskAlignedAssigner

__all__ = ["AssignResult", "TaskAlignedAssigner", "task_aligned_assign", "select_kernel",
           "assign_kernel", "norm_kernel", "selection_mask", "kernel_inputs", "build"]

SOURCE = cuda_build.CSRC / "tal.cu"
MAX_N = 49152   # one gt row of top-k keys in shared memory: 192 KB
MAX_M = 8192    # gt boxes, arctans and labels in shared memory: 24 B each
MAX_BETA = 16
MAX_TOPK = 512  # tal_select's 8 per-warp lists beside the keys: 64 B a rank

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SELECT_ARGS = [_P] * 8 + [_I] * 6 + [_P, _P]
_ASSIGN_ARGS = [_P] * 7 + [_I] * 6 + [_P] * 7
_NORM_ARGS = [_P] * 5 + [_I] * 4 + [_F, _P, _P]


def build(verbose: bool = False):
    """Compile csrc/tal.cu (once) and return the library's path."""
    return cuda_build.build(SOURCE, verbose)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"TAL kernel {name} failed to launch: CUDA error {err}")


def select_kernel(inp, k: int, beta: int) -> torch.Tensor:
    """Launch tal_select. `inp` is what `kernel_inputs` returns. Returns sel
    (B, M, k) int32: the first-occurrence top-k anchors of each valid gt row
    that lie inside the gt, else -1."""
    b, n, nc = inp["scores"].shape
    m = inp["labels"].shape[1]
    sel = torch.empty((b, m, k), dtype=torch.int32, device=inp["scores"].device)
    fn = cuda_build.load(SOURCE, "cerberus_tal_select", _SELECT_ARGS)
    err = fn(*(inp[key].data_ptr() for key in ("scores", "pd_bboxes", "anchors", "at_pd",
                                               "labels", "gt_bboxes", "at_gt", "mask_gt")),
             b, n, m, nc, k, beta, sel.data_ptr(), _stream(sel))
    _check(err, "tal_select")
    select_kernel.launches += 1
    return sel


def assign_kernel(inp, sel: torch.Tensor, beta: int):
    """Launch tal_assign on sel. Returns (target_gt_idx (B, N) int64, fg_mask
    (B, N) bool, target_labels (B, N) int64, target_bboxes (B, N, 4), align at
    the target (B, N), pos (B, M, 2) = each gt's (max align, max CIoU))."""
    b, n, nc = inp["scores"].shape
    m, k = sel.shape[1], sel.shape[2]
    dev = sel.device
    tgt = torch.empty((b, n), dtype=torch.int64, device=dev)
    fg = torch.empty((b, n), dtype=torch.bool, device=dev)
    labels = torch.empty((b, n), dtype=torch.int64, device=dev)
    boxes = torch.empty((b, n, 4), dtype=torch.float32, device=dev)
    align = torch.empty((b, n), dtype=torch.float32, device=dev)
    pos = torch.zeros((b, m, 2), dtype=torch.float32, device=dev)
    fn = cuda_build.load(SOURCE, "cerberus_tal_assign", _ASSIGN_ARGS)
    err = fn(*(inp[key].data_ptr() for key in ("scores", "pd_bboxes", "at_pd", "labels",
                                               "gt_bboxes", "at_gt")),
             sel.data_ptr(), b, n, m, nc, k, beta, tgt.data_ptr(), fg.data_ptr(),
             labels.data_ptr(), boxes.data_ptr(), align.data_ptr(), pos.data_ptr(),
             _stream(sel))
    _check(err, "tal_assign")
    assign_kernel.launches += 1
    return tgt, fg, labels, boxes, align, pos


def norm_kernel(tgt, fg, labels, align, pos, nc: int, eps: float) -> torch.Tensor:
    """Launch tal_norm. Returns target_scores (B, N, nc) float32."""
    b, n = tgt.shape
    m = pos.shape[1]
    scores = torch.empty((b, n, nc), dtype=torch.float32, device=tgt.device)
    fn = cuda_build.load(SOURCE, "cerberus_tal_norm", _NORM_ARGS)
    err = fn(tgt.data_ptr(), fg.data_ptr(), labels.data_ptr(), align.data_ptr(),
             pos.data_ptr(), b, n, m, nc, float(eps), scores.data_ptr(), _stream(tgt))
    _check(err, "tal_norm")
    norm_kernel.launches += 1
    return scores


select_kernel.launches = 0
assign_kernel.launches = 0
norm_kernel.launches = 0


def selection_mask(sel: torch.Tensor, n: int) -> torch.Tensor:
    """sel (B, M, k) with -1 for none -> (B, M, N) bool: the positives of
    select_kernel as the plain version's mask_pos before resolving."""
    b, m, _ = sel.shape
    idx = torch.where(sel < 0, n, sel).long()
    mask = torch.zeros((b, m, n + 1), dtype=torch.bool, device=sel.device)
    return mask.scatter_(2, idx, True)[..., :n]


def kernel_inputs(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                  num_classes: int):
    """Check what the kernels take, raise on anything else, and add the
    per-box arctans. Returns the kernels' input dict."""
    ts = dict(scores=pd_scores, pd_bboxes=pd_bboxes, anchors=anc_points, labels=gt_labels,
              gt_bboxes=gt_bboxes, mask_gt=mask_gt)
    dev = pd_scores.device
    for key, t in ts.items():
        if t.device != dev:
            raise ValueError(f"TAL kernels need every tensor on {dev}; {key} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"TAL kernels need contiguous inputs; {key} is not")
    for key in ("scores", "pd_bboxes", "anchors", "gt_bboxes"):
        if ts[key].dtype != torch.float32:
            raise TypeError(f"TAL kernels take float32 {key}, got {ts[key].dtype}")
    if gt_labels.dtype != torch.int64 or mask_gt.dtype != torch.bool:
        raise TypeError(f"TAL kernels take int64 gt_labels and bool mask_gt, got "
                        f"{gt_labels.dtype} and {mask_gt.dtype}")
    if pd_scores.dim() != 3:
        raise ValueError(f"pd_scores must be (B, N, nc), got {tuple(pd_scores.shape)}")
    b, n, nc = pd_scores.shape
    m = gt_labels.shape[-1]
    shapes = {"pd_bboxes": (b, n, 4), "anchors": (n, 2), "labels": (b, m),
              "gt_bboxes": (b, m, 4), "mask_gt": (b, m)}
    for key, shape in shapes.items():
        if tuple(ts[key].shape) != shape:
            raise ValueError(f"{key} must be {shape}, got {tuple(ts[key].shape)}")
    if nc != num_classes:
        raise ValueError(f"pd_scores class dim {nc} != num_classes {num_classes}")
    if not (1 <= n <= MAX_N and 1 <= m <= MAX_M):
        raise ValueError(f"TAL kernels take 1..{MAX_N} anchors and 1..{MAX_M} gts, "
                         f"got {n} and {m}")
    if pd_bboxes.data_ptr() % 16 or gt_bboxes.data_ptr() % 16 or anc_points.data_ptr() % 8:
        raise ValueError("TAL kernels need 16-byte aligned boxes and 8-byte aligned anchors")
    ts["at_gt"] = box_atan(gt_bboxes)
    ts["at_pd"] = box_atan(pd_bboxes)
    return ts


def task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                        topk: int = 10, num_classes: int = 80, alpha: float = 0.5,
                        beta: float = 6.0, eps: float = 1e-9,
                        use_kernel: bool = True) -> AssignResult:
    """The assignment of TaskAlignedAssigner (same arguments and result).

    Tensors on the CPU, or use_kernel=False, take the plain version. On the
    card the kernels take float32 scores and boxes, int64 labels, a bool
    mask, contiguous, alpha = 0.5, an integer beta in 1..MAX_BETA and topk in
    1..MAX_TOPK, and raise on anything else."""
    if not use_kernel or pd_scores.device.type == "cpu":
        plain = TaskAlignedAssigner(topk, num_classes, alpha, beta, eps)
        return plain(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt)
    if pd_scores.device.type != "cuda":
        raise ValueError(f"TAL kernels run on a CUDA device, got {pd_scores.device}")
    if alpha != 0.5 or not float(beta).is_integer() or not 1 <= beta <= MAX_BETA:
        raise ValueError(f"TAL kernels take alpha = 0.5 and an integer beta in "
                         f"1..{MAX_BETA}, got {alpha} and {beta}")
    if not 1 <= topk <= MAX_TOPK:
        raise ValueError(f"TAL kernels take topk in 1..{MAX_TOPK}, got {topk}")
    inp = kernel_inputs(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                        num_classes)
    k = min(topk, pd_scores.shape[1])
    with torch.cuda.device(pd_scores.device):
        sel = select_kernel(inp, k, int(beta))
        tgt, fg, labels, boxes, align, pos = assign_kernel(inp, sel, int(beta))
        scores = norm_kernel(tgt, fg, labels, align, pos, num_classes, eps)
    return AssignResult(labels, boxes, scores, fg, tgt)
