"""Batched NMS with fixed-shape outputs, and cross-task suppression.

Counterpart of cerberusdet_tpu/ops/nms.py. The greedy loop itself lives in
ops/nms_cuda.py beside its CUDA kernel (the plain `greedy_nms` and the
kernel's wrapper `greedy_nms_cuda`); this module chooses candidates, offsets
boxes by class, and formats the result:
  * outputs are (B, max_det, 6) rows [x1, y1, x2, y2, conf, cls] with a
    per-image count; padding rows are 0;
  * candidate top-k is a stable sort (lax.top_k's lowest-index tie rule;
    torch.topk on CUDA does not promise it);
  * cross_task_suppress is batched over B.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cerberusdet_tpu_torch.ops.boxes import box_iou, xywh2xyxy
from cerberusdet_tpu_torch.ops.nms_cuda import MAX_K, greedy_nms, greedy_nms_cuda

MAX_WH = 4096.0  # class-offset multiplier (plenty above any input size)

__all__ = ["MAX_WH", "greedy_nms", "select_candidates", "non_max_suppression",
           "cross_task_suppress"]


def _top_k(x, k: int):
    """(values, indices) of the k largest along dim 1, ties to the lower index."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _gather_rows(x, idx):
    """x (B, N, C), idx (B, K) -> (B, K, C)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def select_candidates(prediction, nc: int, conf_thres: float, multi_label: bool,
                      classes: Optional[Sequence[int]], max_nms: int, agnostic: bool):
    """The greedy loop's inputs. prediction (B, N, 4+nc) xywh + scores ->
    (boxes xyxy (B,K,4), conf (B,K), cls (B,K) float32, offset_boxes (B,K,4)),
    where conf is 0 under `conf_thres` and offset_boxes are the boxes shifted
    by cls * MAX_WH (class-aware NMS)."""
    boxes = xywh2xyxy(prediction[..., :4])
    scores = prediction[..., 4:4 + nc]
    if classes is not None:
        keep = torch.zeros(nc, dtype=torch.bool, device=prediction.device)
        keep[list(classes)] = True
        scores = torch.where(keep, scores, 0.0)
    if multi_label and nc > 1:
        flat = torch.where(scores > conf_thres, scores, 0.0).reshape(scores.shape[0], -1)
        conf, fidx = _top_k(flat, min(max_nms, flat.shape[1]))
        boxes, cls = _gather_rows(boxes, fidx // nc), (fidx % nc).to(torch.float32)
    else:
        conf = scores.amax(dim=-1)
        cls = scores.argmax(dim=-1).to(torch.float32)
        conf = torch.where(conf > conf_thres, conf, 0.0)
        k = min(max_nms, conf.shape[1])
        # without truncation the sort is skipped: greedy NMS selects by argmax
        # with lowest-index ties, so candidate order cannot change the set
        if k < conf.shape[1]:
            conf, aidx = _top_k(conf, k)
            boxes, cls = _gather_rows(boxes, aidx), torch.gather(cls, 1, aidx)
    offset = torch.zeros_like(cls) if agnostic else cls * MAX_WH
    return boxes, conf.contiguous(), cls, (boxes + offset[..., None]).contiguous()


def non_max_suppression(prediction, nc: int, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, classes: Optional[Sequence[int]] = None,
                        agnostic: bool = False, multi_label: bool = False,
                        max_det: int = 300, max_nms: int = 30000,
                        use_kernel: Optional[bool] = None):
    """Batched NMS. prediction: (B, N, 4+nc), xywh pixel boxes + sigmoid
    scores (the Detect output).

    use_kernel: None takes the CUDA kernel for a tensor on the card and the
    plain loop on the CPU; False forces the plain loop (a test hook, used to
    hold the kernel against it on the card). On the kernel path `max_nms` is
    clamped to the kernel's 16384 candidates, as on the JAX package's Pallas
    path; a comparison with the plain loop passes max_nms=MAX_K so that
    both see the same candidates.

    Returns (dets (B, max_det, 6), counts (B,))."""
    if use_kernel is None:
        use_kernel = prediction.device.type == "cuda"
    if use_kernel:
        max_nms = min(max_nms, MAX_K)
    boxes, conf, cls, offset_boxes = select_candidates(
        prediction, nc, conf_thres, multi_label, classes, max_nms, agnostic)
    nms = greedy_nms_cuda if use_kernel else greedy_nms
    idx, valid = nms(offset_boxes, conf, iou_thres, max_det)
    idx = idx.long()
    det = torch.cat([_gather_rows(boxes, idx),
                     torch.gather(conf, 1, idx)[..., None],
                     torch.gather(cls, 1, idx)[..., None]], dim=-1)
    det = torch.where(valid[..., None], det, 0.0)
    return det, valid.sum(dim=1)


def cross_task_suppress(dets, task_idx, iou_thres: float = 0.8,
                        scan_rows: Optional[int] = None):
    """Cross-task dedup, batched: if boxes of DIFFERENT tasks overlap above
    `iou_thres`, keep only the highest-confidence one.

    Same decisions as cerberusdet_tpu/ops/nms.py:cross_task_suppress, with
    the reference quirks it lists (deleted columns stay in later groups and
    can win them; columns beat the row on equal conf, lower-index columns
    beat higher). Rows must be task-major. Everything a row would do is
    computed for all rows at once; only the gate "row i not yet deleted" is
    a sequential scan, over `scan_rows` rows ((T-1)*max_det on the
    inference path: rows of the last task never act).

    Args: dets (B, M, 6) rows [x1, y1, x2, y2, conf, cls] (padding conf 0);
      task_idx (B, M) or (M,) int task of each row.
    Returns keep (B, M) bool (padding rows excluded)."""
    b, m = dets.shape[:2]
    task_idx = task_idx.expand(b, m)
    boxes, conf = dets[..., :4], dets[..., 4]
    iou = box_iou(boxes, boxes)
    valid = conf > 0.0
    cross = task_idx[:, :, None] != task_idx[:, None, :]
    upper = task_idx[:, :, None] < task_idx[:, None, :]
    row_overlap = (iou > iou_thres) & cross & upper & valid[:, :, None] & valid[:, None, :]
    col_scores = torch.where(row_overlap, conf[:, None, :], -1.0)
    cw = col_scores.argmax(dim=-1)                                     # (B, M)
    best = torch.gather(col_scores, 2, cw[..., None])[..., 0]
    rows = torch.arange(m, device=dets.device)
    winner = torch.where(conf > best, rows, cw)   # the row wins only if strictly higher
    group = row_overlap | torch.eye(m, dtype=torch.bool, device=dets.device)
    to_del = group & (rows[None, None, :] != winner[..., None])       # (B, M, M)
    acts = row_overlap.any(dim=-1)                                     # (B, M)
    deleted = torch.zeros((b, m), dtype=torch.bool, device=dets.device)
    for i in range(m if scan_rows is None else min(scan_rows, m)):
        gate = acts[:, i] & ~deleted[:, i]
        deleted |= to_del[:, i] & gate[:, None]
    return valid & ~deleted
