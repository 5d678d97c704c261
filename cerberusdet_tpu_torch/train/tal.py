"""Task-aligned assigner (anchor-free label assignment): the plain formulation.

Counterpart of cerberusdet_tpu/train/tal.py, and the plain version of the
CUDA kernels in csrc/tal.cu (ops/tal_cuda.py launches them). Static shapes:
ground truths are padded to a fixed count M with a validity mask. It runs in
three stages, the three kernels' split of the work:

  select_topk  the (B, M, N) planes (clipped CIoU, align = s^alpha ov^beta,
               anchor inside gt) and, per valid gt, the first-occurrence
               top-k of align * in_gt, kept where the anchor is inside;
  resolve      per anchor: the gt it goes to (the highest-CIoU gt over all M
               rows when several claim it), the gathered labels and boxes,
               and per gt the maxima of align and CIoU over its anchors;
  normalise    target_scores = one-hot(label) * align * pos_ov / (pos_align + eps).

The arctan terms of the CIoU are computed once per box (ops/boxes.box_atan)
and handed to the kernels too, so that both see the same values. The align
powers are a correctly rounded sqrt for alpha = 0.5 and a left-to-right
product for an integer beta, which the kernels repeat operation for
operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cerberusdet_tpu_torch.ops.boxes import bbox_iou, box_atan


class AssignResult(NamedTuple):
    target_labels: torch.Tensor   # (B, N) int64
    target_bboxes: torch.Tensor   # (B, N, 4) xyxy
    target_scores: torch.Tensor   # (B, N, nc)
    fg_mask: torch.Tensor         # (B, N) bool
    target_gt_idx: torch.Tensor   # (B, N) int64


def select_candidates_in_gts(xy_centers, gt_bboxes, eps: float = 1e-9):
    """(N, 2) anchor centres strictly inside (B, M, 4) xyxy gts -> (B, M, N) bool."""
    lt = gt_bboxes[..., None, :2]   # (B, M, 1, 2)
    rb = gt_bboxes[..., None, 2:4]
    deltas = torch.cat([xy_centers[None, None] - lt, rb - xy_centers[None, None]], dim=-1)
    return deltas.amin(dim=-1) > eps


def select_highest_overlaps(mask_pos, overlaps):
    """Resolve anchors claimed by several gts: keep the highest-CIoU gt over
    all M rows (first on ties). mask_pos/overlaps (B, M, N). Returns
    (target_gt_idx (B, N), fg count (B, N), mask_pos)."""
    fg = mask_pos.sum(dim=-2)
    multi = (fg > 1)[:, None, :]
    is_max = torch.zeros_like(mask_pos).scatter_(1, overlaps.argmax(dim=1, keepdim=True), 1.0)
    mask_pos = torch.where(multi, is_max, mask_pos)
    return mask_pos.argmax(dim=-2), mask_pos.sum(dim=-2), mask_pos


def align_metric(scores, overlaps, alpha: float, beta: float):
    """scores^alpha * overlaps^beta; sqrt for alpha = 0.5 and a left-to-right
    product for an integer beta >= 1 (the kernels' arithmetic)."""
    a = torch.sqrt(scores) if alpha == 0.5 else scores ** alpha
    if float(beta).is_integer() and beta >= 1:
        b = overlaps
        for _ in range(int(beta) - 1):
            b = b * overlaps
    else:
        b = overlaps ** beta
    return a * b


def topk_first(metrics, k: int):
    """(..., N) -> (..., k) indices of the k largest values, lowest index
    first among equals (the selection of lax.top_k)."""
    return torch.sort(metrics, dim=-1, descending=True, stable=True).indices[..., :k]


class TaskAlignedAssigner:
    def __init__(self, topk: int = 10, num_classes: int = 80, alpha: float = 0.5,
                 beta: float = 6.0, eps: float = 1e-9):
        self.topk = topk
        self.nc = num_classes
        self.alpha = alpha
        self.beta = beta
        self.eps = eps

    @torch.no_grad()
    def __call__(self, pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes,
                 mask_gt) -> AssignResult:
        """
        pd_scores (B, N, nc) sigmoid scores; pd_bboxes (B, N, 4) xyxy in
        input pixels; anc_points (N, 2) anchor centres in input pixels;
        gt_labels (B, M) class ids (padded entries arbitrary); gt_bboxes
        (B, M, 4) xyxy; mask_gt (B, M) bool validity.
        """
        labels = gt_labels.long().clamp(0, self.nc - 1)
        mask_pos, overlaps, align = self.select_topk(pd_scores, pd_bboxes, anc_points,
                                                     labels, gt_bboxes, mask_gt)
        tgt, fg, mask_pos, pos_align, pos_ov = self.resolve(mask_pos, overlaps, align)
        target_labels = labels.gather(1, tgt)
        target_bboxes = gt_bboxes.gather(1, tgt[..., None].expand(*tgt.shape, 4))
        target_scores = self.normalise(target_labels, fg, mask_pos, align, pos_align,
                                       pos_ov, pd_scores.dtype)
        return AssignResult(target_labels, target_bboxes, target_scores, fg, tgt)

    def select_topk(self, pd_scores, pd_bboxes, anc_points, labels, gt_bboxes, mask_gt):
        """Stage 1. Returns (mask_pos (B, M, N) float 0/1 before resolving,
        overlaps, align (B, M, N))."""
        b, m = labels.shape
        n = pd_scores.shape[1]
        # per-(gt, anchor) score of the gt's class: (B, M, N)
        bbox_scores = pd_scores.transpose(1, 2).gather(1, labels[:, :, None].expand(b, m, n))
        atans = (box_atan(gt_bboxes)[:, :, None], box_atan(pd_bboxes)[:, None, :])
        overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False,
                            CIoU=True, atans=atans).clamp(min=0.0)
        align = align_metric(bbox_scores, overlaps, self.alpha, self.beta)
        in_gts = select_candidates_in_gts(anc_points, gt_bboxes)
        metrics = align * in_gts
        idx = topk_first(metrics, min(self.topk, n))
        is_in_topk = torch.zeros_like(metrics).scatter_(-1, idx, 1.0)
        mask_pos = is_in_topk * in_gts * mask_gt[:, :, None]
        return mask_pos, overlaps, align

    @staticmethod
    def resolve(mask_pos, overlaps, align):
        """Stage 2. Returns (target_gt_idx (B, N), fg_mask (B, N), resolved
        mask_pos, pos_align (B, M), pos_ov (B, M)): each gt's largest align
        and CIoU over the anchors it keeps."""
        tgt, fg, mask_pos = select_highest_overlaps(mask_pos, overlaps)
        pos_align = (align * mask_pos).amax(dim=-1)
        pos_ov = (overlaps * mask_pos).amax(dim=-1)
        return tgt, fg > 0, mask_pos, pos_align, pos_ov

    def normalise(self, target_labels, fg, mask_pos, align, pos_align, pos_ov, dtype):
        """Stage 3: one-hot scores of the fg anchors, scaled per anchor by
        max_m align * pos_ov / (pos_align + eps)."""
        target_scores = torch.nn.functional.one_hot(target_labels, self.nc).to(dtype)
        target_scores = torch.where(fg[:, :, None], target_scores, 0.0)
        norm = ((align * mask_pos) * pos_ov[:, :, None]
                / (pos_align[:, :, None] + self.eps)).amax(dim=-2)
        return target_scores * norm[:, :, None]
