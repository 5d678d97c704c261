"""YOLOv8 detection loss (BCE cls + CIoU box + DFL), per task.

Counterpart of cerberusdet_tpu/train/loss.py. Batches carry ground truths
padded to a fixed count M with a validity mask ({'cls', 'bboxes' xywh
normalised, 'mask', 'prob'} of shape (B, M, ...)); 'prob' is carried and not
weighted, as in the reference. The assignment goes through
ops/tal_cuda.task_aligned_assign: the CUDA kernels on the card, the plain
version on the CPU (or on the card with use_kernel=False).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cerberusdet_tpu_torch.ops.anchors import bbox2dist, dfl_expectation, dist2bbox, make_anchors
from cerberusdet_tpu_torch.ops.boxes import bbox_iou, xywh2xyxy
from cerberusdet_tpu_torch.ops.tal_cuda import task_aligned_assign
from cerberusdet_tpu_torch.parallel.mesh import group_size


class LossItems(NamedTuple):
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor
    total: torch.Tensor


def _df_loss(pred_dist, target, reg_max: int):
    """Distribution focal loss per anchor: (..., 4, reg_max) logits vs (..., 4)
    continuous targets in [0, reg_max - 1). Returns (...,), the mean over the
    4 sides. The gather gives the values and gradients of the JAX package's
    masked sum: each of its sums has one nonzero term."""
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, dim=-1)

    def sel(idx):
        return logp.gather(-1, idx.clamp(0, reg_max - 1)[..., None])[..., 0]

    ce = -(sel(tl) * wl + sel(tr) * wr)
    return ce.mean(dim=-1)


def sigmoid_bce(logits, labels):
    """Elementwise BCE-with-logits, the stable form."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def scale_loss_gains(box_w: float, cls_w: float, nl: int, imgsz: int):
    """Gain scaling of the reference's models_manager.fill_tasks_parameters."""
    return box_w * 3.0 / nl, cls_w * (imgsz / 640) ** 2 * 3.0 / nl


class DetectionLoss:
    """Per-task loss. use_kernel=False takes the plain assigner on the card
    too (a comparison hook; the kernels are the path)."""

    def __init__(self, nc: int, strides: Sequence[float], box_w: float = 7.5,
                 cls_w: float = 0.5, dfl_w: float = 1.5, reg_max: int = 16,
                 topk: int = 10, alpha: float = 0.5, beta: float = 6.0,
                 use_kernel: bool = True):
        self.nc = nc
        self.reg_max = reg_max
        self.no = nc + 4 * reg_max
        self.strides = tuple(strides)
        self.weights = dict(box=box_w, cls=cls_w, dfl=dfl_w)
        self.topk, self.alpha, self.beta = topk, alpha, beta
        self.use_kernel = use_kernel

    def decode(self, feats: List[torch.Tensor], batch: Dict[str, torch.Tensor]):
        """Flattened float32 predictions, anchors, decoded boxes (feature
        units) and the padded ground truths in input pixels, as a dict."""
        b = feats[0].shape[0]
        shapes = [(f.shape[2], f.shape[3]) for f in feats]
        dev = feats[0].device
        anchor_points, stride_tensor = make_anchors(shapes, self.strides, device=dev)
        flat = torch.cat([f.reshape(b, self.no, -1) for f in feats], 2).transpose(1, 2)
        pred_distri = flat[..., : 4 * self.reg_max].float()
        pred_scores = flat[..., 4 * self.reg_max:].float()

        img_h = shapes[0][0] * self.strides[0]
        img_w = shapes[0][1] * self.strides[0]
        # (w, h, w, h), made on the device: a copy from the host would be a host
        # synchronisation, which a captured step cannot hold
        scale = torch.full((4,), float(img_w), dtype=torch.float32, device=dev)
        scale[1::2] = img_h
        mask_gt = batch["mask"].bool()
        # padded rows are zeroed: the reference's sum(box) > 0 validity
        gt_bboxes = torch.where(mask_gt[:, :, None],
                                xywh2xyxy(batch["bboxes"].float() * scale), 0.0)
        dist = dfl_expectation(pred_distri, self.reg_max)
        pred_bboxes = dist2bbox(dist, anchor_points[None], xywh=False)  # (B, N, 4)
        return dict(pred_distri=pred_distri, pred_scores=pred_scores,
                    anchor_points=anchor_points, stride_tensor=stride_tensor,
                    pred_bboxes=pred_bboxes, gt_labels=batch["cls"].long().contiguous(),
                    gt_bboxes=gt_bboxes, mask_gt=mask_gt.contiguous())

    def assign_args(self, d):
        """The assigner's six inputs (detached, in input pixels)."""
        return (torch.sigmoid(d["pred_scores"].detach()).contiguous(),
                (d["pred_bboxes"].detach() * d["stride_tensor"][None]).contiguous(),
                (d["anchor_points"] * d["stride_tensor"]).contiguous(),
                d["gt_labels"], d["gt_bboxes"], d["mask_gt"])

    def __call__(self, feats: List[torch.Tensor], batch: Dict[str, torch.Tensor], group=None):
        """feats: per-level (B, no, H, W) Detect training outputs; batch:
        {'cls' (B, M), 'bboxes' (B, M, 4), 'mask' (B, M), 'prob', optional
        'img_mask' (B,)} on feats' device. Returns (the optimisation loss,
        LossItems of detached scalars).

        group: a torch.distributed process group whose ranks hold the other
        rows of the global batch (data parallelism, parallel/mesh.py). The
        loss is then this rank's share of the global batch's loss, as JAX's
        loss over a mesh: the target-score sum and the row count (valid rows
        with img_mask, B without) are the global ones, so that the ranks'
        gradients summed are the global loss's, and the items are the global
        batch's on every rank."""
        b = feats[0].shape[0]
        d = self.decode(feats, batch)
        assign = task_aligned_assign(*self.assign_args(d), topk=self.topk,
                                     num_classes=self.nc, alpha=self.alpha,
                                     beta=self.beta, use_kernel=self.use_kernel)
        target_scores = assign.target_scores

        # per-image validity: padded rows contribute no loss. The target-score
        # sum and the valid-row count are the global batch's over `group`.
        img_mask = batch.get("img_mask")
        if img_mask is None:
            sums = target_scores.sum()[None]
        else:
            img_mask = img_mask.float()
            sums = torch.stack([target_scores.sum(), img_mask.sum()])
        if group is not None:
            dist.all_reduce(sums, group=group)
        tss = sums[0].clamp(min=1.0)
        n_eff = b * group_size(group) if img_mask is None else sums[1].clamp(min=1.0)

        pred_scores = d["pred_scores"]
        bce = sigmoid_bce(pred_scores, target_scores)
        if img_mask is not None:
            bce = bce * img_mask[:, None, None]
        loss_cls = bce.sum() / tss

        # box + dfl on foreground anchors
        weight = target_scores.sum(-1) * assign.fg_mask  # (B, N)
        if img_mask is not None:
            weight = weight * img_mask[:, None]
        target_bboxes = assign.target_bboxes / d["stride_tensor"][None]
        iou = bbox_iou(d["pred_bboxes"], target_bboxes, xywh=False, CIoU=True)
        loss_box = ((1.0 - iou) * weight).sum() / tss
        target_ltrb = bbox2dist(d["anchor_points"], target_bboxes, float(self.reg_max - 1))
        dfl = _df_loss(d["pred_distri"].reshape(b, -1, 4, self.reg_max), target_ltrb,
                       self.reg_max)
        loss_dfl = (dfl * weight).sum() / tss

        box = loss_box * self.weights["box"]
        cls = loss_cls * self.weights["cls"]
        dfl_l = loss_dfl * self.weights["dfl"]
        total = box + cls + dfl_l
        items = LossItems(*[v.detach() for v in (box, cls, dfl_l, total)])
        if group is not None:
            summed = torch.stack(items)
            dist.all_reduce(summed, group=group)
            items = LossItems(*summed.unbind())
        # the reference's optimisation loss is 2 * (box + cls + dfl) * B (its
        # loss vector's last entry already holds the sum); n_eff replaces B
        # when the batch carries padded rows. `items` stay un-doubled.
        return 2.0 * total * n_eff, items
