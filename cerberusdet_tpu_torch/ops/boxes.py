"""Box geometry: coordinate conversion, pairwise IoU, CIoU, host rescaling.

Counterpart of cerberusdet_tpu/ops/boxes.py (xywh2xyxy, box_iou, bbox_iou)
and of scale_boxes_np in cerberusdet_tpu/evaluation/val.py. box_iou and
bbox_iou keep the JAX package's operation order and eps, so that IoU values,
and the NMS decisions taken on them, are the same bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def xywh2xyxy(x):
    """(..., 4) centre-x, centre-y, w, h -> x1, y1, x2, y2."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)


def box_area(b):
    """(..., 4) xyxy -> (...,) as (x2 - x1) * (y2 - y1)."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(box1, box2, eps: float = 1e-7):
    """Pairwise IoU of two xyxy box sets: (..., N, 4) x (..., M, 4) -> (..., N, M).
    union = area1 + area2 - inter + eps, evaluated left to right."""
    a1, a2 = box1[..., :, None, :2], box1[..., :, None, 2:4]
    b1, b2 = box2[..., None, :, :2], box2[..., None, :, 2:4]
    inter_wh = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = box_area(box1)[..., :, None] + box_area(box2)[..., None, :] - inter + eps
    return inter / union


def box_atan(boxes, eps: float = 1e-7):
    """arctan(w / (h + eps)) of (..., 4) xyxy boxes: the CIoU aspect term."""
    return torch.atan((boxes[..., 2] - boxes[..., 0]) / (boxes[..., 3] - boxes[..., 1] + eps))


def bbox_iou(box1, box2, xywh: bool = True, CIoU: bool = False, eps: float = 1e-7,
             atans=None):
    """Elementwise IoU, or CIoU, of broadcastable (..., 4) boxes. The CIoU
    aspect-ratio weight alpha is detached, as the reference takes it under
    no_grad. Operation order and eps of the JAX bbox_iou. `atans` may give
    (arctan(w1/h1), arctan(w2/h2)) (box_atan of each xyxy set, broadcastable
    to the result), computed once per box instead of once per pair."""
    if xywh:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0.0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0.0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not CIoU:
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # convex width
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)  # convex height
    c2 = cw**2 + ch**2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    at1, at2 = (torch.atan(w1 / h1), torch.atan(w2 / h2)) if atans is None else atans
    v = (4 / math.pi**2) * (at2 - at1) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


def scale_boxes_np(img1_shape, boxes, img0_shape, ratio_pad=None):
    """Rescale xyxy boxes (numpy) from the letterboxed `img1_shape` (h, w)
    back to the original `img0_shape` (h, w) and clip to it."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    boxes = np.array(boxes, copy=True)
    boxes[:, [0, 2]] -= pad[0]
    boxes[:, [1, 3]] -= pad[1]
    boxes /= gain
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, img0_shape[1])
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, img0_shape[0])
    return boxes
