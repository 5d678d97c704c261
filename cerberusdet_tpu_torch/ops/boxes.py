"""Box geometry: coordinate conversion, pairwise IoU, host rescaling.

Counterpart of cerberusdet_tpu/ops/boxes.py (xywh2xyxy, box_iou) and of
scale_boxes_np in cerberusdet_tpu/evaluation/val.py. box_iou keeps the JAX
package's operation order and eps, so that IoU values, and the NMS decisions
taken on them, are the same bit for bit.
"""

from __future__ import annotations

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
