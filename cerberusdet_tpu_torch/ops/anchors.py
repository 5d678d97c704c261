"""Anchor-free grid machinery for the YOLOv8 head.

Counterpart of cerberusdet_tpu/ops/anchors.py (make_anchors, dist2bbox,
bbox2dist, dfl_expectation). Anchors are ordered level-major, then row-major over
(h, w), the order in which Detect flattens its feature maps.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_anchors(feat_shapes: Sequence[Tuple[int, int]], strides: Sequence[float],
                 grid_cell_offset: float = 0.5, dtype=torch.float32, device=None):
    """Returns (anchor_points (sum HW, 2) as (x, y) cell centres in feature
    units, stride_tensor (sum HW, 1))."""
    points, stride_out = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        stride_out.append(torch.full((h * w, 1), float(s), dtype=dtype, device=device))
    return torch.cat(points, dim=0), torch.cat(stride_out, dim=0)


def dist2bbox(distance, anchor_points, xywh: bool = True, dim: int = -1):
    """Decode (left, top, right, bottom) distances to boxes around anchors."""
    lt, rb = distance.chunk(2, dim=dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=dim)
    return torch.cat([x1y1, x2y2], dim=dim)


def bbox2dist(anchor_points, bbox, reg_max: float):
    """Encode xyxy boxes as (left, top, right, bottom) distances from the
    anchors, clamped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    dist = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1)
    return dist.clamp(0.0, reg_max - 0.01)


def dfl_expectation(distri, reg_max: int = 16):
    """DFL decode: softmax over reg_max bins, then the expected bin.
    distri: (..., 4 * reg_max), bin-major per side. Returns (..., 4)."""
    x = distri.reshape(*distri.shape[:-1], 4, reg_max)
    proj = torch.arange(reg_max, dtype=x.dtype, device=x.device)
    return torch.softmax(x, dim=-1) @ proj
