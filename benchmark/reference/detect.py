"""Plain reference of the serving path around the forward: letterbox, per-task
NMS, the global class ids, suppression between tasks and the boxes scaled
back to each frame. Independent of the program; numpy on the host where the
work is a sequential decision.

Semantics (the CerberusDet inference contract):
  * letterbox: BGR -> RGB, resized keeping the aspect (bilinear, half-pixel
    centres, antialiased when it shrinks), centred on a gray (114) canvas of
    the network size, /255;
  * per task: a candidate per anchor, its best class and score, kept above
    conf_thres; greedy NMS in descending score (ties to the lower anchor)
    within each class, IoU > iou_thres suppresses, at most max_det kept;
  * a task's class c is global class c + the classes of the tasks before it;
  * between tasks: rows in task order, each task's rows in NMS order; each
    row of a task but the last that is not yet deleted and overlaps rows of
    later tasks above iou_between (IoU >) forms a group with them: the
    highest score of those rows wins (the lower row on ties) unless the row's
    own score is strictly higher, and the others are deleted; a deleted row
    still joins later groups and may win them;
  * boxes are mapped back to the frame (pad removed, divided by the gain,
    clipped) and rounded.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PAD = 114.0


def letterbox_geometry(shape: Tuple[int, int], size: int):
    """(gain, (new_h, new_w), (top, left)) of a (h, w) frame on a size x size canvas."""
    h, w = shape
    r = min(size / h, size / w)
    nw, nh = int(round(w * r)), int(round(h * r))
    dw, dh = (size - nw) / 2, (size - nh) / 2
    return r, (nh, nw), (int(round(dh - 0.1)), int(round(dw - 0.1)))


def letterbox(frames: torch.Tensor, size: int) -> torch.Tensor:
    """frames (B, H, W, 3) uint8 BGR -> (B, 3, size, size) float32 RGB in [0, 1]."""
    _, (nh, nw), (top, left) = letterbox_geometry(tuple(frames.shape[1:3]), size)
    x = frames.flip(-1).permute(0, 3, 1, 2).float()
    if (nh, nw) != tuple(x.shape[2:]):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    out = torch.full((x.shape[0], 3, size, size), PAD, device=x.device)
    out[:, :, top:top + nh, left:left + nw] = x
    return out / 255.0


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes (N, 4) x (M, 4)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    return inter / (area(a)[:, None] + area(b)[None, :] - inter + 1e-7)


def nms(pred: np.ndarray, nc: int, conf: float, iou: float, max_det: int):
    """pred (N, 4 + nc) xywh + scores of one image and task -> (boxes xyxy,
    scores, classes) of the kept rows, in the order kept."""
    scores = pred[:, 4:4 + nc]
    cls = scores.argmax(1)
    sc = scores[np.arange(len(scores)), cls]
    idx = np.nonzero(sc > conf)[0]
    idx = idx[np.argsort(-sc[idx], kind="stable")]
    xy, wh = pred[idx, :2], pred[idx, 2:4]
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1)
    c, s = cls[idx], sc[idx]
    keep: List[int] = []
    alive = np.ones(len(idx), bool)
    for i in range(len(idx)):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) == max_det:
            break
        rest = np.nonzero(alive[i + 1:] & (c[i + 1:] == c[i]))[0] + i + 1
        if len(rest):
            alive[rest[iou_matrix(boxes[i:i + 1], boxes[rest])[0] > iou]] = False
    keep = np.array(keep, dtype=np.int64)
    return boxes[keep], s[keep], c[keep]


def between_tasks(boxes: np.ndarray, scores: np.ndarray, tasks: np.ndarray, iou: float,
                  n_tasks: int) -> np.ndarray:
    """keep mask of rows (task-major, each task in NMS order)."""
    m = len(boxes)
    over = (iou_matrix(boxes, boxes) > iou) & (tasks[:, None] < tasks[None, :])
    deleted = np.zeros(m, bool)
    for i in range(m):
        if tasks[i] >= n_tasks - 1 or deleted[i] or not over[i].any():
            continue
        cols = np.nonzero(over[i])[0]
        best = cols[np.argmax(scores[cols])]
        winner = i if scores[i] > scores[best] else best
        group = np.append(cols, i)
        deleted[group[group != winner]] = True
    return ~deleted


def detections(preds: Dict[str, np.ndarray], ncs: Sequence[int], frame_shape, size: int,
               conf: float, iou: float, iou_between: float, max_det: int):
    """preds {task: (N, 4 + nc)} of one image (tasks in order) -> (boxes
    (K, 4) float in frame pixels, unrounded, scores (K,), global labels (K,),
    task index (K,)), by descending score."""
    tasks = list(preds)
    rows_b, rows_s, rows_c, rows_t = [], [], [], []
    offset = 0
    for ti, (t, nc) in enumerate(zip(tasks, ncs)):
        b, s, c = nms(preds[t], nc, conf, iou, max_det)
        rows_b.append(b)
        rows_s.append(s)
        rows_c.append(c + offset)
        rows_t.append(np.full(len(s), ti))
        offset += nc
    b, s, c, t = (np.concatenate(x) for x in (rows_b, rows_s, rows_c, rows_t))
    keep = between_tasks(b, s, t, iou_between, len(tasks))
    b, s, c, t = b[keep], s[keep], c[keep], t[keep]
    order = np.argsort(-s, kind="stable")
    b, s, c, t = b[order], s[order], c[order], t[order]
    gain, _, (top, left) = letterbox_geometry(tuple(frame_shape), size)
    pad = ((size - frame_shape[1] * gain) / 2, (size - frame_shape[0] * gain) / 2)
    b = b.astype(np.float64).copy()
    b[:, [0, 2]] = np.clip((b[:, [0, 2]] - pad[0]) / gain, 0, frame_shape[1])
    b[:, [1, 3]] = np.clip((b[:, [1, 3]] - pad[1]) / gain, 0, frame_shape[0])
    return b, s.astype(np.float64), c.astype(np.int64), t.astype(np.int64)
