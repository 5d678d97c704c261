"""Plain reference of the multi-task train step, written from the method's
description (YOLOv8's loss with task-aligned assignment; CerberusDet's
gradient averaging over the tasks that share a block), float32.

One step over per-task batches, tasks in model order:
    for t: loss_t = 2 * B * (7.5 box + 0.5 cls + 1.5 dfl) of model(batch_t) on
           task t's head, BatchNorm from the batch's statistics; backward
           (gradients summed over the tasks)
    each block's gradients / the number of the step's tasks it serves
    clip: all gradients scaled by min(1, 10 / (global norm + 1e-6))
    SGD, nesterov: g' = g + 5e-4 p for conv weights; buf = mu buf + g';
           p -= lr[group] (g' + mu buf); groups: conv weights, BatchNorm
           scales, biases (the per-step lrs and momentum given)
Each BatchNorm's running statistics take each task's batch statistics as the
task's forward passes them: r = 0.97 r + 0.03 s (the variance unbiased).
After the update, the EMA of every parameter and running statistic (YOLO's
ModelEMA, from the initial weights): after the n-th step, with the decay
d = 0.9999 (1 - exp(-n / 2000)), ema = d ema + (1 - d) value.
The loss (per image, anchors A, classes C, padded ground truths):
  assignment: per valid gt the 10 anchors inside it (centre strictly inside)
    of largest s^0.5 * CIoU^6 (s the predicted score of the gt's class, ties
    to the lower anchor); an anchor several gts claim goes to the highest-
    CIoU one (the first on ties); target score = one-hot class *
    max_m (align * CIoU_max(m) / (align_max(m) + 1e-9));
  cls = sum BCE(logits, target scores) / max(sum target scores, 1);
  box = sum over fg anchors of (1 - CIoU(pred, target)) * w / the same sum,
  dfl = the two-bin cross entropy of each side's distance, mean over sides,
    * w / the same sum, w = the anchor's target-score sum.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.model import REG_MAX, Reference

GAINS = dict(box=7.5, cls=0.5, dfl=1.5)
TOPK, ALPHA, BETA, EPS = 10, 0.5, 6, 1e-9
WEIGHT_DECAY, MAX_NORM = 5e-4, 10.0
EMA_DECAY, EMA_TAU = 0.9999, 2000.0


def ciou(b1, b2, eps: float = 1e-7):
    """Complete IoU of broadcastable xyxy boxes (the aspect weight detached)."""
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1] + eps
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1] + eps
    inter = ((torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0])).clamp(min=0)
             * (torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1])).clamp(min=0))
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2[..., 0] + b2[..., 2] - b1[..., 0] - b1[..., 2]) ** 2
            + (b2[..., 1] + b2[..., 3] - b1[..., 1] - b1[..., 3]) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


def anchors(shapes, strides, device):
    pts, st = [], []
    for (h, w), s in zip(shapes, strides):
        gy, gx = torch.meshgrid(torch.arange(h, device=device) + 0.5,
                                torch.arange(w, device=device) + 0.5, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        st.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(pts).float(), torch.cat(st).float()


@torch.no_grad()
def assign(scores, boxes, pts, labels, gts, valid, nc):
    """scores (B, A, C) sigmoid, boxes (B, A, 4) and pts (A, 2) in pixels, labels
    (B, M), gts (B, M, 4) xyxy pixels, valid (B, M) -> (target boxes (B, A, 4),
    target scores (B, A, C), fg (B, A))."""
    b, m = labels.shape
    labels = labels.long().clamp(0, nc - 1)
    s = scores.transpose(1, 2).gather(1, labels[:, :, None].expand(b, m, scores.shape[1]))
    ov = ciou(gts[:, :, None, :], boxes[:, None, :, :]).clamp(min=0)
    align = s.sqrt() * ov ** BETA
    inside = torch.cat([pts[None, None] - gts[:, :, None, :2], gts[:, :, None, 2:] - pts[None, None]],
                       -1).amin(-1) > EPS
    metric = align * inside
    top = torch.sort(metric, dim=-1, descending=True, stable=True).indices[..., :TOPK]
    pos = torch.zeros_like(metric).scatter_(-1, top, 1.0) * inside * valid[:, :, None]
    multi = pos.sum(1, keepdim=True) > 1
    best = torch.zeros_like(pos).scatter_(1, ov.argmax(1, keepdim=True), 1.0)
    pos = torch.where(multi, best, pos)
    gt_idx = pos.argmax(1)
    fg = pos.sum(1) > 0
    t_labels = labels.gather(1, gt_idx)
    t_boxes = gts.gather(1, gt_idx[..., None].expand(*gt_idx.shape, 4))
    pa = (align * pos).amax(-1)
    po = (ov * pos).amax(-1)
    norm = (align * pos * po[:, :, None] / (pa[:, :, None] + EPS)).amax(1)
    t_scores = F.one_hot(t_labels, nc).float() * fg[..., None] * norm[..., None]
    return t_boxes, t_scores, fg


def detection_loss(maps: List[torch.Tensor], batch: Dict[str, torch.Tensor], nc: int,
                   strides: Sequence[float]):
    """(optimisation loss, total of the three weighted terms) of one task's batch."""
    b = maps[0].shape[0]
    dev = maps[0].device
    shapes = [tuple(f.shape[2:]) for f in maps]
    pts, st = anchors(shapes, strides, dev)
    flat = torch.cat([f.reshape(b, f.shape[1], -1) for f in maps], 2).transpose(1, 2).float()
    distri, logits = flat[..., :4 * REG_MAX], flat[..., 4 * REG_MAX:]
    prob = torch.softmax(distri.reshape(b, -1, 4, REG_MAX), -1)
    dist = prob @ torch.arange(REG_MAX, device=dev, dtype=torch.float32)
    pred = torch.cat([pts - dist[..., :2], pts + dist[..., 2:]], -1)  # feature units
    img_h, img_w = shapes[0][0] * strides[0], shapes[0][1] * strides[0]
    scale = torch.tensor([img_w, img_h, img_w, img_h], device=dev, dtype=torch.float32)
    xywh = batch["bboxes"].float() * scale
    gts = torch.cat([xywh[..., :2] - xywh[..., 2:] / 2, xywh[..., :2] + xywh[..., 2:] / 2], -1)
    valid = batch["mask"].bool()
    gts = torch.where(valid[..., None], gts, 0.0)
    t_boxes, t_scores, fg = assign(torch.sigmoid(logits.detach()), pred.detach() * st, pts * st,
                                   batch["cls"], gts, valid, nc)
    tss = t_scores.sum().clamp(min=1.0)
    cls = F.binary_cross_entropy_with_logits(logits, t_scores, reduction="sum") / tss
    w = t_scores.sum(-1) * fg
    tb = t_boxes / st
    box = ((1.0 - ciou(pred, tb)) * w).sum() / tss
    ltrb = torch.cat([pts - tb[..., :2], tb[..., 2:] - pts], -1).clamp(0, REG_MAX - 1 - 0.01)
    left = ltrb.floor().long()
    wl = (left + 1).float() - ltrb
    logp = F.log_softmax(distri.reshape(b, -1, 4, REG_MAX), -1)
    pick = lambda i: logp.gather(-1, i.clamp(0, REG_MAX - 1)[..., None])[..., 0]
    dfl = (-(pick(left) * wl + pick(left + 1) * (1 - wl))).mean(-1)
    dfl = (dfl * w).sum() / tss
    total = GAINS["box"] * box + GAINS["cls"] * cls + GAINS["dfl"] * dfl
    return 2.0 * total * b, total.detach()


def param_group(name: str) -> int:
    leaf = name.rsplit(".", 1)[-1]
    return 2 if leaf in ("b", "bias") else 1 if leaf == "weight" else 0


class TrainReference:
    """Steps float32 copies of the weights as the description above says;
    `conv_cast` (a control) rounds every conv's input and weight."""

    def __init__(self, cfg: dict, tasks, ncs, weights: Dict[str, torch.Tensor], conv_cast=None):
        self.tasks, self.ncs = list(tasks), list(ncs)
        self.params = {k: v.detach().float().clone() for k, v in weights.items()
                       if not k.endswith(("running_mean", "running_var"))}
        for p in self.params.values():
            p.requires_grad_(True)
        self.ref = Reference(cfg, tasks, ncs, self.params, torch.float32)
        self.ref.training = True
        self.ref.running = {k: v.detach().float().clone() for k, v in weights.items()
                            if k.endswith(("running_mean", "running_var"))}
        self.ref.conv_cast = conv_cast
        self.buf = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.ema = {k: v.detach().float().clone() for k, v in weights.items()}
        self.n = 0
        uids = self.ref.uids
        serves: Dict[str, int] = {}
        for t in self.tasks:
            for u in set(uids[t]):
                serves[u] = serves.get(u, 0) + 1
        self.scale = {k: 1.0 / serves.get(k.split(".")[1], 1) for k in self.params}

    def step(self, batches: Dict[str, Dict[str, torch.Tensor]], lrs, momentum) -> Dict[str, float]:
        """One step; returns {task: total loss}."""
        for p in self.params.values():
            p.grad = None
        totals = {}
        for t, nc in zip(self.tasks, self.ncs):
            img = batches[t]["img"]
            x = (img.float() / 255.0 if img.dtype == torch.uint8 else img.float()).permute(0, 3, 1, 2)
            maps = self.ref.features(x, tasks=[t])[t]
            if self.ref.conv_cast is not None:
                maps = [self.ref.conv_cast(m) for m in maps]
            loss, totals[t] = detection_loss(maps, batches[t], nc, self.ref.strides)
            loss.backward()
            del maps, loss
        with torch.no_grad():
            grads = {k: p.grad * self.scale[k] if p.grad is not None else torch.zeros_like(p)
                     for k, p in self.params.items()}
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
            c = (MAX_NORM / (norm + 1e-6)).clamp(max=1.0)
            for k, p in self.params.items():
                g = grads[k] * c
                if param_group(k) == 0:
                    g = g + WEIGHT_DECAY * p
                self.buf[k].mul_(momentum).add_(g)
                p.sub_(lrs[param_group(k)] * (g + momentum * self.buf[k]))
            self.n += 1
            d = EMA_DECAY * (1.0 - math.exp(-self.n / EMA_TAU))
            for k, e in self.ema.items():
                e.mul_(d).add_((1.0 - d) * (self.params[k] if k in self.params
                                            else self.ref.running[k]))
        return {t: float(v) for t, v in totals.items()}


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to a float8 format with a per-tensor scale to its largest value."""
    s = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / s).to(dtype).float() * s


class Fp8(torch.autograd.Function):
    """The control's arithmetic where the program computes in bfloat16: a value
    rounded to float8 e4m3, its gradient to e5m2 (per-tensor scales)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    return Fp8.apply(x)
