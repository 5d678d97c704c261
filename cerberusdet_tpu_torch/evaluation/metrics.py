"""mAP machinery (host-side numpy: exactness over speed).

A copy of cerberusdet_tpu/evaluation/metrics.py, kept so that the port
imports nothing of the JAX package. Its behaviour follows the reference:
cerberusdet/utils/metrics.py:28-370 (fitness, overall_fitness, smooth,
ap_per_class with 101-point COCO interpolation, DetMetrics, ConfusionMatrix)
and cerberusdet/val.py:32-54 (process_batch matching at 10 IoU thresholds).
The matching order and interpolation match the reference bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOUV = np.linspace(0.5, 0.95, 10)


def fitness(x: np.ndarray) -> np.ndarray:
    """0.1 * mAP@0.5 + 0.9 * mAP@0.5:0.95 over rows [P, R, mAP50, mAP]."""
    if not isinstance(x, np.ndarray):
        x = np.array(x).reshape(1, -1)
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return (x[:, :4] * w).sum(1)


def overall_fitness(results_per_task: Dict[str, tuple]) -> float:
    """Mean fitness across tasks (metrics.py:37-45)."""
    vals = [float(fitness(np.array(r).reshape(1, -1))[0]) for r in results_per_task.values()]
    return float(np.mean(vals)) if vals else 0.0


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point COCO-interpolated AP (metrics.py:123-148)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray, eps: float = 1e-16):
    """Per-class P/R/AP from accumulated predictions (metrics.py:56-120).

    tp: (n, 10) bool/int correctness at the 10 IoU thresholds.
    Returns (tp, fp, p, r, f1, ap (nc, 10), unique_classes, p_curve, r_curve,
    px) — curves at 1000 conf points for plotting.
    """
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        m = pred_cls == c
        n_l = nt[ci]
        n_p = int(m.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[m]).cumsum(0)
        tpc = tp[m].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-px, -conf[m], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-px, -conf[m], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax()
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_out = (r * nt).round()
    fp_out = (tp_out / (p + eps) - tp_out).round()
    return tp_out, fp_out, p, r, f1, ap, unique_classes.astype(int), p_curve, r_curve, px


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy pairwise IoU, numpy."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:4]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:4]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(2)
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def process_batch(detections: np.ndarray, labels: np.ndarray,
                  iouv: np.ndarray = IOUV) -> np.ndarray:
    """Correctness matrix (n_det, 10) for one image (val.py:32-54 semantics:
    greedy by IoU, unique per detection then per label)."""
    correct = np.zeros((detections.shape[0], iouv.shape[0]), bool)
    if len(labels) == 0 or len(detections) == 0:
        return correct
    iou = box_iou_np(labels[:, 1:5], detections[:, :4])
    correct_class = labels[:, 0:1] == detections[None, :, 5]
    for i in range(len(iouv)):
        li, di = np.where((iou >= iouv[i]) & correct_class)
        if len(li):
            matches = np.stack([li, di, iou[li, di]], 1)
            if len(li) > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


class DetMetrics:
    """Accumulates (tp, conf, pred_cls, target_cls) stats and produces the
    headline metrics (metrics.py:151-270)."""

    def __init__(self, nc: int, names: Sequence[str] = ()):
        self.nc = nc
        self.names = list(names)
        self.stats: List[Tuple[np.ndarray, ...]] = []
        self._results = None

    def update(self, tp, conf, pred_cls, target_cls):
        self.stats.append((np.asarray(tp), np.asarray(conf), np.asarray(pred_cls),
                           np.asarray(target_cls)))

    def process(self):
        if not self.stats:
            self._results = None
            return self
        tp, conf, pred_cls, target_cls = [np.concatenate(x, 0) for x in zip(*self.stats)]
        if len(tp) == 0 or len(target_cls) == 0:
            self._results = None
            return self
        out = ap_per_class(tp, conf, pred_cls, target_cls)
        self._results = out
        return self

    @property
    def ap_class_index(self):
        return self._results[6] if self._results else np.array([], int)

    def class_result(self, i: int):
        """(p, r, ap50, ap) for the i-th present class."""
        _, _, p, r, _, ap, *_ = self._results
        return p[i], r[i], ap[i, 0], ap[i].mean()

    def mean_results(self):
        """(mp, mr, map50, map)."""
        if not self._results:
            return 0.0, 0.0, 0.0, 0.0
        _, _, p, r, _, ap, *_ = self._results
        return float(p.mean()), float(r.mean()), float(ap[:, 0].mean()), float(ap.mean())

    @property
    def maps(self) -> np.ndarray:
        """Per-class mAP@0.5:0.95 over ALL nc classes (absent -> overall map)."""
        maps = np.full(self.nc, self.mean_results()[3])
        if self._results:
            ap = self._results[5]
            for i, c in enumerate(self.ap_class_index):
                maps[int(c)] = ap[i].mean()
        return maps

    def nt_per_class(self) -> np.ndarray:
        if not self.stats:
            return np.zeros(self.nc, int)
        target_cls = np.concatenate([s[3] for s in self.stats], 0)
        return np.bincount(target_cls.astype(int), minlength=self.nc)


class ConfusionMatrix:
    """Detection confusion matrix with a background row/col
    (metrics.py:273-370)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        """detections (n, 6) xyxy+conf+cls; labels (m, 5) cls+xyxy."""
        if detections is None or len(detections) == 0:
            for gc in labels[:, 0].astype(int) if len(labels) else []:
                self.matrix[self.nc, gc] += 1  # background FN
            return
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int) if len(labels) else np.array([], int)
        det_classes = detections[:, 5].astype(int)
        if len(labels):
            iou = box_iou_np(labels[:, 1:5], detections[:, :4])
            li, di = np.where(iou > self.iou_thres)
            if len(li):
                matches = np.stack([li, di, iou[li, di]], 1)
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            else:
                matches = np.zeros((0, 3))
        else:
            matches = np.zeros((0, 3))

        n = len(matches) > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j]][0], gc] += 1  # correct/confused
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        if n:
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # background FP

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]
