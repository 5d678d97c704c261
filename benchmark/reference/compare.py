"""The comparison that decides `correct` for served detections.

Each served image's detection list (what the program returned: box in frame
pixels, score, global label) is held against the reference's list for the
same frame. Detections of one label pair up one to one, the pairs of
highest IoU first, where IoU > MATCH_IOU (the NMS threshold: a box that NMS
kept in place of a near-tied neighbour overlaps it at least that much) or
no coordinate differs by more than BOX_TOL pixels (a thin box cut by the
frame's edge changes its IoU a lot when it moves a little).
A detection scored at least CONFIDENT on either side must find a partner;
those that do not are counted, unless their presence was a near decision on
their own side: a higher-scored detection of the same side overlaps them
within MARGIN of a suppression threshold, on either side of it (the same
label in (MATCH_IOU - MARGIN, MATCH_IOU + MARGIN], or another task in
(BETWEEN_IOU - MARGIN, BETWEEN_IOU + MARGIN]), so that a box moved by
rounding decides whether NMS or the suppression between tasks keeps them.
A box that NMS or the suppression would have removed outright, overlapping
its better neighbour by more than the threshold plus MARGIN, is not excused:
a program that skips either step is counted for it. Below CONFIDENT a
detection may come or go with rounding: its score lies near the threshold,
where a lower precision moves it across.

unmatched_share: over every compared image, the larger of two shares: the
reference's confident detections that the program's answers lack, and the
program's confident detections that the reference lacks.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from benchmark.reference.detect import iou_matrix

MATCH_IOU = 0.45      # the serving cells' NMS threshold
BETWEEN_IOU = 0.8     # their threshold between tasks
MARGIN = 0.1
BOX_TOL = 16.0        # pixels of the frame: a stride-16 cell
CONFIDENT = 0.5


def as_arrays(dets: List[dict]):
    """A served list of {box, score, label, ...} -> (boxes (K, 4), scores, labels)."""
    if not dets:
        return np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64)
    return (np.array([d["box"] for d in dets], np.float64),
            np.array([d["score"] for d in dets], np.float64),
            np.array([d["label"] for d in dets], np.int64))


def near_decision(boxes, scores, labels, task_of) -> np.ndarray:
    """Per detection: a higher-scored detection of the same list overlaps it
    within MARGIN of a suppression threshold, on either side."""
    if len(scores) < 2:
        return np.zeros(len(scores), bool)
    iou = iou_matrix(boxes, boxes)
    tasks = task_of(labels)
    higher = scores[None, :] > scores[:, None]
    near = lambda thr: (iou > thr - MARGIN) & (iou <= thr + MARGIN)
    same = (labels[:, None] == labels[None, :]) & near(MATCH_IOU)
    other = (tasks[:, None] != tasks[None, :]) & near(BETWEEN_IOU)
    return (higher & (same | other)).any(1)


def unmatched(prog, ref, task_of) -> np.ndarray:
    """(unpaired, confident) detections of the program and of the reference
    in one image, as [lone_prog, confident_prog, lone_ref, confident_ref]:
    prog and ref are (boxes, scores, labels); task_of maps labels to tasks."""
    pb, ps, pl = prog
    rb, rs, rl = ref
    paired_p = np.zeros(len(ps), bool)
    paired_r = np.zeros(len(rs), bool)
    if len(ps) and len(rs):
        iou = iou_matrix(pb, rb)
        near = np.abs(pb[:, None, :] - rb[None, :, :]).max(-1) <= BOX_TOL
        iou = np.where(near, np.maximum(iou, MATCH_IOU + 1e-6), iou)
        iou[pl[:, None] != rl[None, :]] = 0.0
        ii, jj = np.nonzero(iou > MATCH_IOU)
        for k in np.argsort(-iou[ii, jj], kind="stable"):
            i, j = ii[k], jj[k]
            if not paired_p[i] and not paired_r[j]:
                paired_p[i] = paired_r[j] = True
    lone_p = (ps >= CONFIDENT) & ~paired_p
    lone_r = (rs >= CONFIDENT) & ~paired_r
    if lone_p.any():
        lone_p &= ~near_decision(pb, ps, pl, task_of)
    if lone_r.any():
        lone_r &= ~near_decision(rb, rs, rl, task_of)
    return np.array([lone_p.sum(), (ps >= CONFIDENT).sum(), lone_r.sum(), (rs >= CONFIDENT).sum()],
                    np.int64)


def share(counts: np.ndarray) -> float:
    """unmatched_share of summed `unmatched` counts (1 when nothing is confident)."""
    lp, cp, lr, cr = (int(c) for c in counts)
    if cp + cr == 0:
        return 1.0
    return max(lp / cp if cp else 0.0, lr / cr if cr else 1.0)


def tasks_of(ncs) -> "callable":
    """labels -> task index, for global labels numbered task after task."""
    edges = np.cumsum(ncs)[:-1]
    return lambda labels: np.searchsorted(edges, labels, side="right")


def unmatched_share(pairs: Iterable[Tuple[tuple, tuple]], ncs) -> Tuple[float, int]:
    """(unmatched_share, confident detections of the reference) over (prog,
    ref) pairs of images."""
    task_of = tasks_of(ncs)
    counts = sum((unmatched(prog, ref, task_of) for prog, ref in pairs), np.zeros(4, np.int64))
    return share(counts), int(counts[3])
