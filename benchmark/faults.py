"""Faults planted under the timed path, to see the comparison fail: the
CPU tests drive whole runs with them, and the readings tool reads them on
the chip (the training cell's upper readings).

  half      half of each batch left out: serving answers the first half of a
            batch's rows and leaves the rest empty; training steps the
            program on the first half of each task's rows, the mean taken
            over them
  altered   serving: every answer altered where it is produced, each box
            moved right by its own width
  no_nms    serving: per-task NMS skipped (its IoU threshold raised to 1, which
            no overlap exceeds: every candidate kept, up to max_det)
  no_cross_task  serving: the suppression between tasks skipped (its
            threshold raised to 1)
  unchanged training: a step that leaves the state as it was (every leaf's
            change then reads 1 by the change's measure)
  ema_unchanged  training: the step updates everything but the EMA, which
            stays as it was (its change then reads 1)

Serving faults are planted in a built session (`plant`); a training session
takes its fault when it is built (drivers/train.py Session(fault=)), since
its checked steps run in its set-up.
"""

from __future__ import annotations


def plant(session, fault: str) -> None:
    """Break `session`'s timed path with `fault`, in place."""
    if hasattr(session, "inference"):  # a serving session
        inf = session.inference
        if fault in ("no_nms", "no_cross_task"):  # read by predict at each call
            setattr(inf, "iou_thres" if fault == "no_nms" else "iou_thres_between_tasks", 1.0)
            return
        predict = inf.predict

        def broken(batch, **kw):
            out = predict(batch, **kw)
            if fault == "half":
                return out[:len(out) // 2] + [[] for _ in out[len(out) // 2:]]
            if fault == "altered":
                for dets in out:
                    for d in dets:
                        x1, y1, x2, y2 = d["box"]
                        d["box"] = [x2, y1, x2 + (x2 - x1), y2]
                return out
            raise ValueError(f"serving has no fault {fault!r}")

        inf.predict = broken
        return
    raise ValueError(f"a training session takes its fault when it is built (Session(..., "
                     f"fault={fault!r})): its checked steps run in set-up")
