"""Validation loop: per-task mAP evaluation and speed accounting.

Counterpart of cerberusdet_tpu/evaluation/val.py:31-280 (the reference's
cerberusdet/val.py:132-433): per-task loaders, a forward of the task's
branch + NMS on the device (conf 0.001, IoU 0.6, multi-label, max_det 300
by default), boxes scaled back to each image's native space, 10-IoU
matching, DetMetrics, the confusion matrix and fitness. Matching and AP stay
on the host in numpy (evaluation/metrics.py), as there. The forward runs
eagerly, one call per batch; the NMS launches its CUDA kernel for a model on
the card (ops/nms.py).

`plots` accumulates the confusion matrix, and `plots_dir` draws the label
and prediction mosaics of batches 0-2 there (utils/plots.py, as the JAX
package's val.py:174-181); save_val_plots draws a task's PR curve and
confusion matrix. Not yet ported: the merge of statistics across processes
(distributed=True, with data parallelism, ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from cerberusdet_tpu_torch.evaluation.metrics import (
    IOUV,
    ConfusionMatrix,
    DetMetrics,
    fitness,
    process_batch,
)
from cerberusdet_tpu_torch.nn.layers import Conv
from cerberusdet_tpu_torch.ops.boxes import scale_boxes_np
from cerberusdet_tpu_torch.ops.nms import non_max_suppression

__all__ = ["scale_boxes_np", "run_task", "run", "eval_flags", "save_val_plots"]


def eval_flags():
    """cuDNN settings of a val: float32 is float32 arithmetic (no TF32), and
    no autotuning, so that a new rect shape costs no search."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                      allow_tf32=False)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def run_task(
    model,
    task: str,
    loader,
    nc: int,
    names: Sequence[str] = (),
    conf_thres: float = 0.001,
    iou_thres: float = 0.6,
    max_det: int = 300,
    max_nms: int = 30000,
    compute_loss=None,
    verbose: bool = False,
    plots: bool = False,
    single_cls: bool = False,
    use_multi_labels: bool = False,
    plots_dir=None,
    distributed: bool = False,
    use_kernel: Optional[bool] = None,
    return_dets: bool = False,
) -> Dict[str, Any]:
    """Evaluate one task of `model` (the port's CerberusModel, with its
    weights, on its device) over `loader`'s batches. Returns a dict with
    results (mp, mr, map50, map, box_l, cls_l, dfl_l), per-class maps,
    speed (preprocess, inference, NMS in ms per image, host clock around
    device work that ends in a synchronise), fitness, the DetMetrics and
    ConfusionMatrix, seen, and `times`: per batch (its (H, W), then the
    three stages in seconds), so that a shape's first batch can be told
    apart.

    `nc` is the MODEL's class count of the task; under single_cls the
    metrics collapse to one class while NMS still sees the real class
    scores, agnostically (val.py:197,318,339). The batch is cast to
    the dtype of the model's parameters (a fused model computes in its own
    dtype). The model runs in eval mode and gets its mode back.
    `compute_loss(feats, batch)` (train/loss.py:DetectionLoss) adds the
    mean box, cls and dfl losses. use_kernel=False runs the plain NMS loop
    and the plain int8 convs instead of their kernels (a comparison hook,
    as in infer/inference.py; with max_nms=MAX_K the plain loop sees the
    kernel's 16384 candidates). return_dets adds `dets`: {image path: (n, 6) float32 [x1, y1, x2, y2, conf, cls] in the
    image's native pixels}."""
    if distributed:
        raise NotImplementedError("distributed val merges statistics across processes; it "
                                  "comes with data parallelism (ROADMAP.md queue 1, item 6)")
    ref = next(model.parameters())
    device, dtype = ref.device, ref.dtype
    metric_nc = 1 if single_cls else nc
    metric_names = ["item"] if single_cls else names
    metrics = DetMetrics(metric_nc, metric_names)
    confusion = ConfusionMatrix(metric_nc)
    loss_accum = np.zeros(3)
    n_batches = 0
    seen = 0
    dt = np.zeros(3)  # preprocess, inference, nms (seconds)
    times, dets_out = [], {}

    int8_convs = [m for m in model.modules() if isinstance(m, Conv) and m.int8]
    was_training = model.training
    model.eval()
    for m in int8_convs:
        m.use_kernel = use_kernel
    try:
        for batch_i, batch in enumerate(loader):
            t0 = time.perf_counter()
            img = torch.from_numpy(batch["img"]).to(device)
            x = (img.permute(0, 3, 1, 2).float() / 255.0).to(dtype)
            _sync(device)
            t1 = time.perf_counter()
            pred, feats = model(x, tasks=[task])[task]
            _sync(device)
            t2 = time.perf_counter()
            dets, counts = non_max_suppression(
                pred, nc=nc, conf_thres=conf_thres, iou_thres=iou_thres, multi_label=True,
                max_det=max_det, max_nms=max_nms, agnostic=single_cls, use_kernel=use_kernel)
            dets, counts = dets.cpu().numpy(), counts.cpu().numpy()
            t3 = time.perf_counter()
            dt += (t1 - t0, t2 - t1, t3 - t2)
            h, w = batch["img"].shape[1:3]
            times.append(((h, w), t1 - t0, t2 - t1, t3 - t2))

            if plots_dir is not None and batch_i < 3:
                # the first batches' label and prediction mosaics (val.py:73-83)
                from cerberusdet_tpu_torch.utils.plots import plot_images, plot_val_images

                shown = {**batch, "img": img.permute(0, 3, 1, 2)}
                plot_images(shown, f"{plots_dir}/val_batch{batch_i}_labels_{task}.jpg",
                            names=metric_names)
                plot_val_images(shown, dets, counts,
                                f"{plots_dir}/val_batch{batch_i}_pred_{task}.jpg",
                                names=metric_names)

            if compute_loss is not None:
                tensors = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
                           if k not in ("img", "meta")}
                _, items = compute_loss(feats, tensors)
                loss_accum += np.array([float(items.box), float(items.cls), float(items.dfl)])
                n_batches += 1

            for si in range(len(batch["img"])):
                seen += 1
                meta = batch["meta"][si]
                gt_mask = batch["mask"][si]
                gt_cls = batch["cls"][si][gt_mask].astype(np.float32)
                gt_xywhn = batch["bboxes"][si][gt_mask]
                if single_cls and use_multi_labels and len(gt_xywhn):
                    # multi-label GTs collapse to one class: keep each box once so
                    # it is not counted several times (val.py:285-290)
                    _, uniq = np.unique(gt_xywhn, axis=0, return_index=True)
                    uniq = np.sort(uniq)
                    gt_cls, gt_xywhn = gt_cls[uniq], gt_xywhn[uniq]
                n_det = int(counts[si])
                det = dets[si][:n_det].copy()
                if single_cls and n_det:
                    det[:, 5] = 0  # predictions are classless (val.py:339-340)

                ori_shape = meta["ori_shape"]
                ratio_pad = meta["shapes"][1] if meta.get("shapes") else None
                # labels -> letterbox pixels -> native space
                if len(gt_xywhn):
                    tbox = np.empty((len(gt_xywhn), 4), np.float32)
                    tbox[:, 0] = (gt_xywhn[:, 0] - gt_xywhn[:, 2] / 2) * w
                    tbox[:, 1] = (gt_xywhn[:, 1] - gt_xywhn[:, 3] / 2) * h
                    tbox[:, 2] = (gt_xywhn[:, 0] + gt_xywhn[:, 2] / 2) * w
                    tbox[:, 3] = (gt_xywhn[:, 1] + gt_xywhn[:, 3] / 2) * h
                    tbox = scale_boxes_np((h, w), tbox, ori_shape, ratio_pad)
                    labels_n = np.concatenate([gt_cls[:, None], tbox], 1)
                else:
                    labels_n = np.zeros((0, 5), np.float32)
                if n_det:
                    det[:, :4] = scale_boxes_np((h, w), det[:, :4], ori_shape, ratio_pad)
                if return_dets:
                    dets_out[meta["path"]] = det

                correct = process_batch(det, labels_n, IOUV)
                metrics.update(correct, det[:, 4], det[:, 5], labels_n[:, 0])
                if plots:
                    confusion.process_batch(det, labels_n)
    finally:
        for m in int8_convs:
            m.use_kernel = None
        model.train(was_training)

    metrics.process()
    mp, mr, map50, mAP = metrics.mean_results()
    losses = loss_accum / max(n_batches, 1)
    results = (mp, mr, map50, mAP, *losses)
    speed = tuple(x / seen * 1e3 for x in dt) if seen else (0.0, 0.0, 0.0)
    out = {
        "results": results,
        "maps": metrics.maps,
        "speed": speed,
        "fitness": float(fitness(np.array(results).reshape(1, -1))[0]),
        "metrics": metrics,
        "confusion": confusion,
        "seen": seen,
        "times": times,
    }
    if return_dets:
        out["dets"] = dets_out
    if verbose:
        print(f"[{task}] images={seen} P={mp:.3f} R={mr:.3f} "
              f"mAP50={map50:.3f} mAP={mAP:.3f} speed(ms/img)={speed}")
        # per-class table (val.py:96-105 parity)
        nt = metrics.nt_per_class()
        for i, c in enumerate(metrics.ap_class_index):
            name = metric_names[c] if c < len(metric_names) else str(c)
            p_c, r_c, ap50_c, ap_c = metrics.class_result(i)
            print(f"  {name:>20s} {int(nt[c]):6d}  P={p_c:.3f} R={r_c:.3f} "
                  f"mAP50={ap50_c:.3f} mAP={ap_c:.3f}")
    return out


def save_val_plots(out: Dict[str, Any], names: Sequence[str], save_dir, task: str) -> None:
    """A task's PR curve and confusion matrix from run_task's output (the
    JAX package's trainer _save_val_plots and val.py:203-218); `names` are
    the metrics' classes (["item"] under single_cls). The curves' rows are
    the classes present, in ap_per_class's order."""
    from cerberusdet_tpu_torch.utils.plots import plot_confusion_matrix, plot_pr_curve

    save_dir = Path(save_dir)
    m = out["metrics"]
    if getattr(m, "_results", None):
        _, _, p, r, f1, ap, classes, p_curve, r_curve, px = m._results
        plot_pr_curve(px, p_curve, ap, save_dir / f"{task}_PR_curve.png",
                      [names[int(c)] for c in classes])
    plot_confusion_matrix(out["confusion"].matrix, names,
                          save_dir / f"{task}_confusion_matrix.png")


def run(
    model,
    loaders: Dict[str, Any],
    nc_per_task: Dict[str, int],
    names_per_task: Optional[Dict[str, Sequence[str]]] = None,
    losses: Optional[Dict[str, Any]] = None,
    **kw,
) -> Dict[str, Dict[str, Any]]:
    """Evaluate all tasks; returns {task: run_task's output}."""
    out = {}
    for task, loader in loaders.items():
        out[task] = run_task(
            model, task, loader, nc_per_task[task],
            names=(names_per_task or {}).get(task, ()),
            compute_loss=(losses or {}).get(task),
            **kw,
        )
    return out
