"""Plot artifacts saved to the run directory.

Counterpart of cerberusdet_tpu/utils/plots.py (the reference's
cerberusdet/utils/plots.py:222-481 and utils/metrics.py:472-509), drawing the
same pixels from the same data:

  * the mosaics, plot_images (a batch with its labels) and plot_val_images
    (a batch with its detections), need only cv2 and infer/visualizer.py and
    are drawn everywhere. They take the port's layout: batch["img"] an NCHW
    tensor (uint8, or float in [0, 1]) on any device, of which at most
    `max_images` images are copied to the host; labels and detections as
    numpy arrays or tensors;
  * the figures (plot_labels, plot_pr_curve, plot_mc_curve,
    plot_lr_scheduler, plot_confusion_matrix, feature_visualization) need
    matplotlib, imported inside each function. Where it is not installed
    the figure is not drawn, and the first skip of each file name is said
    on stderr (`SKIPPED` lists them).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cerberusdet_tpu_torch.infer.visualizer import CerberusVisualizer, colors

SKIPPED: set = set()  # figure file names not drawn for want of matplotlib


def pyplot(figure: str):
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is
    not installed (the first miss of each `figure` name is said on stderr)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        if figure not in SKIPPED:
            SKIPPED.add(figure)
            print(f"plots: matplotlib is not installed; {figure} is not drawn",
                  file=sys.stderr)
        return None
    return plt


def _host(v) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _host_images(img, max_images: int) -> np.ndarray:
    """The first max_images images of an NCHW tensor as (B, H, W, 3) uint8
    on the host: only those images are copied; a float batch in [0, 1] is
    scaled by 255 and truncated, as the JAX package does."""
    x = img[:max_images].detach()
    if x.dtype != torch.uint8:
        x = x.float()
    imgs = x.permute(0, 2, 3, 1).cpu().numpy()
    if imgs.dtype != np.uint8:
        imgs = (imgs * 255).astype(np.uint8)
    return imgs


def _write_mosaic(tiles: np.ndarray, draw, fname, max_size: int) -> None:
    """Tile the images on a square grid, draw on each with draw(i, tile),
    shrink to max_size and write RGB as BGR."""
    import cv2

    b, h, w, _ = tiles.shape
    ns = int(np.ceil(b ** 0.5))
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(b):
        r, c = divmod(i, ns)
        tile = tiles[i].copy()
        draw(i, tile)
        mosaic[r * h:(r + 1) * h, c * w:(c + 1) * w] = tile
    scale = min(1.0, max_size / (ns * max(h, w)))
    if scale < 1:
        mosaic = cv2.resize(mosaic, None, fx=scale, fy=scale)
    cv2.imwrite(str(fname), mosaic[..., ::-1])  # RGB -> BGR for imwrite


def plot_images(batch: Dict, fname, names: Optional[Sequence[str]] = None,
                max_images: int = 16, max_size: int = 1920) -> None:
    """Grid of images with their labels (plots.py:222-333): batch["img"]
    NCHW, batch["bboxes"] (B, M, 4) xywhn, "cls" (B, M), "mask" (B, M)."""
    imgs = _host_images(batch["img"], max_images)
    n = len(imgs)
    masks, boxes_all, cls_all = (_host(batch[k][:n]) for k in ("mask", "bboxes", "cls"))
    h, w = imgs.shape[1:3]
    vis = CerberusVisualizer(line_thickness=2, text_scale=0.4)

    def draw(i, tile):
        for bx, cl in zip(boxes_all[i][masks[i]], cls_all[i][masks[i]]):
            x1 = (bx[0] - bx[2] / 2) * w
            y1 = (bx[1] - bx[3] / 2) * h
            x2 = (bx[0] + bx[2] / 2) * w
            y2 = (bx[1] + bx[3] / 2) * h
            label = names[int(cl)] if names else str(int(cl))
            vis.draw_box(tile, (x1, y1, x2, y2), label, colors(int(cl), bgr=True))

    _write_mosaic(imgs, draw, fname, max_size)


def plot_val_images(batch: Dict, dets, counts, fname, names: Optional[Sequence[str]] = None,
                    conf_thres: float = 0.25, max_images: int = 16,
                    max_size: int = 1920) -> None:
    """Grid of images with their PREDICTED boxes (val.py:73-83): dets (B,
    max_det, 6) [x1, y1, x2, y2, conf, cls] in the batch's pixels, counts
    (B,), from ops/nms.py:non_max_suppression."""
    imgs = _host_images(batch["img"], max_images)
    n = len(imgs)
    dets, counts = _host(dets[:n]), _host(counts[:n])
    vis = CerberusVisualizer(line_thickness=2, text_scale=0.4)

    def draw(i, tile):
        for det in dets[i][: int(counts[i])]:
            if det[4] < conf_thres:
                continue
            cl = int(det[5])
            label = names[cl] if names and cl < len(names) else str(cl)
            vis.draw_box(tile, det[:4], f"{label} {det[4]:.2f}", colors(cl, bgr=True))

    _write_mosaic(imgs, draw, fname, max_size)


def plot_labels(labels: List[np.ndarray], names: Sequence[str], save_dir) -> None:
    """Class histogram and box-geometry scatter (plots.py:353-406): labels
    per image (n, 6) [cls, prob, x, y, w, h]."""
    rows = np.concatenate([l for l in labels if len(l)], 0) if labels else np.zeros((0, 6))
    if not len(rows):
        return
    plt = pyplot("labels.png")
    if plt is None:
        return
    cls = rows[:, 0].astype(int)
    boxes = rows[:, 2:6]
    fig, axes = plt.subplots(1, 3, figsize=(15, 4), tight_layout=True)
    axes[0].hist(cls, bins=np.arange(len(names) + 1) - 0.5, rwidth=0.8)
    axes[0].set_xlabel("class")
    axes[1].scatter(boxes[:, 0], boxes[:, 1], s=3, alpha=0.4)
    axes[1].set_xlabel("x")
    axes[1].set_ylabel("y")
    axes[2].scatter(boxes[:, 2], boxes[:, 3], s=3, alpha=0.4)
    axes[2].set_xlabel("width")
    axes[2].set_ylabel("height")
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    fig.savefig(Path(save_dir) / "labels.png", dpi=150)
    plt.close(fig)


def plot_pr_curve(px, py_per_class, ap, fname, names: Sequence[str] = ()) -> None:
    """PR curves per class and their mean (metrics.py:472-489)."""
    plt = pyplot(Path(fname).name)
    if plt is None:
        return
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py_per_class, axis=1) if isinstance(py_per_class, list) else py_per_class.T
    if 0 < len(names) < 21:
        for i in range(py.shape[1]):
            ax.plot(px, py[:, i], linewidth=1,
                    label=f"{names[i] if i < len(names) else i} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    ax.plot(px, py.mean(1), linewidth=3, color="blue",
            label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left", fontsize=8)
    fig.savefig(fname, dpi=250)
    plt.close(fig)


def plot_mc_curve(px, py, fname, names: Sequence[str] = (), xlabel="Confidence",
                  ylabel="Metric") -> None:
    """Metric-vs-confidence curves (metrics.py:492-509)."""
    plt = pyplot(Path(fname).name)
    if plt is None:
        return
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=f"{names[i] if i < len(names) else i}")
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left", fontsize=8)
    fig.savefig(fname, dpi=250)
    plt.close(fig)


def plot_lr_scheduler(lr_lambda_fn, lr0: float, epochs: int, save_dir) -> None:
    """LR curve over epochs (plots.py:336-350)."""
    plt = pyplot("LR.png")
    if plt is None:
        return
    ys = [lr0 * lr_lambda_fn(e) for e in range(epochs)]
    fig = plt.figure()
    plt.plot(range(epochs), ys, ".-", label="LR")
    plt.xlabel("epoch")
    plt.ylabel("LR")
    plt.savefig(Path(save_dir) / "LR.png", dpi=150)
    plt.close(fig)


def plot_confusion_matrix(matrix: np.ndarray, names: Sequence[str], fname,
                          normalize: bool = True) -> None:
    """Confusion-matrix heatmap without seaborn (the JAX package's)."""
    plt = pyplot(Path(fname).name)
    if plt is None:
        return
    arr = matrix / (matrix.sum(0, keepdims=True) + 1e-9) if normalize else matrix
    fig, ax = plt.subplots(figsize=(10, 8), tight_layout=True)
    im = ax.imshow(arr, cmap="Blues", vmin=0.0)
    fig.colorbar(im)
    ticklabels = list(names) + ["background"]
    if len(ticklabels) == arr.shape[0] and len(ticklabels) < 60:
        ax.set_xticks(range(len(ticklabels)))
        ax.set_yticks(range(len(ticklabels)))
        ax.set_xticklabels(ticklabels, rotation=90, fontsize=7)
        ax.set_yticklabels(ticklabels, fontsize=7)
    if arr.shape[0] < 30:
        for i in range(arr.shape[0]):
            for j in range(arr.shape[1]):
                if arr[i, j] >= 0.005:
                    ax.text(j, i, f"{arr[i, j]:.2f}", ha="center", va="center", fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    ax.set_title("Confusion Matrix")
    fig.savefig(fname, dpi=250)
    plt.close(fig)


def feature_visualization(x, module_name: str, save_dir, n: int = 32) -> None:
    """Per-channel feature-map grid of the first image (plots.py:458-481):
    x an NCHW tensor, of which the first image's first n channels are
    copied to the host."""
    if x.dim() != 4 or x.shape[2] <= 1 or x.shape[3] <= 1:
        return
    name = f"features_{module_name}.png"
    plt = pyplot(name)
    if plt is None:
        return
    channels = min(n, x.shape[1])
    maps = x[0, :channels].detach().float().cpu().numpy()
    cols = 8
    rows = -(-channels // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 1.5, rows * 1.5), tight_layout=True)
    for i, ax in enumerate(np.atleast_1d(axes).ravel()):
        ax.axis("off")
        if i < channels:
            ax.imshow(maps[i], cmap="viridis")
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    fig.savefig(Path(save_dir) / name, dpi=150)
    plt.close(fig)
