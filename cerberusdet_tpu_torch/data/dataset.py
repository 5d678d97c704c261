"""Per-task detection dataset, its evaluation side: file lists, the label
cache, rect batch shapes, the RAM image cache and the letterbox.

Counterpart of cerberusdet_tpu/data/dataset.py (DetectionDataset, after the
reference's LoadImagesAndLabels, cerberusdet/data/datasets.py:171-542), with
the same items bit for bit: HWC RGB uint8 images and (n, 6) [cls, prob, xywhn]
labels, which the loader pads to a fixed count (data/loaders.py).
The training side (augment=True: mosaic, mixup, affine and pixel
augmentation), the native scaled JPEG decoder (fast_decode=True) and the
packed disk cache (cache_images="disk") come with ROADMAP.md queue 1, item 2,
and raise NotImplementedError until then.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cerberusdet_tpu_torch.data.labels import build_label_cache, img2label_paths, list_images
from cerberusdet_tpu_torch.ops.letterbox import letterbox_host

TRAIN_SIDE = "is the data pipeline's training side, not ported yet (ROADMAP.md queue 1, item 2)"


def xywhn2xyxy_np(x, w, h, padw=0.0, padh=0.0):
    y = np.empty_like(x)
    y[:, 0] = w * (x[:, 0] - x[:, 2] / 2) + padw
    y[:, 1] = h * (x[:, 1] - x[:, 3] / 2) + padh
    y[:, 2] = w * (x[:, 0] + x[:, 2] / 2) + padw
    y[:, 3] = h * (x[:, 1] + x[:, 3] / 2) + padh
    return y


def xyxy2xywhn_np(x, w, h, clip=True, eps=1e-3):
    if clip:
        x[:, [0, 2]] = x[:, [0, 2]].clip(0, w - eps)
        x[:, [1, 3]] = x[:, [1, 3]].clip(0, h - eps)
    y = np.empty_like(x)
    y[:, 0] = ((x[:, 0] + x[:, 2]) / 2) / w
    y[:, 1] = ((x[:, 1] + x[:, 3]) / 2) / h
    y[:, 2] = (x[:, 2] - x[:, 0]) / w
    y[:, 3] = (x[:, 3] - x[:, 1]) / h
    return y


class DetectionDataset:
    """One task's dataset. `__getitem__` returns
    (img HWC-RGB uint8, labels (n, 6) [cls, prob, xywhn], meta dict), with
    meta {'path', 'ori_shape' (h0, w0), 'shapes' ((h0, w0), (ratio, pad))}.

    rect=True sorts the images by aspect ratio and letterboxes each batch of
    `batch_size` to one stride-multiple shape, ceil(shape * imgsz / stride +
    pad) * stride (the reference's val protocol uses pad 0.5). cache_images
    True or "ram" keeps decoded images in memory. The arguments are the JAX
    package's eval side; `hyp` and `seed` come with augment=True."""

    def __init__(
        self,
        path,
        imgsz: int = 640,
        augment: bool = False,
        rect: bool = False,
        stride: int = 32,
        pad: float = 0.0,
        batch_size: int = 16,
        use_xml: bool = False,
        classnames: Optional[Sequence[str]] = None,
        multi_label: bool = False,
        soft_label: bool = False,
        cache_images="",  # False/"" | True/"ram"
        task: str = "task",
        cache_dir: Optional[str] = None,
        single_cls: bool = False,
        fast_decode: Optional[bool] = None,
    ):
        cache_mode = {True: "ram", False: ""}.get(cache_images, cache_images or "")
        if augment:
            raise NotImplementedError(f"augment=True {TRAIN_SIDE}")
        if fast_decode:
            raise NotImplementedError(f"fast_decode=True (the native JPEG decoder) {TRAIN_SIDE}")
        if cache_mode == "disk":
            raise NotImplementedError(f'cache_images="disk" (the packed cache) {TRAIN_SIDE}')
        if cache_mode not in ("", "ram"):
            raise ValueError(f"cache_images must be '', 'ram' or True, got {cache_images!r}")
        self.imgsz = imgsz
        self.epoch = 0
        self.augment = augment
        self.rect = rect
        self.stride = stride
        self.pad = pad
        self.task = task

        self.img_files = list_images(path)
        if not self.img_files:
            raise FileNotFoundError(f"no images found in {path}")
        self.label_files = img2label_paths(self.img_files, ".xml" if use_xml else ".txt")
        cache_path = (Path(cache_dir) if cache_dir else Path(self.label_files[0]).parent) / (
            f"{task}.cache.npy")
        cache = build_label_cache(self.img_files, self.label_files, cache_path, use_xml,
                                  classnames, multi_label, soft_label)
        results = cache["results"]
        self.img_files = [f for f in self.img_files if f in results]
        self.labels = [results[f][0] for f in self.img_files]
        self.shapes = np.array([results[f][1] for f in self.img_files], np.float64)  # (w, h)
        if single_cls:  # multi-class data as single-class (datasets.py:258-260)
            for x in self.labels:
                if len(x):
                    x[:, 0] = 0
        self.stats = cache.get("stats", (0, len(self.img_files), 0, 0))
        self.n = len(self.img_files)
        self.indices = np.arange(self.n)

        # rect batches: sort by aspect ratio, one letterbox shape per batch
        self.batch_shapes = None
        if self.rect:
            ar = self.shapes[:, 1] / self.shapes[:, 0]  # h/w
            order = ar.argsort()
            self.img_files = [self.img_files[i] for i in order]
            self.label_files = [self.label_files[i] for i in order]
            self.labels = [self.labels[i] for i in order]
            self.shapes = self.shapes[order]
            ar = ar[order]
            nb = int(np.ceil(self.n / batch_size))
            self.batch_index = np.floor(np.arange(self.n) / batch_size).astype(int)
            shapes = []
            for i in range(nb):
                ari = ar[self.batch_index == i]
                mini, maxi = ari.min(), ari.max()
                if maxi < 1:
                    shapes.append([maxi, 1])
                elif mini > 1:
                    shapes.append([1, 1 / mini])
                else:
                    shapes.append([1, 1])
            self.batch_shapes = (
                np.ceil(np.array(shapes) * imgsz / stride + pad).astype(int) * stride)

        self._im_cache: Optional[Dict[int, Tuple]] = {} if cache_mode == "ram" else None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return self.n

    def load_image(self, i: int):
        """Load + resize longest side to imgsz. Returns (im RGB, (h0, w0), (h, w))."""
        if self._im_cache is not None and i in self._im_cache:
            return self._im_cache[i]
        out = self._decode_image(i)
        if self._im_cache is not None:
            self._im_cache[i] = out
        return out

    def _decode_image(self, i: int):
        """cv2 decode of the full image, then a resize of the longest side to
        imgsz: INTER_AREA when it shrinks, INTER_LINEAR when it grows."""
        import cv2

        im = cv2.imread(self.img_files[i])  # BGR
        if im is None:
            raise FileNotFoundError(self.img_files[i])
        im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        target = (int(w0 * r), int(h0 * r)) if r != 1 else (w0, h0)
        if im.shape[1::-1] != target:
            interp = cv2.INTER_LINEAR if r > 1 else cv2.INTER_AREA
            im = cv2.resize(im, target, interpolation=interp)
        return im, (h0, w0), im.shape[:2]

    def __getitem__(self, index: int):
        index = int(self.indices[index])
        img, (h0, w0), (h, w) = self.load_image(index)
        shape = (tuple(self.batch_shapes[self.batch_index[index]]) if self.rect
                 else (self.imgsz, self.imgsz))
        img, ratio, pad = letterbox_host(img, shape, auto=False, scaleup=False)
        shapes = ((h0, w0), ((h / h0 * ratio[0], w / w0 * ratio[1]), pad))
        labels = self.labels[index].copy()
        if len(labels):
            labels[:, 2:6] = xywhn2xyxy_np(labels[:, 2:6], ratio[0] * w, ratio[1] * h,
                                           pad[0], pad[1])
            labels[:, 2:6] = xyxy2xywhn_np(labels[:, 2:6], w=img.shape[1], h=img.shape[0],
                                           clip=True, eps=1e-3)
        meta = {"path": self.img_files[index], "ori_shape": (h0, w0), "shapes": shapes}
        return np.ascontiguousarray(img), labels.astype(np.float32), meta

    def class_histogram(self, nc: int) -> np.ndarray:
        h = np.zeros(nc, np.int64)
        for lb in self.labels:
            if len(lb):
                np.add.at(h, lb[:, 0].astype(int), 1)
        return h


def labels_to_class_weights(labels: List[np.ndarray], nc: int) -> np.ndarray:
    """Inverse-frequency class weights (general.py:243-259)."""
    counts = np.zeros(nc, np.float64)
    for lb in labels:
        if len(lb):
            np.add.at(counts, lb[:, 0].astype(int), 1)
    weights = 1.0 / np.maximum(counts, 1)
    weights /= weights.sum()
    return weights
