"""Per-task detection dataset: file lists, the label cache, rect batch
shapes, the RAM image cache, the letterbox, and the training side's mosaic,
mixup, affine and pixel augmentation.

Counterpart of cerberusdet_tpu/data/dataset.py (DetectionDataset, after the
reference's LoadImagesAndLabels, cerberusdet/data/datasets.py:171-542), with
the same items bit for bit: HWC RGB uint8 images and (n, 6) [cls, prob, xywhn]
labels, which the loader pads to a fixed count (data/loaders.py). Under
augment=True each item draws from its own random.Random(hash((seed, epoch,
index))), so that items do not depend on the loader's threads. The native
scaled JPEG decoder (fast_decode, on by default under augment) is the port's
own copy (native/). cache_images="disk" is the JAX package's packed disk
cache: one memmapped (n, imgsz, imgsz, 3) uint8 file of every image decoded
and resized, with the same file names, key and layout, so that a pack either
package wrote serves the other without a rebuild.
"""

from __future__ import annotations

import os
import random
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cerberusdet_tpu_torch.data.augment import (
    PixelAugment,
    augment_hsv,
    flip_lr,
    flip_ud,
    mixup,
    random_perspective,
)
from cerberusdet_tpu_torch.data.labels import (
    build_label_cache,
    get_hash,
    img2label_paths,
    list_images,
)
from cerberusdet_tpu_torch.ops.letterbox import letterbox_host

DEFAULT_HYP = dict(
    mosaic=0.0, mixup=0.0, degrees=0.0, translate=0.0, scale=0.0, shear=0.0,
    perspective=0.0, scaleup=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
    flipud=0.0, fliplr=0.0,
)


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


def mosaic_layout(s: int, yc: int, xc: int, dims):
    """Placement geometry of the 4-image mosaic (datasets.py:489-506).

    dims: [(h, w)] x 4 tile sizes. Returns per tile
    ((x1a, y1a, x2a, y2a) canvas rect, (x1b, y1b, x2b, y2b) source rect,
    (h, w))."""
    out = []
    for i, (h, w) in enumerate(dims):
        if i == 0:  # top left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        out.append(((x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b), (h, w)))
    return out


class DetectionDataset:
    """One task's dataset. `__getitem__` returns
    (img HWC-RGB uint8, labels (n, 6) [cls, prob, xywhn], meta dict), with
    meta {'path', 'ori_shape' (h0, w0), 'shapes' ((h0, w0), (ratio, pad))}.

    rect=True sorts the images by aspect ratio and letterboxes each batch of
    `batch_size` to one stride-multiple shape, ceil(shape * imgsz / stride +
    pad) * stride (the reference's val protocol uses pad 0.5). cache_images
    True or "ram" keeps decoded images in memory; "disk" packs them into one
    memmapped file beside the label cache (`_build_pack`). `hyp` and `seed`
    come with augment=True."""

    def __init__(
        self,
        path,
        imgsz: int = 640,
        augment: bool = False,
        hyp: Optional[Dict[str, Any]] = None,
        rect: bool = False,
        stride: int = 32,
        pad: float = 0.0,
        batch_size: int = 16,
        use_xml: bool = False,
        classnames: Optional[Sequence[str]] = None,
        multi_label: bool = False,
        soft_label: bool = False,
        cache_images="",  # False/"" | True/"ram" | "disk"
        task: str = "task",
        cache_dir: Optional[str] = None,
        seed: int = 0,
        single_cls: bool = False,
        fast_decode: Optional[bool] = None,
    ):
        cache_mode = {True: "ram", False: ""}.get(cache_images, cache_images or "")
        if cache_mode not in ("", "ram", "disk"):
            raise ValueError(f"cache_images must be '', 'ram', 'disk' or True, got "
                             f"{cache_images!r}")
        self.imgsz = imgsz
        self.seed = seed
        self.epoch = 0
        self.augment = augment
        self.hyp = {**DEFAULT_HYP, **(hyp or {})}
        self.rect = rect
        self.stride = stride
        self.pad = pad
        self.task = task
        self.mosaic_border = [-imgsz // 2, -imgsz // 2]

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
        self._pixel_aug = PixelAugment()
        # the reference protocol decodes full size for eval: fast_decode
        # follows augment unless asked for
        self.fast_decode = augment if fast_decode is None else fast_decode
        self._pack = None  # (pixels memmap, hw0 (n, 2), hw (n, 2)) under "disk"
        self._pack_path = None
        if cache_mode == "disk":
            self._pack = self._build_pack(cache_path.parent)

    def __getstate__(self):
        """Pickle without pixels (a worker process of data/loaders.py gets
        the dataset so): no RAM cache, and the pack by its path alone, which
        load_image maps again on the first read. Pickling the memmap would
        copy every pixel of the pack into every worker."""
        state = self.__dict__.copy()
        state["_im_cache"] = None  # each worker filling its own would copy the cache
        if state["_pack"] is not None and state["_pack"][0] is not None:
            state["_pack"] = (None,) + state["_pack"][1:]
        return state

    def set_epoch(self, epoch: int):
        """Move the augmentation draws to `epoch`'s."""
        self.epoch = epoch

    def __len__(self) -> int:
        return self.n

    def _build_pack(self, cache_dir: Path):
        """The packed disk cache: one (n, imgsz, imgsz, 3) uint8 .npy of every
        image decoded and resized as _decode_image does (row i holds image i
        at its top left), and a .meta.npz of its key and the (h0, w0) and
        (h, w) of each image. Built once, then memory-mapped read-only by
        every later run whose key matches: the file list's hash and the
        decode configuration (augment picks the resize interpolation,
        fast_decode the decoder). Returns (pixels, hw0, hw)."""
        pack_path = Path(cache_dir) / f"{self.task}.pack{self.imgsz}.npy"
        meta_path = Path(cache_dir) / f"{self.task}.pack{self.imgsz}.meta.npz"
        want = (get_hash(self.img_files)
                + f"|aug={int(self.augment)}|fast={int(bool(self.fast_decode))}")
        self._pack_path = str(pack_path)
        if pack_path.exists() and meta_path.exists():
            meta = np.load(meta_path, allow_pickle=False)
            if str(meta["hash"]) == want and int(meta["n"]) == self.n:
                return np.lib.format.open_memmap(pack_path, mode="r"), meta["hw0"], meta["hw"]
        # written under this process's names and renamed into place: a
        # concurrent reader sees the old pack and its meta, or the new ones
        tmp_pack = pack_path.with_name(f"{pack_path.name}.tmp{os.getpid()}")
        tmp_meta = meta_path.with_name(f"{meta_path.name}.tmp{os.getpid()}")
        arr = np.lib.format.open_memmap(tmp_pack, mode="w+", dtype=np.uint8,
                                        shape=(self.n, self.imgsz, self.imgsz, 3))
        hw0 = np.zeros((self.n, 2), np.int32)
        hw = np.zeros((self.n, 2), np.int32)

        def fill(i: int) -> None:
            im, (h0, w0), (h, w) = self._decode_image(i)
            arr[i, :h, :w] = im
            hw0[i] = (h0, w0)
            hw[i] = (h, w)

        # the decoders release the GIL: threads over disjoint rows
        workers = min(16, os.cpu_count() or 1)
        if workers > 1 and self.n > 1:
            with ThreadPoolExecutor(workers) as ex:
                list(ex.map(fill, range(self.n)))
        else:
            for i in range(self.n):
                fill(i)
        arr.flush()
        del arr
        with open(tmp_meta, "wb") as f:
            np.savez(f, hash=want, n=self.n, hw0=hw0, hw=hw)
        os.replace(tmp_pack, pack_path)
        os.replace(tmp_meta, meta_path)
        arr = np.lib.format.open_memmap(pack_path, mode="r")
        print(f"{self.task}: packed {self.n} images -> {pack_path} ({arr.nbytes / 1e9:.2f} GB)")
        return arr, hw0, hw

    def load_image(self, i: int):
        """Load + resize longest side to imgsz. Returns (im RGB, (h0, w0), (h, w)).
        From the pack, the image is a read-only view of its row: every
        consumer copies before it writes."""
        if self._im_cache is not None and i in self._im_cache:
            return self._im_cache[i]
        if self._pack is not None:
            arr, hw0, hw = self._pack
            if arr is None:  # a pickled copy: map the pack again
                arr = np.lib.format.open_memmap(self._pack_path, mode="r")
                self._pack = (arr, hw0, hw)
            h, w = int(hw[i, 0]), int(hw[i, 1])
            return arr[i, :h, :w], (int(hw0[i, 0]), int(hw0[i, 1])), (h, w)
        out = self._decode_image(i)
        if self._im_cache is not None:
            self._im_cache[i] = out
        return out

    def _decode_image(self, i: int):
        """Decode, then resize the longest side to imgsz: INTER_LINEAR under
        augment or when it grows, else INTER_AREA. fast_decode takes the
        native scaled decoder where it can, cv2's full decode otherwise."""
        import cv2

        im = None
        h0 = w0 = 0
        if self.fast_decode:
            from cerberusdet_tpu_torch.native import imread_scaled

            scaled = imread_scaled(self.img_files[i], self.imgsz)
            if scaled is not None:
                im, (h0, w0) = scaled  # RGB, at least the target size
        if im is None:
            im = cv2.imread(self.img_files[i])  # BGR
            if im is None:
                raise FileNotFoundError(self.img_files[i])
            im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
            h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        target = (int(w0 * r), int(h0 * r)) if r != 1 else (w0, h0)
        if im.shape[1::-1] != target:
            interp = cv2.INTER_LINEAR if (self.augment or r > 1) else cv2.INTER_AREA
            im = cv2.resize(im, target, interpolation=interp)
        return im, (h0, w0), im.shape[:2]

    # -------------------------------------------------------------- mosaic
    def draw_mosaic_layout(self, index: int, rng=random):
        """The mosaic's draws: the centre (yc, xc) and the 4 tile indices."""
        s = self.imgsz
        yc, xc = (int(rng.uniform(-x, 2 * s + x)) for x in self.mosaic_border)
        indices = [index] + rng.choices(range(self.n), k=3)
        rng.shuffle(indices)
        return yc, xc, indices

    def mosaic_labels(self, indices, placements) -> np.ndarray:
        """Pre-warp mosaic labels: each tile's boxes shifted into canvas
        coordinates and clipped to the 2s x 2s canvas."""
        labels4 = []
        for idx, ((x1a, y1a, _, _), (x1b, y1b, _, _), (h, w)) in zip(indices, placements):
            lb = self.labels[idx].copy()
            if len(lb):
                lb[:, 2:6] = xywhn2xyxy_np(lb[:, 2:6], w, h, x1a - x1b, y1a - y1b)
            labels4.append(lb)
        labels4 = np.concatenate(labels4, 0) if labels4 else np.zeros((0, 6), np.float32)
        np.clip(labels4[:, 2:6], 0, 2 * self.imgsz, out=labels4[:, 2:6])
        return labels4

    def load_mosaic(self, index: int, rng=random):
        """4-image mosaic on a 2s x 2s canvas, then the affine crop to s x s
        (datasets.py:483-542)."""
        s = self.imgsz
        yc, xc, indices = self.draw_mosaic_layout(index, rng)
        ims = [self.load_image(idx) for idx in indices]
        placements = mosaic_layout(s, yc, xc, [im[2] for im in ims])
        im4 = np.full((s * 2, s * 2, 3), 114, np.uint8)
        for (im, _, _), ((x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b), _) in zip(
                ims, placements):
            im4[y1a:y2a, x1a:x2a] = im[y1b:y2b, x1b:x2b]
        labels4 = self.mosaic_labels(indices, placements)
        return random_perspective(
            im4, labels4,
            degrees=self.hyp["degrees"], translate=self.hyp["translate"],
            scale=self.hyp["scale"], shear=self.hyp["shear"],
            perspective=self.hyp["perspective"], border=self.mosaic_border,
            scaleup=float(self.hyp.get("scaleup", 0.0)), rng=rng,
        )

    def __getitem__(self, index: int):
        index = int(self.indices[index])
        # a fixed function of (seed, epoch, index): concurrent prefetch
        # threads cannot perturb the draws
        rng = random.Random(hash((self.seed, self.epoch, index)))
        hyp = self.hyp
        if self.augment and rng.random() < hyp["mosaic"]:
            img, labels = self.load_mosaic(index, rng)
            shapes = None
            ori_shape = (self.imgsz, self.imgsz)
            if rng.random() < hyp["mixup"]:
                img, labels = mixup(
                    img, labels, *self.load_mosaic(rng.randint(0, self.n - 1), rng), rng=rng)
        else:
            img, (h0, w0), (h, w) = self.load_image(index)
            shape = (tuple(self.batch_shapes[self.batch_index[index]]) if self.rect
                     else (self.imgsz, self.imgsz))
            img, ratio, pad = letterbox_host(img, shape, auto=False, scaleup=self.augment)
            shapes = ((h0, w0), ((h / h0 * ratio[0], w / w0 * ratio[1]), pad))
            ori_shape = (h0, w0)
            labels = self.labels[index].copy()
            if len(labels):
                labels[:, 2:6] = xywhn2xyxy_np(labels[:, 2:6], ratio[0] * w, ratio[1] * h,
                                               pad[0], pad[1])
            if self.augment:
                img, labels = random_perspective(
                    img, labels, degrees=hyp["degrees"], translate=hyp["translate"],
                    scale=hyp["scale"], shear=hyp["shear"], perspective=hyp["perspective"],
                    scaleup=float(hyp.get("scaleup", 0.0)), rng=rng)

        if len(labels):
            labels[:, 2:6] = xyxy2xywhn_np(labels[:, 2:6], w=img.shape[1], h=img.shape[0],
                                           clip=True, eps=1e-3)
        if self.augment:
            img = self._pixel_aug(img, rng)
            augment_hsv(img, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"], rng=rng)
            if rng.random() < hyp["flipud"]:
                img, labels[:, 2:6] = flip_ud(img, labels[:, 2:6])
            if rng.random() < hyp["fliplr"]:
                img, labels[:, 2:6] = flip_lr(img, labels[:, 2:6])
        meta = {"path": self.img_files[index], "ori_shape": ori_shape, "shapes": shapes}
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
