"""Batch assembly: padded fixed-shape collate and a thread-prefetch loader.

Counterpart of cerberusdet_tpu/data/loaders.py (after the reference's
create_dataloader, cerberusdet/data/dataloaders.py:39-93, and
InfiniteDataLoader, :96-112), with the same batches:
  * the collate pads labels to `max_labels` per image and emits a dense
    {img, cls, prob, bboxes, mask, meta} dict of numpy arrays; images stay
    NHWC uint8 on the host (the consumer moves them to the card);
  * decode and augmentation run on a thread pool (cv2 and the native
    decoder release the GIL) and batches are assembled in sampler order, so
    a batch does not depend on the thread count or on prefetching;
  * training loaders (augment=True) shuffle per epoch or sample class-
    balanced, and drop the last partial batch.
The JAX package's worker-process pool (num_workers > 0) and its device-side
augmentation come with the data pipeline's next slice and with GPU
augmentation (ROADMAP.md queue 1, items 2 and 8), and raise until then.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from cerberusdet_tpu_torch.data.dataset import TRAIN_SIDE, DetectionDataset
from cerberusdet_tpu_torch.data.samplers import BalancedSampler, ShuffleSampler


def pad_labels(labels: List[np.ndarray], max_labels: int) -> Dict[str, np.ndarray]:
    """Dense-pad per-sample (n, 6) [cls, prob, xywhn] label arrays to
    {'cls': (B,M) i32, 'prob': (B,M) f32, 'bboxes': (B,M,4) f32,
    'mask': (B,M) bool}."""
    b = len(labels)
    cls = np.zeros((b, max_labels), np.int32)
    prob = np.zeros((b, max_labels), np.float32)
    boxes = np.zeros((b, max_labels, 4), np.float32)
    mask = np.zeros((b, max_labels), bool)
    for i, lb in enumerate(labels):
        n = min(len(lb), max_labels)
        if n:
            cls[i, :n] = lb[:n, 0].astype(np.int32)
            prob[i, :n] = lb[:n, 1]
            boxes[i, :n] = lb[:n, 2:6]
            mask[i, :n] = True
    return {"cls": cls, "prob": prob, "bboxes": boxes, "mask": mask}


def collate(samples: List[tuple], max_labels: int = 300) -> Dict[str, Any]:
    """[(img, labels (n,6), meta)] -> dense batch dict.

    Returns {'img': (B,H,W,3) uint8, 'cls': (B,M) i32, 'prob': (B,M) f32,
    'bboxes': (B,M,4) f32 xywhn, 'mask': (B,M) bool, 'meta': [meta...]}."""
    imgs = np.stack([s[0] for s in samples])
    out = pad_labels([s[1] for s in samples], max_labels)
    out["img"] = imgs
    out["meta"] = [s[2] for s in samples]
    return out


class DataLoader:
    """Sampler-driven batched loader. prefetch > 0 assembles up to that many
    batches ahead on a background thread, each decoded on a pool of
    `num_threads` threads; prefetch 0 decodes inline. Drops the last
    partial batch when `drop_last`."""

    def __init__(self, dataset: DetectionDataset, batch_size: int, sampler=None,
                 max_labels: int = 300, drop_last: bool = True,
                 prefetch: int = 3, num_threads: Optional[int] = None,
                 num_workers: int = 0, device_augment: bool = False):
        if num_workers:
            raise NotImplementedError(f"num_workers > 0 (the process pool) {TRAIN_SIDE}")
        if device_augment:
            raise NotImplementedError("device_augment: GPU-side augmentation is not ported "
                                      "yet (ROADMAP.md queue 1, item 8)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler if sampler is not None else ShuffleSampler(len(dataset), False)
        self.max_labels = max_labels
        self.drop_last = drop_last
        self.prefetch = prefetch
        if num_threads is None:
            num_threads = min(8, os.cpu_count() or 1)
        self.num_threads = max(num_threads, 1)

    def _collate_batch(self, idxs, pool=None):
        if pool is not None:
            samples = list(pool.map(self.dataset.__getitem__, idxs))
        else:
            samples = [self.dataset[i] for i in idxs]
        return collate(samples, self.max_labels)

    def set_epoch(self, epoch: int):
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> Iterator[List[int]]:
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.prefetch <= 0:
            for idxs in self._batches():
                yield self._collate_batch(idxs)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()

        def worker():
            # executor.map keeps sample order: batches equal the inline path's
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for idxs in self._batches():
                        if cancel.is_set():
                            return
                        q.put(self._collate_batch(idxs, pool))
            except BaseException as e:  # handed to the consumer, which raises it
                q.put(e)
            finally:
                # deliver the sentinel; give up if the consumer has left
                while not cancel.is_set():
                    try:
                        q.put(stop, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early stops the worker too
            cancel.set()
            while t.is_alive():
                while not q.empty():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                t.join(timeout=0.05)


class InfiniteLoader:
    """Cycles the underlying loader forever, bumping the sampler epoch
    (the reference's InfiniteDataLoader). `epoch` seeds the sampler and
    dataset streams of the first pass."""

    def __init__(self, loader: DataLoader, epoch: int = 0):
        self.loader = loader
        self.epoch = epoch
        self._it = None

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        if self._it is None:
            self.loader.set_epoch(self.epoch)
            self._it = iter(self.loader)
        try:
            return next(self._it)
        except StopIteration:
            self.epoch += 1
            self.loader.set_epoch(self.epoch)
            self._it = iter(self.loader)
            return next(self._it)

    def __iter__(self):
        return self


def create_dataloader(
    path,
    imgsz: int,
    batch_size: int,
    stride: int = 32,
    hyp: Optional[dict] = None,
    augment: bool = False,
    rect: bool = False,
    pad: float = 0.0,
    balanced_sampler: bool = False,
    class_choice: str = "least_sampled",
    shuffle: bool = True,
    use_xml: bool = False,
    classnames=None,
    multi_label: bool = False,
    soft_label: bool = False,
    max_labels: int = 300,
    task: str = "task",
    seed: int = 0,
    host_sharded: bool = True,
    cache_dir: Optional[str] = None,
    cache_images="",  # False/"" | True/"ram"
    num_threads: Optional[int] = None,
    single_cls: bool = False,
    fast_decode: Optional[bool] = None,
    num_workers: int = 0,
    augment_device: bool = False,
):
    """Build (dataset, loader) for one task, with the JAX package's arguments
    (dataloaders.py:39-93 parity). A training loader (augment=True) draws
    from `hyp` and `seed`, shuffles per epoch (or samples class-balanced,
    balanced_sampler with class_choice) and drops the last partial batch; an
    eval loader keeps the dataset's order. host_sharded splits the set over
    processes in a run of several: that comes with multi-GPU data
    parallelism (ROADMAP.md queue 1, item 6) and raises there until then; in
    one process it changes nothing."""
    if augment_device:
        raise NotImplementedError("augment_device: GPU-side augmentation is not ported yet "
                                  "(ROADMAP.md queue 1, item 8)")
    if host_sharded:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError("host_sharded loading over several processes comes "
                                      "with data parallelism (ROADMAP.md queue 1, item 6)")
    dataset = DetectionDataset(
        path, imgsz=imgsz, augment=augment, hyp=hyp, rect=rect, stride=stride,
        pad=pad, batch_size=batch_size, use_xml=use_xml, classnames=classnames,
        multi_label=multi_label, soft_label=soft_label, task=task,
        cache_dir=cache_dir, cache_images=cache_images, seed=seed,
        single_cls=single_cls, fast_decode=fast_decode,
    )
    if balanced_sampler and augment:
        sampler = BalancedSampler(dataset.labels, class_choice, seed=seed)
    else:
        sampler = ShuffleSampler(len(dataset), shuffle=shuffle and augment, seed=seed)
    loader = DataLoader(dataset, batch_size, sampler, max_labels=max_labels,
                        drop_last=augment, num_threads=num_threads, num_workers=num_workers)
    return dataset, loader
