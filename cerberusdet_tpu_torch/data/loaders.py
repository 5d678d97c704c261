"""Batch assembly: padded fixed-shape collate, a thread-prefetch loader, its
worker-process pool and its augmentation on the card.

Counterpart of cerberusdet_tpu/data/loaders.py (after the reference's
create_dataloader, cerberusdet/data/dataloaders.py:39-93, and
InfiniteDataLoader, :96-112), with the same batches:
  * the collate pads labels to `max_labels` per image and emits a dense
    {img, cls, prob, bboxes, mask, meta} dict of numpy arrays; images stay
    NHWC uint8 on the host (the consumer moves them to the card);
  * decode and augmentation run on a thread pool (cv2 and the native
    decoder release the GIL), or with num_workers > 0 on a pool of spawned
    worker processes, each with its own copy of the dataset; batches are
    assembled in sampler order, and every item draws from its own
    (seed, epoch, index) stream, so a batch depends neither on the threads,
    the processes nor on prefetching;
  * device_augment: the workers plan each item (data/device_augment.py) and
    the consumer's thread runs the batch's pixel work on `device`, where
    'img' arrives as a uint8 tensor; the labels equal the host pipeline's.
    Every device operation of a batch runs on the consumer's thread, never
    on the prefetch thread or in a worker, so a CUDA graph that the
    consumer captures meanwhile sees no launch from another thread;
  * training loaders (augment=True) shuffle per epoch or sample class-
    balanced, and drop the last partial batch.
torch is imported only where the device side runs, so that the spawned
workers, which import this module, start without it.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from cerberusdet_tpu_torch.data.dataset import DetectionDataset
from cerberusdet_tpu_torch.data.samplers import BalancedSampler, ShuffleSampler

# The worker process's dataset, set by its initializer. Items stay
# deterministic across processes: the (seed, epoch, index) of each draw goes
# with the request.
_WORKER_DS: Optional[DetectionDataset] = None

# Device bytes claimed by the resident packs of every loader of this process
# (a multi-task run builds one loader a task: the budget bounds their sum)
_RESIDENT_CLAIMED = 0
_RESIDENT_LOCK = threading.Lock()


def _set_row(img, i: int, row) -> None:
    """img[i] = row[0], in place (a blurred row patched into its batch)."""
    img[i].copy_(row[0])


def _init_worker(dataset: DetectionDataset, decoder: str) -> None:
    """A worker's initializer. `decoder`: the JPEG decoder the parent
    resolved ("native" or "cv2"), or "" where the workers decode nothing
    with it; a worker that resolves another would decode other pixels."""
    global _WORKER_DS
    import cv2

    _WORKER_DS = dataset
    cv2.setNumThreads(0)  # one cv2 thread a worker process
    if decoder:
        from cerberusdet_tpu_torch.native import default_decoder

        own = default_decoder()
        own.lib()
        if own.name != decoder:
            raise RuntimeError(f"a loader worker decodes JPEGs with {own.name!r}, the parent "
                               f"with {decoder!r}: their pixels would differ")


def _worker_getitem(epoch: int, index: int):
    _WORKER_DS.epoch = epoch
    return _WORKER_DS[index]


def _worker_getplan(epoch: int, index: int):
    from cerberusdet_tpu_torch.data.device_augment import plan_sample

    _WORKER_DS.epoch = epoch
    return plan_sample(_WORKER_DS, index)


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
    `num_threads` threads, or of `num_workers` spawned processes when > 0
    (kept across epochs until `close`); prefetch 0 decodes inline. Drops the
    last partial batch when `drop_last`.

    device_augment (a dataset with the packed cache): the batch's pixel work
    runs on `device` (None: the card) as make_augment_fn's warp route for
    the hyp: einsums for axis-aligned hyps, the 3-pass affine warp for
    rotating or shearing ones with perspective 0 whose shear padding is at
    most imgsz / 4, the gather warp otherwise. The pack is uploaded once
    and batches bring only its rows ('resident') while the packs of the
    process fit CERBERUS_DEVICE_PACK_GB (default 2.0) GB; otherwise each
    batch ships its tiles."""

    def __init__(self, dataset: DetectionDataset, batch_size: int, sampler=None,
                 max_labels: int = 300, drop_last: bool = True,
                 prefetch: int = 3, num_threads: Optional[int] = None,
                 num_workers: int = 0, device_augment: bool = False, device=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler if sampler is not None else ShuffleSampler(len(dataset), False)
        self.max_labels = max_labels
        self.drop_last = drop_last
        self.prefetch = prefetch
        if num_threads is None:
            num_threads = min(8, os.cpu_count() or 1)
        self.num_threads = max(num_threads, 1)
        self.num_workers = max(num_workers, 0)
        self._pool = None
        self.device_augment = device_augment
        self._aug_fn = None
        self._dev_pack = None
        self._resident = False
        self._claimed_bytes = 0
        self._axis_aligned = False
        self._affine_pad = 0
        self._pixel_fns = {}
        self.device = None
        if device_augment:
            from cerberusdet_tpu_torch import resolve_device
            from cerberusdet_tpu_torch.data.device_augment import affine3_pad

            if dataset._pack is None:
                raise RuntimeError("device_augment requires cache_images='disk' (the packed "
                                   "memmap)")
            self.device = resolve_device(device)
            hyp = dataset.hyp
            self._axis_aligned = not (hyp.get("degrees", 0) or hyp.get("shear", 0)
                                      or hyp.get("perspective", 0))
            self._affine_pad = affine3_pad(hyp, dataset.imgsz)
            global _RESIDENT_CLAIMED
            budget = float(os.environ.get("CERBERUS_DEVICE_PACK_GB", "2.0"))
            nbytes = dataset._pack[0].nbytes
            with _RESIDENT_LOCK:
                if _RESIDENT_CLAIMED + nbytes <= budget * 1e9:
                    _RESIDENT_CLAIMED += nbytes
                    self._claimed_bytes = nbytes
                    self._resident = True

    @property
    def warp_route(self) -> str:
        """The device augmentation's warp: "matmul", "affine3" or "gather"."""
        return ("affine3" if self._affine_pad else "matmul" if self._axis_aligned
                else "gather")

    def _device_pack(self):
        """The pack on the device, uploaded by the first call in slices of
        rows (a host copy of one slice at a time)."""
        if self._dev_pack is None:
            import torch

            arr = self.dataset._pack[0]
            pack = torch.empty(arr.shape, dtype=torch.uint8, device=self.device)
            for i in range(0, len(arr), 64):
                pack[i:i + 64].copy_(torch.from_numpy(np.array(arr[i:i + 64])))
            self._dev_pack = pack
        return self._dev_pack

    def _augment_on_device(self, item):
        """{tiles | tile_idx, aug, ...} -> {img: (B, S, S, 3) uint8 on the
        device, ...}. The rows that draw a blur or a median (item
        "pixel_ops") are augmented again one at a time by the variant for
        their (blur_k, median_k), which applies it at the host pipeline's
        point, between mixup and grayscale, and written into the batch."""
        import torch

        from cerberusdet_tpu_torch.data.device_augment import make_augment_fn

        item = dict(item)
        ops = item.pop("pixel_ops", ())
        aug = {k: torch.from_numpy(v).to(self.device) for k, v in item.pop("aug").items()}
        if "tile_idx" in item:
            src = self._device_pack()
            tile_idx = torch.from_numpy(item.pop("tile_idx")).to(self.device)
            n_slots = tile_idx.shape[1]
        else:
            tiles = torch.from_numpy(item.pop("tiles")).to(self.device)
            n_slots = tiles.shape[1]
        if self._aug_fn is None:
            self._aug_fn = make_augment_fn(self.dataset.imgsz, n_slots, resident=self._resident,
                                           axis_aligned=self._axis_aligned,
                                           shear_pad=self._affine_pad)
        img = self._aug_fn(src, tile_idx, aug) if self._resident else self._aug_fn(tiles, aug)
        for i, bk, mk in ops:
            one = {k: v[i:i + 1] for k, v in aug.items()}
            fn = self._pixel_fn((bk, mk), n_slots)
            row = fn(src, tile_idx[i:i + 1], one) if self._resident else fn(tiles[i:i + 1], one)
            _set_row(img, i, row)
        item["img"] = img
        return item

    def _pixel_fn(self, key, n_slots):
        """The one-sample variant with (blur_k, median_k) applied, made on
        first use and kept for the loader's life."""
        fn = self._pixel_fns.get(key)
        if fn is None:
            from cerberusdet_tpu_torch.data.device_augment import make_augment_fn

            fn = self._pixel_fns[key] = make_augment_fn(
                self.dataset.imgsz, n_slots, resident=self._resident,
                axis_aligned=self._axis_aligned, shear_pad=self._affine_pad, pixel_ops=key)
        return fn

    def _collate_plans(self, plans, pool=None):
        from cerberusdet_tpu_torch.data.device_augment import collate_device

        return collate_device(self.dataset, plans, self.max_labels, pool,
                              as_indices=self._resident)

    def _collate_batch(self, idxs, pool=None):
        """One batch, its items on `pool` or inline."""
        if self.device_augment:
            from cerberusdet_tpu_torch.data.device_augment import plan_sample

            plan = lambda i: plan_sample(self.dataset, i)  # noqa: E731
            plans = list(pool.map(plan, idxs)) if pool is not None else [plan(i) for i in idxs]
            return self._collate_plans(plans, pool)
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

    def _process_pool(self):
        """The worker processes, started on first use with a copy of the
        dataset each (pickled without pixels: DetectionDataset.__getstate__).
        Spawned, not forked: the pool starts from the prefetch thread of a
        process with threads, where a fork can copy a held lock into the
        child. The parent resolves the JPEG decoder first, and each worker
        that decodes checks that it takes the same one."""
        if self._pool is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            decoder = ""
            if self.dataset.fast_decode and self.dataset._pack is None:
                from cerberusdet_tpu_torch.native import default_decoder

                default_decoder().lib()
                decoder = default_decoder().name
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker, initargs=(self.dataset, decoder))
        return self._pool

    def close(self):
        """Stop the worker processes and give back the resident pack's share
        of the budget."""
        global _RESIDENT_CLAIMED
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        if self._claimed_bytes:
            with _RESIDENT_LOCK:
                _RESIDENT_CLAIMED -= self._claimed_bytes
            self._claimed_bytes = 0
            self._dev_pack = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # an interpreter shutting down may have torn down the pool
            pass

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
        finish = self._augment_on_device if self.device_augment else (lambda item: item)
        if self.prefetch <= 0:
            for idxs in self._batches():
                yield finish(self._collate_batch(idxs))
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()

        def worker():
            # executor.map keeps sample order: batches equal the inline path's
            try:
                if self.num_workers:
                    pool = self._process_pool()
                    epoch = self.dataset.epoch
                    # the shipped tiles' copies still spread over threads
                    with ThreadPoolExecutor(self.num_threads) as tpool:
                        for idxs in self._batches():
                            if cancel.is_set():
                                return
                            if self.device_augment:
                                plans = list(pool.map(_worker_getplan, [epoch] * len(idxs),
                                                      idxs))
                                q.put(self._collate_plans(plans, tpool))
                            else:
                                samples = list(pool.map(_worker_getitem, [epoch] * len(idxs),
                                                        idxs))
                                q.put(collate(samples, self.max_labels))
                    return
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
                yield finish(item)
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
    cache_images="",  # False/"" | True/"ram" | "disk"
    num_threads: Optional[int] = None,
    single_cls: bool = False,
    fast_decode: Optional[bool] = None,
    num_workers: int = 0,
    augment_device: bool = False,
    device=None,
):
    """Build (dataset, loader) for one task, with the JAX package's arguments
    (dataloaders.py:39-93 parity). A training loader (augment=True) draws
    from `hyp` and `seed`, shuffles per epoch (or samples class-balanced,
    balanced_sampler with class_choice) and drops the last partial batch; an
    eval loader keeps the dataset's order. host_sharded splits the set over
    processes in a run of several: that comes with multi-GPU data
    parallelism (ROADMAP.md queue 1, item 6) and raises there until then; in
    one process it changes nothing. augment_device (training loaders only;
    an eval loader ignores it) augments on `device` from the packed cache,
    which it turns on."""
    if augment_device:
        if not augment:
            augment_device = False  # the device pipeline is the training side's
        elif rect:
            raise ValueError("augment_device is incompatible with rect batching")
        else:
            cache_images = "disk"  # the pack is the tiles' source
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
                        drop_last=augment, num_threads=num_threads, num_workers=num_workers,
                        device_augment=augment_device, device=device)
    return dataset, loader
