"""The training data path's packed disk cache and worker-process pool in the
port (cerberusdet_tpu_torch/data/dataset.py, data/loaders.py), against the
JAX package's, on the CPU at 64 px over 12 seeded JPEGs (sources up to 1280
px, which the native decoder scales in the DCT).

  * The pack: array and meta equal to JAX's pack for the same set and decode
    flags (fast_decode off and on), and each package maps the other's pack
    without a rebuild (no decode); host batches from the pack equal batches
    decoded, bit for bit; a pickled dataset carries no pixels and maps the
    pack again.
  * The pool (num_workers=2, spawned): the batches of the threads and of the
    JAX package's loader over 2 epochs; the planner workers' plans equal the
    inline ones and the device-augmented batches too; a worker whose JPEG
    decoder is not the parent's raises; an early `break` stops the prefetch
    thread and close() stops the workers, within a time limit.
  * cli.train on the CPU (yolov8n_2task, 64 px, one epoch) with --cache-images
    disk --proc-workers 2, and with --augment-device.
Tolerance: none; every comparison is equality.
"""

import os
import pickle
import threading

import numpy as np
import pytest
import torch
import yaml

from cerberusdet_tpu import native as jax_native
from cerberusdet_tpu.data.dataset import DetectionDataset as JaxDataset
from cerberusdet_tpu.data.loaders import create_dataloader as jax_create_dataloader
from cerberusdet_tpu_torch import native
from cerberusdet_tpu_torch.cli import train as cli_train
from cerberusdet_tpu_torch.data import device_augment as pda
from cerberusdet_tpu_torch.data import loaders
from cerberusdet_tpu_torch.data.dataset import DetectionDataset
from cerberusdet_tpu_torch.data.loaders import create_dataloader
from cerberusdet_tpu_torch.testing import write_val_set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
AUG_HYP = dict(mosaic=0.7, mixup=0.5, degrees=10.0, translate=0.2, scale=0.5, shear=2.0,
               perspective=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, flipud=0.3, fliplr=0.5)
SIZES = [(80, 60), (60, 80), (1280, 720), (100, 40), (640, 480), (120, 70)]
BATCH_KEYS = ("img", "cls", "prob", "bboxes", "mask")


@pytest.fixture
def one_thread():
    """One intra-op thread: many small CPU ops, several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    """12 seeded JPEGs with 0-5 labels of 3 classes; both packages' native
    decoders resolved once here, before any threaded first use."""
    root = tmp_path_factory.mktemp("torch_loaders")
    img_dir = write_val_set(str(root), 12, SIZES, seed=5, n_labels=5, nc=3)
    ours = native.default_decoder().imread(os.path.join(img_dir, "0000.jpg"), 64)
    assert jax_native.available() == (ours is not None)
    return img_dir


def _dir(path):
    path.mkdir(parents=True, exist_ok=True)
    return str(path)


def _same_batch(a, b, what=""):
    for k in BATCH_KEYS:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
        y = np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")


# ---------------------------------------------------------------- the pack


@pytest.mark.parametrize("augment,fast", [(True, False), (True, True), (False, False)])
def test_pack_equals_jax_and_each_reads_the_others(train_set, tmp_path, monkeypatch,
                                                   augment, fast):
    kw = dict(imgsz=64, augment=augment, hyp=AUG_HYP if augment else None,
              cache_images="disk", fast_decode=fast, task="t")
    ours = DetectionDataset(train_set, cache_dir=_dir(tmp_path / "port"), **kw)
    theirs = JaxDataset(train_set, cache_dir=_dir(tmp_path / "jax"), **kw)
    for a, b in zip(ours._pack, theirs._pack):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for name in ("t.pack64.npy", "t.pack64.meta.npz"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()

    # each package maps the other's pack: nothing decodes
    def no_decode(self, i):
        raise AssertionError("the pack was rebuilt")

    monkeypatch.setattr(DetectionDataset, "_decode_image", no_decode)
    monkeypatch.setattr(JaxDataset, "_decode_image", no_decode)
    swapped = [DetectionDataset(train_set, cache_dir=str(tmp_path / "jax"), **kw),
               JaxDataset(train_set, cache_dir=str(tmp_path / "port"), **kw)]
    for ds, ref in zip(swapped, (theirs, ours)):
        np.testing.assert_array_equal(ds._pack[0], ref._pack[0])
        np.testing.assert_array_equal(ds._pack[2], ref._pack[2])
    # another decode configuration is another key: the port rebuilds
    other = dict(kw, fast_decode=not fast)
    with pytest.raises(AssertionError, match="rebuilt"):
        DetectionDataset(train_set, cache_dir=str(tmp_path / "jax"), **other)


@pytest.mark.parametrize("augment", [True, False])
def test_batches_from_pack_equal_decoded(train_set, tmp_path, augment):
    kw = dict(imgsz=64, batch_size=4, hyp=AUG_HYP if augment else None, augment=augment,
              seed=3, max_labels=8, num_threads=3, task="t")
    _, packed = create_dataloader(train_set, cache_dir=_dir(tmp_path / "p"),
                                  cache_images="disk", **kw)
    _, decoded = create_dataloader(train_set, cache_dir=_dir(tmp_path / "d"), **kw)
    assert packed.dataset._pack is not None and decoded.dataset._pack is None
    for epoch in range(2):
        packed.set_epoch(epoch)
        decoded.set_epoch(epoch)
        n = 0
        for a, b in zip(packed, decoded):
            _same_batch(a, b, f"epoch {epoch}")
            assert a["meta"] == b["meta"]
            n += 1
        assert n == len(decoded) == 3


def test_pickled_dataset_ships_no_pixels(train_set, tmp_path):
    ds = DetectionDataset(train_set, imgsz=64, augment=True, hyp=AUG_HYP, task="t",
                          cache_images="disk", cache_dir=_dir(tmp_path))
    ram = DetectionDataset(train_set, imgsz=64, augment=True, hyp=AUG_HYP, task="r",
                           cache_images="ram", cache_dir=_dir(tmp_path))
    for i in range(len(ram)):
        ram.load_image(i)
    assert len(ram._im_cache) == 12 and ds._pack[0].nbytes == 12 * 64 * 64 * 3
    blob = pickle.dumps(ds)
    assert len(blob) < 16384 and len(pickle.dumps(ram)) < 16384
    copy = pickle.loads(blob)
    assert copy._pack[0] is None and copy._im_cache is None
    assert pickle.loads(pickle.dumps(ram))._im_cache is None
    for i in range(len(ds)):
        a, b = copy.load_image(i), ds.load_image(i)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    assert copy._pack[0] is not None  # mapped again on first read
    ds.set_epoch(1)
    copy.set_epoch(1)
    for i in range(4):
        np.testing.assert_array_equal(copy[i][0], ds[i][0])


# ---------------------------------------------------------------- the pool


def test_pool_batches_equal_threads_and_jax(train_set, tmp_path):
    """2 worker processes, threads and the JAX package's loader over 2
    epochs: the same batches; then the device-augmented loader on the same
    pool's planners."""
    kw = dict(imgsz=64, batch_size=4, hyp=AUG_HYP, augment=True, seed=3, max_labels=8,
              num_threads=2, task="t", cache_dir=_dir(tmp_path / "c"))
    _, pool = create_dataloader(train_set, num_workers=2, **kw)
    _, threads = create_dataloader(train_set, **kw)
    _, ref = jax_create_dataloader(train_set, host_sharded=False, **kw)
    try:
        for epoch in range(2):
            for ld in (pool, threads, ref):
                ld.set_epoch(epoch)
            batches = list(zip(pool, threads, ref))
            assert len(batches) == 3
            for a, b, c in batches:
                _same_batch(a, b, f"pool vs threads, epoch {epoch}")
                _same_batch(a, c, f"pool vs JAX, epoch {epoch}")
        assert pool._pool is not None
    finally:
        pool.close()

    dkw = dict(kw, hyp=dict(AUG_HYP, degrees=0.0, shear=0.0), augment_device=True,
               device="cpu")
    _, planned = create_dataloader(train_set, num_workers=2, **dkw)
    _, inline = create_dataloader(train_set, **dkw)
    try:
        planned.set_epoch(1)
        inline.set_epoch(1)
        idxs = list(planned.sampler)
        plans = list(planned._process_pool().map(loaders._worker_getplan, [1] * len(idxs),
                                                 idxs))
        for i, p in zip(idxs, plans):
            want = pda.plan_sample(inline.dataset, i)
            for f in pda.SamplePlan.__dataclass_fields__:
                x, y = getattr(p, f), getattr(want, f)
                assert (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y), f
        for a, b in zip(planned, inline):
            _same_batch(a, b, "planner pool vs inline")
    finally:
        planned.close()
        inline.close()


def test_worker_with_another_decoder_raises(train_set):
    ds = DetectionDataset(train_set, imgsz=64, augment=True, hyp=AUG_HYP)
    loaders._init_worker(ds, native.default_decoder().name)
    assert loaders._WORKER_DS is ds
    other = {"native": "cv2", "cv2": "native"}[native.default_decoder().name]
    with pytest.raises(RuntimeError, match="pixels would differ"):
        loaders._init_worker(ds, other)


def test_early_break_stops_the_pool(train_set, tmp_path):
    """Break after one batch of an epoch: the prefetch thread ends, and
    close() ends the worker processes, each within 60 s."""
    _, loader = create_dataloader(train_set, 64, 2, hyp=AUG_HYP, augment=True, task="t",
                                  cache_dir=_dir(tmp_path), num_workers=2, num_threads=1)
    before = set(threading.enumerate())
    done = threading.Event()

    def consume():
        for _ in loader:
            break
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert done.is_set() and not t.is_alive()
    # the prefetch thread (the loader's `worker`), if the generator's close
    # has not joined it yet, must be ending
    prefetch = [th for th in set(threading.enumerate()) - before
                if th.name.endswith("(worker)")]
    for th in prefetch:
        th.join(timeout=60)
        assert not th.is_alive()
    pool = loader._pool
    procs = list(pool._processes.values())
    assert len(procs) == 2 and all(p.is_alive() for p in procs)
    manager = pool._executor_manager_thread  # it joins (reaps) the workers
    loader.close()
    manager.join(timeout=60)
    assert not manager.is_alive()
    assert all(p.exitcode is not None for p in procs)
    assert loader._pool is None


# ---------------------------------------------------------------- cli.train


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_loaders_cli")
    data = {"task_ids": ["a", "b"], "nc": [3, 2], "names": [["x", "y", "z"], ["u", "v"]],
            "train": [], "val": []}
    for ti, (t, nc) in enumerate(zip(data["task_ids"], data["nc"])):
        data["train"].append(write_val_set(str(root / t / "train"), 4, SIZES, seed=ti,
                                           n_labels=3, nc=nc))
        data["val"].append(write_val_set(str(root / t / "val"), 2, SIZES, seed=10 + ti,
                                         n_labels=2, nc=nc))
    path = root / "data.yaml"
    path.write_text(yaml.safe_dump(data))
    return str(path)


@pytest.mark.parametrize("flags", [["--cache-images", "disk", "--proc-workers", "2"],
                                   ["--augment-device"]])
def test_cli_train_data_routes(data_yaml, tmp_path, monkeypatch, flags):
    from cerberusdet_tpu_torch.manager.run_manager import RunManager

    monkeypatch.setattr(RunManager, "tb_writer", lambda self: None)
    loop = cli_train.main([
        "--data", data_yaml, "--cfg", CFG, "--hyp",
        os.path.join(ROOT, "configs", "hyps", "hyp.cerber-voc_obj365.yaml"),
        "--epochs", "1", "--batch-size", "2", "--imgsz", "64", "--project", str(tmp_path),
        "--name", "exp", "--workers", "2", "--device", "cpu", "--warmup-min-iters", "2",
        "--nosave", *flags])
    for t, ld in loop.train_loaders.items():
        assert ld.dataset._pack is not None
        assert ld.num_workers == (2 if "--proc-workers" in flags else 0)
        assert ld.device_augment == ("--augment-device" in flags)
        assert len(loop.datasets[t]) == 4
        ld.close()
    steps = [s for s in loop.timings]
    assert len(steps) == 2
