"""The port's augmentation and the training side of its data pipeline
against the JAX package's, and its native JPEG decoder.

  * data/augment.py: every function on seeded images and labels with the
    same random.Random state on both sides, bit for bit (arrays, dtypes and
    the rng state after the call).
  * DetectionDataset(augment=True) items at several (seed, epoch, index),
    with mosaic and mixup on, with the native scaled decoder (fast_decode)
    on and off, with single_cls and the RAM cache: bit for bit.
  * Training loaders (create_dataloader(augment=True)): shuffled and
    class-balanced batches bit for bit with the JAX package's, and the same
    under 1-8 decode threads and prefetch 0-3; InfiniteLoader across epochs.
  * native/: the first decode of a run builds the decoder while the other
    decode threads wait, so two identically seeded 8-thread loaders give
    equal batches even when the first of them builds it (the JAX package's
    binding sends those threads to cv2 while it builds).
Tolerance: none; every comparison is equality."""

import os
import random
import sys
import threading

import cv2
import numpy as np
import pytest
import torch
import yaml

from cerberusdet_tpu import native as jax_native
from cerberusdet_tpu.data import augment as jaug
from cerberusdet_tpu.data.dataset import DetectionDataset as JaxDataset
from cerberusdet_tpu.data.dataset import mosaic_layout as jax_mosaic_layout
from cerberusdet_tpu.data.loaders import InfiniteLoader as JaxInfinite
from cerberusdet_tpu.data.loaders import create_dataloader as jax_create_dataloader
from cerberusdet_tpu.utils import hyp as jax_hyp
from cerberusdet_tpu_torch import native
from cerberusdet_tpu_torch.data import augment as paug
from cerberusdet_tpu_torch.data.dataset import DetectionDataset, mosaic_layout
from cerberusdet_tpu_torch.data.loaders import DataLoader, InfiniteLoader, create_dataloader
from cerberusdet_tpu_torch.data.samplers import ShuffleSampler
from cerberusdet_tpu_torch.testing import write_val_set
from cerberusdet_tpu_torch.utils import hyp as port_hyp
from cerberusdet_tpu_torch.utils.seeds import init_seeds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "configs", "hyps", "hyp.cerber-voc_obj365.yaml")) as _f:
    PAPER_HYP = yaml.safe_load(_f)  # mosaic 1.0, mixup 0.285
# every augmentation on, often: mosaic or not, mixup, flips, blur draws
AUG_HYP = dict(mosaic=0.7, mixup=0.5, degrees=10.0, translate=0.2, scale=0.5, shear=2.0,
               perspective=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, flipud=0.3, fliplr=0.5)
# native (w, h): small sources and large ones that the native decoder scales
# in the DCT (1280 x 720 at imgsz 64: 1/8)
SIZES = [(80, 60), (60, 80), (1280, 720), (100, 40), (640, 480), (120, 70)]


def _same(a, b, what=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    """12 seeded JPEGs with 0-5 labels of 3 classes (one without labels)."""
    root = tmp_path_factory.mktemp("torch_augment")
    img_dir = write_val_set(str(root), 12, SIZES, seed=5, n_labels=5, nc=3)
    (root / "labels" / "val" / "0004.txt").write_text("")
    # the JAX package's decoder, built once here before any threaded use
    ours = native.default_decoder().imread(os.path.join(img_dir, "0000.jpg"), 64)
    assert jax_native.available() == (ours is not None)
    return img_dir


def _image(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    im = cv2.resize(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8), (w, h),
                    interpolation=cv2.INTER_CUBIC)
    return im


def _targets(seed, n=6, size=64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(2, size * 0.4, (n, 2))
    return np.concatenate([rng.integers(0, 3, (n, 1)), np.ones((n, 1)), xy, xy + wh],
                          1).astype(np.float32)


def _both(fn_name, seed, *args, **kw):
    """Call fn_name of both modules with equal rng states; returns both
    results and both rng states afterwards."""
    out = []
    for mod in (paug, jaug):
        rng = random.Random(seed)
        args_c = [a.copy() if isinstance(a, np.ndarray) else a for a in args]
        out.append((getattr(mod, fn_name)(*args_c, rng=rng, **kw), rng.getstate()))
    return out


# ---------------------------------------------------------------- augment


@pytest.mark.parametrize("seed", range(6))
def test_pixel_augment_matches_jax(seed):
    ours, ref = [], []
    for mod, out in ((paug, ours), (jaug, ref)):
        aug = mod.PixelAugment(p_blur=0.5, p_median=0.5, p_gray=0.5)
        rng = random.Random(seed)
        out.append((aug(_image(seed), rng), rng.getstate()))
    _same(ours[0][0], ref[0][0])
    assert ours[0][1] == ref[0][1]


@pytest.mark.parametrize("gains", [(0.015, 0.7, 0.4), (0.0, 0.0, 0.0), (0.5, 0.5, 0.5)])
def test_augment_hsv_matches_jax(gains):
    (a, sa), (b, sb) = _both("augment_hsv", 3, _image(1), *gains)
    _same(a, b)
    assert sa == sb


@pytest.mark.parametrize("seed", range(3))
def test_box_candidates_and_flips_match_jax(seed):
    t = _targets(seed)
    box1, box2 = t[:, 2:6].T * 1.3, (t[:, 2:6] * 0.9).T
    box2[:, 0] = box2[:, 2]  # one zero-width box
    _same(paug.box_candidates(box1, box2), jaug.box_candidates(box1, box2))
    xywhn = np.random.default_rng(seed).uniform(0, 1, (5, 4)).astype(np.float32)
    for fn in ("flip_lr", "flip_ud"):
        im_p, b_p = getattr(paug, fn)(_image(seed), xywhn.copy())
        im_j, b_j = getattr(jaug, fn)(_image(seed), xywhn.copy())
        _same(np.ascontiguousarray(im_p), np.ascontiguousarray(im_j))
        _same(b_p, b_j)
    assert len(paug.flip_lr(_image(0), np.zeros((0, 4), np.float32))[1]) == 0


@pytest.mark.parametrize("scaleup,perspective,border", [
    (0.0, 0.0, (0, 0)), (0.5, 0.0, (-32, -32)), (0.0, 0.001, (0, 0)), (1.0, 0.0, (-32, -32))])
def test_perspective_matrix_and_warp_match_jax(scaleup, perspective, border):
    kw = dict(degrees=10.0, translate=0.2, scale=0.5, shear=2.0, perspective=perspective,
              border=border, scaleup=scaleup)
    for seed in range(4):
        (mp, sp), (mj, sj) = _both("build_perspective_matrix", seed, (64, 64), **kw)
        _same(mp, mj)
        assert sp == sj
        M, s, w, h = mp
        t = _targets(seed)
        _same(paug.warp_targets(t.copy(), M, s, w, h, perspective),
              jaug.warp_targets(t.copy(), M, s, w, h, perspective))
        (rp, sp), (rj, sj) = _both("random_perspective", seed, _image(seed, 64, 64), t, **kw)
        _same(rp, rj)
        assert sp == sj
    assert len(paug.warp_targets(np.zeros((0, 6), np.float32), M, s, w, h)) == 0


@pytest.mark.parametrize("seed", range(3))
def test_mixup_and_mosaic_layout_match_jax(seed):
    a, b = _image(seed, 64, 64), _image(seed + 10, 64, 64)
    (mp, sp), (mj, sj) = _both("mixup", seed, a, _targets(seed), b, _targets(seed + 1))
    _same(mp, mj)
    assert sp == sj
    rng = np.random.default_rng(seed)
    dims = [tuple(int(v) for v in rng.integers(20, 70, 2)) for _ in range(4)]
    yc, xc = (int(v) for v in rng.integers(16, 112, 2))
    assert mosaic_layout(64, yc, xc, dims) == jax_mosaic_layout(64, yc, xc, dims)


def test_hyp_addressing_matches_jax():
    hyp = {"lr0": 0.01, "box": [7.5, 5.0], "voc_cls": 0.3, "cls": [0.5, 0.6], "mosaic": 1.0}
    for ti, task in enumerate(["voc", "animals"]):
        assert port_hyp.task_hyp_view(hyp, ti, task) == jax_hyp.task_hyp_view(hyp, ti, task)
        for name in ("lr0", "box", "cls"):
            assert (port_hyp.get_hyperparameter(hyp, name, ti, task)
                    == jax_hyp.get_hyperparameter(hyp, name, ti, task))
    a, b = yaml.safe_load(yaml.safe_dump(hyp)), yaml.safe_load(yaml.safe_dump(hyp))
    port_hyp.set_hyperparameter(a, "box", 1.0, 1, "animals")
    port_hyp.set_hyperparameter(a, "cls", 9.0, 0, "voc")
    jax_hyp.set_hyperparameter(b, "box", 1.0, 1, "animals")
    jax_hyp.set_hyperparameter(b, "cls", 9.0, 0, "voc")
    assert a == b
    with pytest.raises(ValueError):
        port_hyp.get_hyperparameter(hyp, "box")
    with pytest.raises(KeyError):
        port_hyp.get_hyperparameter(hyp, "absent")
    g = init_seeds(11)
    x = (random.random(), np.random.rand(), float(torch.rand(1)))
    assert int(g.initial_seed()) == 11
    init_seeds(11)
    assert x == (random.random(), np.random.rand(), float(torch.rand(1)))


# ---------------------------------------------------------------- dataset

ITEM_CASES = {
    "mosaic and mixup, fast_decode": dict(hyp=AUG_HYP, fast_decode=True),
    "mosaic and mixup, cv2 decode": dict(hyp=AUG_HYP, fast_decode=False),
    "the paper's hyps": dict(hyp={k: v for k, v in PAPER_HYP.items()
                                  if not isinstance(v, list)}),
    "no mosaic: letterbox and warp, single_cls": dict(hyp={**AUG_HYP, "mosaic": 0.0},
                                                       single_cls=True),
    "RAM cache": dict(hyp=AUG_HYP, cache_images="ram"),
}


@pytest.mark.parametrize("case", sorted(ITEM_CASES))
def test_augmented_items_match_jax(train_set, tmp_path, case):
    for seed in (0, 7):
        kw = dict(imgsz=64, augment=True, task="t", cache_dir=str(tmp_path), seed=seed,
                  **ITEM_CASES[case])
        ours, ref = DetectionDataset(train_set, **kw), JaxDataset(train_set, **kw)
        assert ours.fast_decode == ref.fast_decode
        for epoch in (0, 3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            for i in range(len(ours)):
                _same(ours[i], ref[i], f"{case} seed {seed} epoch {epoch} item {i}")
        if "single_cls" in case:
            assert all((lb[:, 0] == 0).all() for lb in ours.labels if len(lb))


def test_epoch_and_seed_change_the_draws(train_set, tmp_path):
    ds = DetectionDataset(train_set, imgsz=64, augment=True, hyp=AUG_HYP, seed=7, task="t",
                          cache_dir=str(tmp_path))
    a = ds[0][0]
    ds.set_epoch(1)
    assert not np.array_equal(a, ds[0][0])
    ds.set_epoch(0)
    np.testing.assert_array_equal(a, ds[0][0])
    other = DetectionDataset(train_set, imgsz=64, augment=True, hyp=AUG_HYP, seed=8,
                             task="t", cache_dir=str(tmp_path))
    assert not np.array_equal(a, other[0][0])


def test_native_decode_differs_from_cv2_on_large_sources(train_set, tmp_path):
    """Why the decoder must be one per run: on a source the DCT scales, the
    native and the cv2 decode give other pixels."""
    kw = dict(imgsz=64, augment=True, hyp={**AUG_HYP, "mosaic": 0.0}, task="t",
              cache_dir=str(tmp_path))
    fast = DetectionDataset(train_set, fast_decode=True, **kw)
    full = DetectionDataset(train_set, fast_decode=False, **kw)
    large = [i for i, f in enumerate(fast.img_files) if cv2.imread(f).shape[1] >= 640]
    assert large
    assert any(not np.array_equal(fast.load_image(i)[0], full.load_image(i)[0]) for i in large)


# ---------------------------------------------------------------- loaders


def _no_meta(batches):
    return [{k: v for k, v in b.items() if k != "meta"} for b in batches]


@pytest.mark.parametrize("balanced", [False, True])
def test_training_batches_match_jax(train_set, tmp_path, balanced):
    kw = dict(imgsz=64, batch_size=4, hyp=AUG_HYP, augment=True, balanced_sampler=balanced,
              task="t", seed=3, cache_dir=str(tmp_path), max_labels=16, num_threads=4)
    (ds, ours), (_, ref) = create_dataloader(train_set, **kw), jax_create_dataloader(
        train_set, host_sharded=False, **kw)
    assert type(ours.sampler).__name__ == ("BalancedSampler" if balanced else "ShuffleSampler")
    assert len(ours) == len(ref) == 3 and ours.drop_last
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        _same(list(ours), list(ref), f"epoch {epoch}")


@pytest.mark.parametrize("threads,prefetch", [(1, 0), (2, 1), (8, 3), (8, 0)])
def test_training_batches_do_not_depend_on_threads(train_set, tmp_path, threads, prefetch):
    def loader(n, p):
        ds = DetectionDataset(train_set, imgsz=64, augment=True, hyp=AUG_HYP, seed=7,
                              task="t", cache_dir=str(tmp_path))
        return DataLoader(ds, 4, ShuffleSampler(len(ds), seed=7), max_labels=16,
                          num_threads=n, prefetch=p)

    ref = _no_meta(loader(1, 0))
    _same(_no_meta(loader(threads, prefetch)), ref)
    assert len(ref) == 3


def test_infinite_loader_moves_the_epoch(train_set, tmp_path):
    _, loader = create_dataloader(train_set, 64, 4, hyp=AUG_HYP, augment=True, task="t",
                                  seed=1, cache_dir=str(tmp_path), max_labels=16)
    _, ref = jax_create_dataloader(train_set, 64, 4, hyp=AUG_HYP, augment=True, task="t",
                                   seed=1, cache_dir=str(tmp_path), max_labels=16,
                                   host_sharded=False)
    ours, theirs = InfiniteLoader(loader, epoch=2), JaxInfinite(ref, epoch=2)
    got = _no_meta([next(ours) for _ in range(5)])
    _same(got, _no_meta([next(theirs) for _ in range(5)]))
    assert ours.epoch == 3 and loader.dataset.epoch == 3


@pytest.mark.parametrize("what", ["process pool", "disk cache", "device augmentation"])
def test_training_side_left_out_raises(train_set, tmp_path, what):
    """The routes that raised until the pool, the pack and the device
    augmentation were ported: each now gives the JAX package's training
    loader's first batch (tests/test_torch_loaders.py and
    tests/test_torch_device_augment.py hold them in full)."""
    kw = dict(imgsz=64, batch_size=4, hyp=AUG_HYP, augment=True, task="t", seed=2,
              host_sharded=False)
    extra = {"process pool": dict(num_workers=2), "disk cache": dict(cache_images="disk"),
             "device augmentation": dict(augment_device=True)}[what]
    ours_dir, ref_dir = tmp_path / "port", tmp_path / "jax"
    ours_dir.mkdir()
    ref_dir.mkdir()
    _, loader = create_dataloader(train_set, **kw, **extra, cache_dir=str(ours_dir),
                                  **({"device": "cpu"} if extra.get("augment_device") else {}))
    _, ref = jax_create_dataloader(train_set, **kw, **extra, cache_dir=str(ref_dir))
    try:
        got, want = next(iter(loader)), next(iter(ref))
        keys = ["cls", "prob", "bboxes", "mask"]
        if what != "device augmentation":  # the device's pixels are within a bound
            keys.append("img")
        _same({k: got[k] for k in keys}, {k: np.asarray(want[k]) for k in keys})
        assert tuple(got["img"].shape) == np.asarray(want["img"]).shape
    finally:
        loader.close()
        ref.close()


# ---------------------------------------------------------------- native


@pytest.mark.parametrize("repeat", range(4))
def test_first_decode_builds_once_and_batches_repeat(train_set, tmp_path, monkeypatch,
                                                     capfd, repeat):
    """A fresh build directory: the first of 8 concurrent decodes builds the
    library while the others wait, so the first loader's batches (decoded
    while it built) equal a second loader's (decoded after)."""
    decoder = native.JpegDecoder(tmp_path / "build")
    monkeypatch.setattr(native, "_DEFAULT", decoder)

    def batches():
        _, loader = create_dataloader(
            train_set, 64, 4, hyp={**AUG_HYP, "mosaic": 1.0}, augment=True, task="t",
            seed=repeat, cache_dir=str(tmp_path), max_labels=16, num_threads=8)
        return _no_meta(loader)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the decode threads finely
    try:
        first = batches()
    finally:
        sys.setswitchinterval(switch)
    _same(batches(), first)
    # native wherever g++ and libjpeg's headers are (train_set's fixture holds
    # that the JAX package's decoder agrees)
    assert decoder.name == ("native" if jax_native.available() else "cv2")
    assert len(list((tmp_path / "build").glob("*.so"))) == (decoder.name == "native")
    assert capfd.readouterr().err.count("cerberusdet_tpu_torch.native: JPEG decode by") == 1


def test_decoder_waits_for_the_build(tmp_path, monkeypatch):
    """Callers that arrive while the build runs wait for it and see its
    library: none returns before the build has ended."""
    decoder = native.JpegDecoder(tmp_path / "build")
    started, release = threading.Event(), threading.Event()
    real = decoder._load

    def slow_load():
        started.set()
        assert release.wait(10)
        return real()

    monkeypatch.setattr(decoder, "_load", slow_load)
    results = []
    threads = [threading.Thread(target=lambda: results.append(decoder.lib()))
               for _ in range(8)]
    threads[0].start()
    assert started.wait(10)
    for t in threads[1:]:
        t.start()
    assert results == []  # all wait on the lock
    release.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert len(results) == 8 and len({id(r) for r in results}) == 1
    assert (results[0] is not None) == jax_native.available()


def test_decoder_refuses_what_is_not_a_clean_jpeg(tmp_path, train_set):
    png = tmp_path / "x.png"
    cv2.imwrite(str(png), _image(0))
    assert native.imread_scaled(str(png), 64) is None
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 not a jpeg")
    assert native.imread_scaled(str(bad), 64) is None
    assert native.default_decoder().decode(b"xx", 64) is None
    im = native.imread_scaled(os.path.join(train_set, "0002.jpg"), 64)
    if jax_native.available():
        assert im is not None and im[1] == (720, 1280) and max(im[0].shape[:2]) >= 64
