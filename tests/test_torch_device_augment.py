"""The port's augmentation on the device (cerberusdet_tpu_torch/data/
device_augment.py and the loader's device side) against the JAX package's
(cerberusdet_tpu/data/device_augment.py), on the CPU at 128 px over 12 seeded
JPEGs, and against the port's own host pipeline.

  * plan_sample: every field equal to JAX's, exactly, over 3 epochs and every
    index, for a hyp with mosaic, mixup, rotation and shear and for the
    paper's voc_obj365 hyp; its labels equal the host items' bit for bit.
  * collate_device: equal to JAX's in the shipped and the resident form.
  * make_augment_fn against JAX's on the same collated plans, per warp route
    (gather, matmul, affine3) and pixel-op variant: at most 2 levels on
    fewer than 1% of pixels (the bound JAX holds between its own routes,
    tests/test_device_augment.py); integer translations bit for bit, and
    bit for bit with the host cv2 path. The resident form equals the
    shipped form bit for bit.
  * The loader: its patched-up blur rows equal the one-sample program; its
    labels equal the disk-cached host loader's; its warp route follows the
    hyp with no fallback to the host; it refuses a dataset without the pack
    and rect batching; close() gives back the residency budget.
  * On a card (marked cuda): the card's augmentation against the CPU's. The
    JAX package is imported inside the tests that use it, so that this one
    runs on a machine without jax: `python -m pytest -m cuda --noconftest
    tests/test_torch_device_augment.py`.
"""

import gc
import os

import cv2
import numpy as np
import pytest
import torch
import yaml

from cerberusdet_tpu_torch.data import device_augment as pda
from cerberusdet_tpu_torch.data import loaders
from cerberusdet_tpu_torch.data.augment import PixelAugment
from cerberusdet_tpu_torch.data.dataset import DetectionDataset
from cerberusdet_tpu_torch.data.loaders import DataLoader, create_dataloader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMGSZ = 128
HYP_FULL = dict(mosaic=1.0, mixup=0.3, degrees=5.0, translate=0.1, scale=0.3, shear=2.0,
                perspective=0.0, scaleup=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4,
                flipud=0.2, fliplr=0.5)
HYP_AA = dict(HYP_FULL, degrees=0.0, shear=0.0)  # axis-aligned: the matmul route
# no rotation, scale or shear: every warp is an integer translation
HYP_INT = dict(HYP_FULL, mixup=0.0, degrees=0.0, translate=0.0, scale=0.0, shear=0.0,
               hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, flipud=0.0, fliplr=0.0)
with open(os.path.join(ROOT, "configs", "hyps", "hyp.cerber-voc_obj365.yaml")) as _f:
    PAPER_HYP = yaml.safe_load(_f)  # degrees 0.299, shear 0.717: the affine3 route
ROUTES = {"gather": {}, "matmul": dict(axis_aligned=True),
          "affine3": dict(shear_pad=pda.required_shear_pad(HYP_FULL, IMGSZ))}
ROUTE_HYP = {"gather": HYP_FULL, "matmul": HYP_AA, "affine3": HYP_FULL}


@pytest.fixture
def one_thread():
    """One intra-op thread: many small CPU ops, several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """12 seeded noise JPEGs of 80-160 px with 1-3 labels each (the JAX
    package's device-augment test set)."""
    root = tmp_path_factory.mktemp("devaug")
    img_dir = root / "images" / "train"
    lb_dir = root / "labels" / "train"
    img_dir.mkdir(parents=True)
    lb_dir.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i in range(12):
        h, w = int(rng.integers(80, 160)), int(rng.integers(80, 160))
        cv2.imwrite(str(img_dir / f"{i:03d}.jpg"), rng.integers(0, 255, (h, w, 3), np.uint8))
        lines = []
        for _ in range(int(rng.integers(1, 4))):
            x, y = rng.uniform(0.3, 0.7, 2)
            bw, bh = rng.uniform(0.15, 0.3, 2)
            lines.append(f"{int(rng.integers(0, 3))} {x:.4f} {y:.4f} {bw:.4f} {bh:.4f}")
        (lb_dir / f"{i:03d}.txt").write_text("\n".join(lines))
    return str(img_dir)


def _dir(path):
    path.mkdir(exist_ok=True)
    return str(path)


def _jda():
    from cerberusdet_tpu.data import device_augment

    return device_augment


def _pair(root, tmp_path, hyp, seed=3, pixel=(0.0, 0.0, 0.0), jax=True):
    """(port dataset, JAX dataset or None) over the same files, hyp and
    seed, each with its packed cache; PixelAugment's probabilities `pixel`
    on both (blur, median, gray: their draws happen whatever the
    probability). cv2 decodes on both sides."""
    kw = dict(imgsz=IMGSZ, augment=True, hyp=hyp, cache_images="disk", seed=seed,
              fast_decode=False)
    ours = DetectionDataset(root, cache_dir=_dir(tmp_path / "port"), **kw)
    ours._pixel_aug = PixelAugment(*pixel)
    if not jax:
        return ours, None
    from cerberusdet_tpu.data.augment import PixelAugment as JaxPixelAugment
    from cerberusdet_tpu.data.dataset import DetectionDataset as JaxDataset

    theirs = JaxDataset(root, cache_dir=_dir(tmp_path / "jax"), **kw)
    theirs._pixel_aug = JaxPixelAugment(*pixel)
    return ours, theirs


def _tensors(batch):
    aug = {k: torch.from_numpy(v) for k, v in batch["aug"].items()}
    return aug, {k: torch.from_numpy(batch[k]) for k in ("tiles", "tile_idx") if k in batch}


def _ours(batch, n_slots, **kw):
    aug, t = _tensors(batch)
    return pda.make_augment_fn(IMGSZ, n_slots, **kw)(t["tiles"], aug).numpy()


def _theirs(batch, n_slots, **kw):
    return np.asarray(_jda().make_augment_fn(IMGSZ, n_slots, **kw)(batch["tiles"], batch["aug"]))


def _within_bound(a, b, what):
    """JAX's bound between its routes: at most 2 levels, on < 1% of pixels.
    Returns (max |diff|, share of pixels that differ)."""
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    worst, share = int(diff.max()), float((diff > 0).mean())
    print(f"{what}: max|diff| {worst}, {100 * share:.4f}% of pixels differ")
    assert worst <= 2 and share < 0.01, (what, worst, share)
    return worst, share


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("hyp", ["full", "paper"])
def test_plan_sample_matches_jax(toy_root, tmp_path, hyp):
    h = {"full": HYP_FULL, "paper": PAPER_HYP}[hyp]
    ours, theirs = _pair(toy_root, tmp_path, h, pixel=(0.1, 0.1, 0.01))
    jda = _jda()
    fields = [f for f in pda.SamplePlan.__dataclass_fields__]
    assert fields == list(jda.SamplePlan.__dataclass_fields__)
    blurred = 0
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            a, b = pda.plan_sample(ours, i), jda.plan_sample(theirs, i)
            for f in fields:
                x, y = getattr(a, f), getattr(b, f)
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype, (f, epoch, i)
                    np.testing.assert_array_equal(x, y, err_msg=f"{f} at {epoch}, {i}")
                else:
                    assert x == y and type(x) is type(y), (f, epoch, i, x, y)
            blurred += a.blurred
    ours.set_epoch(2)
    for i in range(len(ours)):  # the labels of the host pipeline's item
        np.testing.assert_array_equal(pda.plan_sample(ours, i).labels, ours[i][1])
    assert blurred  # the blur and median draws are covered


@pytest.mark.parametrize("as_indices", [False, True])
def test_collate_device_matches_jax(toy_root, tmp_path, as_indices):
    jda = _jda()
    ours, theirs = _pair(toy_root, tmp_path, HYP_FULL, pixel=(0.5, 0.5, 0.3))
    idxs = list(range(8))
    a = pda.collate_device(ours, [pda.plan_sample(ours, i) for i in idxs], 20,
                           as_indices=as_indices)
    b = jda.collate_device(theirs, [jda.plan_sample(theirs, i) for i in idxs], 20,
                           as_indices=as_indices)
    assert sorted(a) == sorted(b) and sorted(a["aug"]) == sorted(b["aug"])
    assert a["pixel_ops"] == b["pixel_ops"] and a["meta"] == b["meta"]
    for k in a:
        if k in ("pixel_ops", "meta"):
            continue
        for name, x in (a[k].items() if k == "aug" else [(k, a[k])]):
            y = b[k][name] if k == "aug" else b[k]
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


# ---------------------------------------------------------------- pixels


@pytest.mark.parametrize("route", list(ROUTES))
def test_augment_matches_jax(toy_root, tmp_path, route):
    """Every sample of every route (mixup, HSV, flips, gray on), the port
    against JAX on one collated batch, and shipped == resident."""
    ours, theirs = _pair(toy_root, tmp_path, ROUTE_HYP[route], seed=21, pixel=(0, 0, 0.2))
    plans = [pda.plan_sample(ours, i) for i in range(len(ours))]
    batch = pda.collate_device(ours, plans, 20)
    got = _ours(batch, 8, **ROUTES[route])
    assert got.shape == (12, IMGSZ, IMGSZ, 3) and got.dtype == np.uint8
    _within_bound(got, _theirs(batch, 8, **ROUTES[route]), f"{route} vs JAX")
    indexed = pda.collate_device(ours, plans, 20, as_indices=True)
    aug, _ = _tensors(indexed)
    pack = torch.from_numpy(np.array(ours._pack[0]))
    res = pda.make_augment_fn(IMGSZ, 8, resident=True, **ROUTES[route])(
        pack, torch.from_numpy(indexed["tile_idx"]), aug).numpy()
    np.testing.assert_array_equal(res, got)


@pytest.mark.parametrize("route", list(ROUTES))
def test_integer_translations_bitwise(toy_root, tmp_path, route):
    """Integer-translation warps: the port, JAX and the host cv2 items agree
    bit for bit on every route."""
    ours, theirs = _pair(toy_root, tmp_path, HYP_INT, seed=22)
    plans = [pda.plan_sample(ours, i) for i in range(len(ours))]
    batch = pda.collate_device(ours, plans, 20)
    kw = dict(ROUTES[route], shear_pad=6) if route == "affine3" else ROUTES[route]
    got = _ours(batch, 4, **kw)
    np.testing.assert_array_equal(got, _theirs(batch, 4, **kw))
    for i in range(len(ours)):
        np.testing.assert_array_equal(got[i], ours[i][0], err_msg=f"sample {i}")


@pytest.mark.parametrize("pixel_ops", [(3, 0), (5, 0), (7, 0), (0, 3), (0, 5), (0, 7), (7, 5)])
def test_pixel_op_variants_match_jax(toy_root, tmp_path, pixel_ops):
    """The one-sample blur / median variants against JAX's on 3 rows (the
    matmul route); with integer translations, median alone is exact and
    equals cv2's host item."""
    ours, _ = _pair(toy_root, tmp_path, HYP_AA, seed=41, pixel=(0, 0, 0.3), jax=False)
    batch = pda.collate_device(ours, [pda.plan_sample(ours, i) for i in range(3)], 20)
    kw = dict(axis_aligned=True, pixel_ops=pixel_ops)
    _within_bound(_ours(batch, 8, **kw), _theirs(batch, 8, **kw), f"pixel_ops {pixel_ops}")
    bk, mk = pixel_ops
    host, _ = _pair(toy_root, tmp_path, HYP_INT, seed=42,
                    pixel=(float(bk > 0), float(mk > 0), 0.0), jax=False)
    plans = [pda.plan_sample(host, i) for i in range(3)]
    batch = pda.collate_device(host, plans, 20)
    for i, p in enumerate(plans):
        assert (p.blur_k > 0) == (bk > 0) and (p.median_k > 0) == (mk > 0)
        row = {k: v[i:i + 1] for k, v in batch["aug"].items()}
        one = pda.make_augment_fn(IMGSZ, 4, axis_aligned=True, pixel_ops=(p.blur_k, p.median_k))(
            torch.from_numpy(batch["tiles"][i:i + 1]),
            {k: torch.from_numpy(v) for k, v in row.items()}).numpy()[0]
        want = host[i][0]
        if not bk:
            np.testing.assert_array_equal(one, want)
        else:  # a blur's sum / k^2 rounds otherwise than cv2's
            assert np.abs(one.astype(int) - want.astype(int)).max() <= 2


# ---------------------------------------------------------------- loader


def _labels(batch):
    return {k: batch[k] for k in ("cls", "prob", "bboxes", "mask")}


def test_loader_patchup_rows_equal_one_sample_program(toy_root, tmp_path):
    """Rows that draw a blur are augmented again by their variant and
    written into the batch: each equals the one-sample program, and the
    other rows the batch program."""
    ds, loader = create_dataloader(toy_root, IMGSZ, 6, hyp=HYP_FULL, augment=True, task="pix",
                                   seed=5, cache_dir=str(tmp_path), augment_device=True,
                                   max_labels=20, device="cpu")
    ds._pixel_aug = PixelAugment(p_blur=0.5, p_median=0.5, p_gray=0.0)
    assert loader._resident and loader.warp_route == "affine3"
    img = next(iter(loader))["img"]
    plans = [pda.plan_sample(ds, i) for i in list(loader.sampler)[:6]]
    indexed = pda.collate_device(ds, plans, 20, as_indices=True)
    aug, t = _tensors(indexed)
    pack = torch.from_numpy(np.array(ds._pack[0]))
    kw = dict(resident=True, shear_pad=loader._affine_pad)
    whole = pda.make_augment_fn(IMGSZ, 8, **kw)(pack, t["tile_idx"], aug)
    ops = {i: (bk, mk) for i, bk, mk in indexed["pixel_ops"]}
    assert 1 <= len(ops) < 6 and len(loader._pixel_fns) == len(set(ops.values()))
    for i in range(6):
        if i in ops:
            fn = pda.make_augment_fn(IMGSZ, 8, pixel_ops=ops[i], **kw)
            want = fn(pack, t["tile_idx"][i:i + 1], {k: v[i:i + 1] for k, v in aug.items()})[0]
        else:
            want = whole[i]
        assert torch.equal(img[i], want), i
    loader.close()


@pytest.mark.parametrize("hyp,route", [("default", "matmul"), ("paper", "affine3"),
                                       ("perspective", "gather")])
def test_loader_labels_equal_host_loader(toy_root, tmp_path, hyp, route):
    """create_dataloader(augment_device=True) over 2 epochs: the labels of
    the disk-cached host loader, images (B, S, S, 3) uint8 on the device;
    the hyp picks the route, and a perspective hyp takes the gather warp
    (no fallback to the host)."""
    h = {"default": HYP_AA, "paper": PAPER_HYP,
         "perspective": dict(HYP_FULL, perspective=0.0005)}[hyp]
    kw = dict(imgsz=IMGSZ, batch_size=4, hyp=h, augment=True, seed=5, max_labels=20,
              num_threads=2)
    _, dev = create_dataloader(toy_root, task="dev", cache_dir=_dir(tmp_path / "d"),
                               augment_device=True, device="cpu", **kw)
    _, host = create_dataloader(toy_root, task="host", cache_dir=_dir(tmp_path / "h"),
                                cache_images="disk", **kw)
    assert dev.device_augment and dev.warp_route == route
    for epoch in range(2):
        dev.set_epoch(epoch)
        host.set_epoch(epoch)
        n = 0
        for a, b in zip(dev, host):
            assert isinstance(a["img"], torch.Tensor) and a["img"].dtype == torch.uint8
            assert a["img"].device.type == "cpu" and tuple(a["img"].shape) == b["img"].shape
            for k, v in _labels(b).items():
                np.testing.assert_array_equal(a[k], v, err_msg=k)
            n += 1
        assert n == len(host) == 3
    dev.close()


def test_refuses_without_pack_and_with_rect(toy_root, tmp_path):
    ds = DetectionDataset(toy_root, imgsz=IMGSZ, augment=True, hyp=HYP_FULL,
                          cache_dir=str(tmp_path), seed=0)
    with pytest.raises(RuntimeError, match="cache_images"):
        pda.plan_sample(ds, 0)
    with pytest.raises(RuntimeError, match="cache_images"):
        DataLoader(ds, 4, device_augment=True, device="cpu")
    with pytest.raises(ValueError, match="rect"):
        create_dataloader(toy_root, IMGSZ, 4, hyp=HYP_FULL, augment=True, rect=True,
                          cache_dir=str(tmp_path), augment_device=True, device="cpu")
    ev = DetectionDataset(toy_root, imgsz=IMGSZ, cache_images="disk", cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="augment=True"):
        pda.plan_sample(ev, 0)
    # an eval loader ignores augment_device, as the JAX package's does
    _, eval_loader = create_dataloader(toy_root, IMGSZ, 4, cache_dir=str(tmp_path),
                                       augment_device=True)
    assert not eval_loader.device_augment


def test_residency_budget_released_by_close(toy_root, tmp_path, monkeypatch):
    kw = dict(imgsz=IMGSZ, batch_size=4, hyp=HYP_AA, augment=True, seed=1,
              cache_dir=str(tmp_path), augment_device=True, device="cpu")
    nbytes = 12 * IMGSZ * IMGSZ * 3
    gc.collect()  # loaders of earlier tests give their share back now, not midway
    start = loaders._RESIDENT_CLAIMED
    monkeypatch.setenv("CERBERUS_DEVICE_PACK_GB", str((start + 1.5 * nbytes) / 1e9))
    _, a = create_dataloader(toy_root, task="a", **kw)
    _, b = create_dataloader(toy_root, task="b", **kw)
    assert a._resident and not b._resident  # the second pack is past the budget
    assert loaders._RESIDENT_CLAIMED == start + nbytes
    shipped = next(iter(b))
    assert "tiles" not in shipped and shipped["img"].shape == (4, IMGSZ, IMGSZ, 3)
    next(iter(a))
    assert a._dev_pack is not None
    a.close()
    assert loaders._RESIDENT_CLAIMED == start and a._dev_pack is None
    _, c = create_dataloader(toy_root, task="c", **kw)
    assert c._resident  # the budget a closed loader gave back
    c.close()
    b.close()
    assert loaders._RESIDENT_CLAIMED == start


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_card_matches_cpu(toy_root, tmp_path, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ours, _ = _pair(toy_root, tmp_path, ROUTE_HYP[route], seed=21, pixel=(0, 0, 0.2), jax=False)
    plans = [pda.plan_sample(ours, i) for i in range(len(ours))]
    batch = pda.collate_device(ours, plans, 20)
    aug, t = _tensors(batch)
    fn = pda.make_augment_fn(IMGSZ, 8, **ROUTES[route])
    card = fn(t["tiles"].cuda(), {k: v.cuda() for k, v in aug.items()}).cpu().numpy()
    _within_bound(card, fn(t["tiles"], aug).numpy(), f"{route}: card vs CPU")
