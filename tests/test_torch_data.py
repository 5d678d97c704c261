"""The port's data pipeline (evaluation side) against the JAX package's.

Labels, the label cache, DetectionDataset items, DataLoader batches, the
samplers, the data-config helpers and the .ckpt.npz files of
cerberusdet_tpu_torch against cerberusdet_tpu on seeded synthetic sets
(numpy + cv2). Tolerance: none. Every array is compared for equality (items
and batches bit for bit, dtypes included)."""

import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

from cerberusdet_tpu.data import labels as jax_labels
from cerberusdet_tpu.data import samplers as jax_samplers
from cerberusdet_tpu.data.dataset import DetectionDataset as JaxDataset
from cerberusdet_tpu.data.dataset import labels_to_class_weights as jax_class_weights
from cerberusdet_tpu.data.loaders import create_dataloader as jax_create_dataloader
from cerberusdet_tpu.manager import checkpoint as jax_ckpt
from cerberusdet_tpu.manager.run_manager import parse_data_config as jax_parse_data_config
from cerberusdet_tpu_torch.data import labels
from cerberusdet_tpu_torch.data.dataset import DetectionDataset, labels_to_class_weights
from cerberusdet_tpu_torch.data.loaders import DataLoader, InfiniteLoader, create_dataloader
from cerberusdet_tpu_torch.data.samplers import BalancedSampler, ShuffleSampler
from cerberusdet_tpu_torch.manager import checkpoint
from cerberusdet_tpu_torch.manager.run_manager import increment_path, parse_data_config
from cerberusdet_tpu_torch.testing import write_val_set
from cerberusdet_tpu_torch.utils.checks import check_dataset

# native (w, h): landscape, portrait, square, wide and tall, so that rect
# batches of 4 take several letterbox shapes
SIZES = [(80, 60), (60, 80), (64, 64), (100, 40), (45, 90), (120, 70)]
XML = """<annotation>
  <size><width>100</width><height>200</height></size>
  <object><name>cat</name>
    <bndbox><xmin>10</xmin><ymin>20</ymin><xmax>50</xmax><ymax>100</ymax></bndbox>
    <minors><item><name>dog</name><votes>1</votes></item>
            <item><name>fox</name><votes>2</votes></item></minors>
  </object>
  <object><name>dog</name>
    <bndbox><xmin>0</xmin><ymin>0</ymin><xmax>100</xmax><ymax>200</ymax></bndbox>
  </object>
</annotation>"""
NAMES = ["cat", "dog", "fox"]


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """14 images with 0-4 labels of 3 classes (one file 6-column, one empty,
    one image without a label file)."""
    root = tmp_path_factory.mktemp("torch_data")
    img_dir = write_val_set(str(root), 14, SIZES, seed=3, n_labels=4, nc=3)
    lb_dir = root / "labels" / "val"
    (lb_dir / "0001.txt").write_text("2 0.7 0.5 0.5 0.2 0.2\n0 1.0 0.25 0.25 0.1 0.3\n")
    (lb_dir / "0002.txt").write_text("")
    (lb_dir / "0003.txt").unlink()
    return img_dir


def _same(a, b, what=""):
    """Nested equality of numpy arrays (dtype included), tuples, lists, dicts."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


# ------------------------------------------------------------------ labels


def test_paths_hash_and_listing_match_jax(val_set, tmp_path):
    files = labels.list_images(val_set)
    assert files == jax_labels.list_images(val_set) and len(files) == 14
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(files[:5]))
    assert labels.list_images(str(lst)) == jax_labels.list_images(str(lst))
    lb = labels.img2label_paths(files)
    assert lb == jax_labels.img2label_paths(files)
    assert labels.img2label_paths(files, ".xml") == jax_labels.img2label_paths(files, ".xml")
    assert labels.get_hash(lb + files) == jax_labels.get_hash(lb + files)
    with pytest.raises(FileNotFoundError):
        labels.list_images(str(tmp_path / "absent"))


@pytest.mark.parametrize("cols", [5, 6])
def test_txt_labels_match_jax(tmp_path, cols):
    f = tmp_path / "a.txt"
    rows = np.random.default_rng(cols).uniform(0.05, 0.95, (4, cols))
    rows[:, 0] = [0, 2, 1, 2]
    f.write_text("\n".join(" ".join(f"{v:.5f}" for v in r) for r in rows))
    _same(labels.parse_txt_label(str(f)), jax_labels.parse_txt_label(str(f)))


@pytest.mark.parametrize("multi,soft", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_xml_labels_match_jax(tmp_path, multi, soft):
    f = tmp_path / "a.xml"
    f.write_text(XML)
    ours = labels.parse_xml_label(str(f), NAMES, multi, soft)
    _same(ours, jax_labels.parse_xml_label(str(f), NAMES, multi, soft))
    assert len(ours) == (4 if multi else 2)


def _write_case(d: Path, case: str):
    """One (image, label) pair of the verify cases in directory d."""
    im = np.random.default_rng(0).integers(0, 256, (40, 50, 3), dtype=np.uint8)
    img, lb = d / "images" / "x.jpg", d / "labels" / "x.txt"
    img.parent.mkdir(parents=True)
    lb.parent.mkdir(parents=True)
    cv2.imwrite(str(img), im)
    text = "0 0.5 0.5 0.2 0.2\n1 0.3 0.3 0.1 0.1\n"
    if case == "not an image":
        img.write_bytes(b"this is not an image")
    elif case == "under 10 pixels":
        cv2.imwrite(str(img), im[:8, :8])
    elif case == "truncated jpeg":
        img.write_bytes(img.read_bytes()[:-2])
    elif case == "jpeg with trailing bytes":  # decodable: restored and saved
        img.write_bytes(img.read_bytes() + b"\0\0")
    elif case == "negative label":
        text = "0 0.5 0.5 -0.2 0.2\n"
    elif case == "out of bounds":
        text = "0 0.5 1.5 0.2 0.2\n"
    elif case == "seven columns":
        text = "0 1 0.5 0.5 0.2 0.2 0.1\n"
    elif case == "duplicates":
        text = text + text
    elif case == "empty":
        text = ""
    if case == "no label file":
        return str(img), str(lb)
    lb.write_text(text)
    return str(img), str(lb)


@pytest.mark.parametrize("case", ["good", "not an image", "under 10 pixels", "truncated jpeg",
                                  "jpeg with trailing bytes", "negative label", "out of bounds",
                                  "seven columns", "duplicates", "empty", "no label file"])
def test_verify_image_label_matches_jax(tmp_path, case):
    """Each package on its own copy (a truncated JPEG is restored in place)."""
    ours = labels.verify_image_label(*_write_case(tmp_path / "port", case))
    ref = jax_labels.verify_image_label(*_write_case(tmp_path / "jax", case))
    assert (ours[0] is None) == (ref[0] is None)
    _same(ours[1:7], ref[1:7], case)
    assert ours[7].replace(str(tmp_path / "port"), str(tmp_path / "jax")) == ref[7], case
    assert ours[6] == (case in ("not an image", "under 10 pixels", "truncated jpeg",
                                "negative label", "out of bounds", "seven columns"))
    if case in ("jpeg with trailing bytes", "duplicates"):
        assert ours[7].startswith("WARNING") and ours[1] is not None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_label_cache_read_across_packages(val_set, tmp_path, writer):
    """A cache written by one package is read, not rebuilt, by the other."""
    files = labels.list_images(val_set)
    lbs = labels.img2label_paths(files)
    path = tmp_path / "t.cache.npy"
    build = {"jax": jax_labels.build_label_cache, "port": labels.build_label_cache}
    first = build[writer](files, lbs, path)
    stamp = path.stat().st_mtime_ns
    other = build["port" if writer == "jax" else "jax"](files, lbs, path)
    assert path.stat().st_mtime_ns == stamp
    _same(other, first)
    assert len(first["results"]) == 14 and first["version"] == jax_labels.CACHE_VERSION


# ----------------------------------------------------------------- dataset

DATASET_CASES = {
    "square": dict(),
    "rect pad 0.5": dict(rect=True, pad=0.5, batch_size=4),
    "rect single_cls": dict(rect=True, pad=0.5, batch_size=3, single_cls=True),
    "ram cache": dict(cache_images="ram"),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_dataset_items_match_jax(val_set, tmp_path, case):
    kw = dict(imgsz=64, task="t", cache_dir=str(tmp_path), **DATASET_CASES[case])
    ours, ref = DetectionDataset(val_set, **kw), JaxDataset(val_set, **kw)
    assert ours.img_files == ref.img_files and len(ours) == 14
    _same(ours.labels, ref.labels)
    _same(ours.shapes, ref.shapes)
    if ours.batch_shapes is None:
        assert ref.batch_shapes is None
    else:
        _same(ours.batch_shapes, ref.batch_shapes)
        assert len({tuple(s) for s in ours.batch_shapes}) > 1
    for i in range(len(ours)):
        _same(ours[i], ref[i], f"{case} item {i}")
    if case == "ram cache":
        assert len(ours._im_cache) == 14
        _same(ours[5], ref[5])  # from the cache
    if "single_cls" in case:
        assert all((lb[:, 0] == 0).all() for lb in ours.labels if len(lb))
    _same(ours.class_histogram(3), ref.class_histogram(3))
    _same(labels_to_class_weights(ours.labels, 3), jax_class_weights(ref.labels, 3))


@pytest.mark.parametrize("rect", [False, True])
def test_loader_batches_match_jax(val_set, tmp_path, rect):
    kw = dict(imgsz=64, batch_size=4, augment=False, rect=rect, pad=0.5,
              task="t", cache_dir=str(tmp_path), max_labels=8, num_threads=2)
    ours = create_dataloader(val_set, **kw)[1]
    ref = jax_create_dataloader(val_set, shuffle=False, **kw)[1]
    a, b = list(ours), list(ref)
    assert len(a) == len(ours) == 4 and sum(len(x["img"]) for x in a) == 14
    _same(a, b)


@pytest.mark.parametrize("threads,prefetch", [(1, 3), (4, 0), (4, 3), (4, 1)])
def test_loader_batches_do_not_depend_on_threads(val_set, tmp_path, threads, prefetch):
    """Decode threads and prefetch change nothing: every batch equals the
    inline one-thread loader's."""
    ds = DetectionDataset(val_set, imgsz=64, rect=True, pad=0.5, batch_size=4, task="t",
                          cache_dir=str(tmp_path))
    ref = list(DataLoader(ds, 4, max_labels=8, drop_last=False, num_threads=1, prefetch=0))
    got = list(DataLoader(ds, 4, max_labels=8, drop_last=False, num_threads=threads,
                          prefetch=prefetch))
    _same(got, ref)


@pytest.mark.parametrize("cv2_threads", [1, 8])
def test_large_image_batches_do_not_depend_on_cv2_threads(tmp_path, cv2_threads):
    """Full-size sources (the INTER_AREA shrink to 640 and the letterbox on
    cv2's own thread pool, inside 8 decode threads) give the batches of one
    inline decode thread, whatever cv2's pool holds: the threaded path needs
    no cv2.setNumThreads, which the JAX package sets only in its worker
    processes."""
    img_dir = write_val_set(str(tmp_path), 6, [(1280, 720), (375, 500), (1920, 1080)], seed=1)
    ds = DetectionDataset(img_dir, imgsz=640, rect=True, pad=0.5, batch_size=2, task="t",
                          cache_dir=str(tmp_path))
    before = cv2.getNumThreads()
    try:
        cv2.setNumThreads(1)
        ref = list(DataLoader(ds, 2, max_labels=4, drop_last=False, num_threads=1, prefetch=0))
        cv2.setNumThreads(cv2_threads)
        got = list(DataLoader(ds, 2, max_labels=4, drop_last=False, num_threads=8, prefetch=3))
    finally:
        cv2.setNumThreads(before)
    _same(got, ref)
    assert {b["img"].shape[1:3] for b in got} == {(384, 672), (672, 512)}


def test_loader_stops_its_worker_when_left_early(val_set, tmp_path):
    """A consumer that leaves after one batch ends the prefetch thread and
    its decode pool."""
    import threading

    ds = DetectionDataset(val_set, imgsz=64, task="t", cache_dir=str(tmp_path))
    before = set(threading.enumerate())
    it = iter(DataLoader(ds, 2, max_labels=8, prefetch=1, num_threads=3))
    next(it)
    it.close()  # runs the generator's finally, which joins the worker
    assert [t for t in threading.enumerate() if t not in before and t.is_alive()] == []


def test_infinite_loader_cycles_epochs(val_set, tmp_path):
    ds = DetectionDataset(val_set, imgsz=64, task="t", cache_dir=str(tmp_path))
    inf = InfiniteLoader(DataLoader(ds, 4, max_labels=8, drop_last=True, prefetch=0))
    assert len(inf) == 3
    batches = [next(inf) for _ in range(4)]
    assert inf.epoch == 1 and ds.epoch == 1
    _same(batches[3]["img"], batches[0]["img"])


@pytest.mark.parametrize("what", ["augment", "fast_decode", "disk cache", "num_workers",
                                  "augment_device", "host sharded over processes"])
def test_training_side_raises(val_set, tmp_path, what, monkeypatch):
    kw = dict(imgsz=64, batch_size=4, task="t", cache_dir=str(tmp_path))
    if what == "host sharded over processes":
        # ported (tests/test_torch_parallel.py): in a group of 2 the loader wraps
        # its sampler in HostShardSampler, and rank 1 takes every other image
        import torch.distributed as dist

        from cerberusdet_tpu_torch.data.samplers import HostShardSampler

        _, one = create_dataloader(val_set, **kw)
        paths = [m["path"] for b in one for m in b["meta"]]
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda: 2)
        monkeypatch.setattr(dist, "get_rank", lambda: 1)
        _, loader = create_dataloader(val_set, **kw)
        assert isinstance(loader.sampler, HostShardSampler)
        assert (loader.sampler.num_hosts, loader.sampler.host_id, loader.sampler.block) == (2, 1, 1)
        assert [m["path"] for b in loader for m in b["meta"]] == paths[1::2]
        return
    # the rest of the training side is ported: each route gives the batches
    # of the plain loader with the same dataset arguments (an eval loader
    # ignores augment_device, as the JAX package's does)
    extra = {"augment": dict(augment=True, num_workers=2),
             "fast_decode": dict(fast_decode=True, cache_images="disk"),
             "disk cache": dict(cache_images="disk"), "num_workers": dict(num_workers=2),
             "augment_device": dict(augment_device=True)}[what]
    plain = {k: v for k, v in extra.items()
             if k in ("augment", "fast_decode")}
    _, loader = create_dataloader(val_set, **kw, **extra)
    _, ref = create_dataloader(val_set, **kw, **plain)
    try:
        assert not loader.device_augment
        for a, b in zip(loader, ref):
            _same({k: v for k, v in a.items() if k != "meta"},
                  {k: v for k, v in b.items() if k != "meta"})
    finally:
        loader.close()


# ---------------------------------------------------------------- samplers


@pytest.mark.parametrize("shuffle,seed,epoch", [(False, 0, 0), (True, 0, 0), (True, 3, 2)])
def test_shuffle_sampler_matches_jax(shuffle, seed, epoch):
    ours, ref = ShuffleSampler(37, shuffle, seed), jax_samplers.ShuffleSampler(37, shuffle, seed)
    ours.set_epoch(epoch)
    ref.set_epoch(epoch)
    assert list(ours) == list(ref) and len(ours) == 37


@pytest.mark.parametrize("mode", ["least_sampled", "random", "cycle"])
def test_balanced_sampler_matches_jax(val_set, tmp_path, mode):
    ds = DetectionDataset(val_set, imgsz=64, task="t", cache_dir=str(tmp_path))
    for epoch in (0, 1):
        ours = BalancedSampler(ds.labels, mode, seed=5)
        ref = jax_samplers.BalancedSampler(ds.labels, mode, seed=5)
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(ours) == list(ref) and len(ours) == 14


# ----------------------------------------------------- configs, run dirs, checkpoints


def _data_yaml(tmp_path, val_set, multi: bool, prefix: bool):
    root = os.path.dirname(os.path.dirname(val_set))
    val = "images/val" if prefix else val_set
    if multi:
        d = {"task_ids": ["a", "b"], "nc": [3, 2], "names": [NAMES, ["p", "q"]],
             "train": [val, val], "val": [val, val]}
    else:
        d = {"nc": 3, "names": NAMES, "train": val, "val": val}
    if prefix:
        d["path"] = root
    p = tmp_path / "data.yaml"
    p.write_text(yaml.safe_dump(d))
    return str(p)


@pytest.mark.parametrize("multi,prefix", [(False, False), (True, False), (True, True)])
def test_parse_data_config_matches_jax(val_set, tmp_path, multi, prefix):
    path = _data_yaml(tmp_path, val_set, multi, prefix)
    for check in (False, True):
        assert parse_data_config(path, check=check) == jax_parse_data_config(path, check=check)


def test_missing_val_path_raises_and_names_it(tmp_path):
    missing = str(tmp_path / "nowhere" / "images")
    with pytest.raises(FileNotFoundError, match="nowhere"):
        check_dataset({"nc": 1, "names": ["x"], "val": missing, "download": "bash get.sh"})
    with pytest.raises(FileNotFoundError, match="nowhere"):
        parse_data_config({"nc": 1, "names": ["x"], "train": missing, "val": missing},
                          check=True)


def test_increment_path(tmp_path):
    base = tmp_path / "exp"
    assert increment_path(base) == base
    base.mkdir()
    assert increment_path(base) == tmp_path / "exp2"
    assert increment_path(base, exist_ok=True) == base


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"b0": {"w": rng.normal(size=(3, 3, 3, 8)).astype(np.float32),
                   "bn": {"scale": rng.normal(size=8).astype(np.float32),
                          "mean": np.zeros(8, np.float32)}},
            "head_a": {"cls0": {"2": {"w_q": rng.integers(-127, 128, (1, 1, 8, 3)).astype(
                np.int8), "s_x": np.array(0.25, np.float32)}}},
            "step": np.array(7, np.int64)}


@pytest.mark.parametrize("direction", ["port writes, JAX reads", "JAX writes, port reads",
                                       "port writes, port reads"])
@pytest.mark.parametrize("half", [True, False])
def test_checkpoint_round_trip(tmp_path, direction, half):
    write = jax_ckpt.save_checkpoint if direction.startswith("JAX") else checkpoint.save_checkpoint
    read = jax_ckpt.load_checkpoint if direction.endswith("JAX reads") else \
        checkpoint.load_checkpoint
    meta = {"cfg": "x.yaml", "task_ids": ["a"], "nc": [3], "names": [NAMES], "epoch": 4,
            "best_fitness": np.float32(0.5)}
    path = tmp_path / "w.ckpt.npz"
    write(path, _tree(0), meta, ema_params=_tree(1), opt_momentum=_tree(2), half=half)
    got = read(path)
    meta["best_fitness"] = 0.5
    assert got["meta"] == meta
    for group, seed in (("params", 0), ("ema", 1), ("opt", 2)):
        want = _tree(seed)
        if half and group != "opt":  # float32 leaves pass through float16
            want = jax_ckpt.unflatten_tree({k: (v.astype(np.float16).astype(np.float32)
                                                 if v.dtype == np.float32 else v)
                                             for k, v in jax_ckpt.flatten_tree(want).items()})
        _same(jax_ckpt.flatten_tree(got[group]), jax_ckpt.flatten_tree(want), group)
    with pytest.raises(ValueError, match="npz"):
        checkpoint.save_checkpoint(tmp_path / "orbax_dir", _tree(0), meta)


def test_label_cache_written_by_the_dataset_is_shared(val_set, tmp_path):
    """Both packages' datasets, pointed at one cache directory, use one
    `{task}.cache.npy`: the second reads what the first wrote."""
    DetectionDataset(val_set, imgsz=64, task="shared", cache_dir=str(tmp_path))
    stamp = (tmp_path / "shared.cache.npy").stat().st_mtime_ns
    JaxDataset(val_set, imgsz=64, task="shared", cache_dir=str(tmp_path))
    assert (tmp_path / "shared.cache.npy").stat().st_mtime_ns == stamp
