"""Label parsing, verification and caching for per-task datasets.

A copy of cerberusdet_tpu/data/labels.py (numpy and PIL only), kept so that the
port imports nothing of the JAX package. Its behaviour follows the reference:
cerberusdet/data/datasets.py:32-103 (path mapping, hashing), :228-246 (npy
cache with hash+version), :545-618 (XML with multi-label votes / soft
labels), :621-690 (verify_image_label: corrupt-image tolerance, 5/6-column
txt labels with a prob column, duplicate removal).

The label cache (`{task}.cache.npy`) has the JAX package's format, version
string and hash, so a cache written by either package is read by the other.

Label rows are [cls, prob, cx, cy, w, h] normalized (the reference's format).
"""

from __future__ import annotations

import hashlib
import os
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageOps

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp"}
CACHE_VERSION = "cerberusdet_tpu-0.1"
LABEL_COLS = 6  # cls prob x y w h


def img2label_paths(img_paths: Sequence[str], label_ext: str = ".txt") -> List[str]:
    """/images/ -> /labels/ sibling path convention (datasets.py:90-103)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + label_ext for p in img_paths]


def get_hash(paths: Sequence[str]) -> str:
    """Size+name hash over a list of files/dirs (datasets.py:32-37)."""
    size = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    h = hashlib.md5(str(size).encode())
    h.update("".join(paths).encode())
    return h.hexdigest()


def exif_size(img: Image.Image) -> Tuple[int, int]:
    """EXIF-corrected (w, h)."""
    s = img.size
    try:
        rotation = dict(img.getexif()).get(274, None)
        if rotation in (6, 8):  # 270 or 90 deg
            s = (s[1], s[0])
    except Exception:
        pass
    return s


def parse_xml_label(lb_file: str, classnames: Sequence[str], as_multi_label: bool,
                    as_soft_label: bool) -> np.ndarray:
    """VOC-style XML with optional `minors` vote lists -> (n, 6) rows."""
    root = ET.parse(lb_file).getroot()
    width = int(root.find("size").find("width").text)
    height = int(root.find("size").find("height").text)
    rows: List[List[float]] = []
    for obj in root.findall("object"):
        bbox = obj.find("bndbox")
        x_min = int(float(bbox.find("xmin").text))
        y_min = int(float(bbox.find("ymin").text))
        x_max = int(float(bbox.find("xmax").text))
        y_max = int(float(bbox.find("ymax").text))
        main_cls = obj.find("name").text
        minors_el = obj.find("minors")
        votes: Dict[str, float] = (
            {x.find("name").text: int(x.find("votes").text) for x in minors_el}
            if minors_el is not None else {}
        )
        # main class implied vote: one more than all minors combined
        if main_cls not in votes:
            votes[main_cls] = sum(votes.values()) + 1
        if as_soft_label:
            total = sum(votes.values())
            votes = {k: v / total for k, v in votes.items()}
        else:
            votes = {k: 1.0 for k in votes}
        if not as_multi_label:
            votes = {k: v for k, v in votes.items() if k == main_cls}
        cx = (x_max + x_min) / 2 / width
        cy = (y_max + y_min) / 2 / height
        w = (x_max - x_min) / width
        h = (y_max - y_min) / height
        for cls, prob in votes.items():
            rows.append([classnames.index(cls), prob, cx, cy, w, h])
    return np.array(rows, dtype=np.float32) if rows else np.zeros((0, LABEL_COLS), np.float32)


def parse_txt_label(lb_file: str) -> np.ndarray:
    """5-col (cls x y w h) or 6-col (cls prob x y w h) text labels."""
    with open(lb_file) as f:
        rows = [x.split() for x in f.read().strip().splitlines() if len(x)]
    if any(len(x) == 5 for x in rows):
        rows = [[x[0], "1.0", *x[1:]] for x in rows]
    elif any(len(x) > LABEL_COLS for x in rows):
        raise ValueError(f"invalid annotation file {lb_file}")
    return (np.array(rows, dtype=np.float32) if rows
            else np.zeros((0, LABEL_COLS), np.float32))


def verify_image_label(im_file: str, lb_file: str, use_xml: bool = False,
                       classnames: Optional[Sequence[str]] = None,
                       as_multi_label: bool = False, as_soft_label: bool = False):
    """Validate one (image, label) pair. Returns
    (im_file, labels (n,6), shape (w,h), nm, nf, ne, nc, msg); corrupt pairs
    return im_file=None with nc=1."""
    nm = nf = ne = nc = 0
    msg = ""
    try:
        im = Image.open(im_file)
        im.verify()
        shape = exif_size(im)
        assert (shape[0] > 9) and (shape[1] > 9), f"image size {shape} < 10 pixels"
        assert im.format.lower() in IMG_FORMATS, f"invalid image format {im.format}"
        if im.format.lower() in ("jpg", "jpeg"):
            with open(im_file, "rb") as f:
                f.seek(-2, 2)
                if f.read() != b"\xff\xd9":  # truncated JPEG: restore
                    ImageOps.exif_transpose(Image.open(im_file)).save(
                        im_file, "JPEG", subsampling=0, quality=100)
                    msg = f"WARNING: {im_file}: corrupt JPEG restored and saved"

        if os.path.isfile(lb_file):
            nf = 1
            if use_xml:
                lb = parse_xml_label(lb_file, classnames or [], as_multi_label, as_soft_label)
            else:
                lb = parse_txt_label(lb_file)
            if len(lb):
                assert lb.shape[1] == LABEL_COLS, f"labels require {LABEL_COLS} columns"
                assert (lb >= 0).all(), "negative labels"
                assert (lb[:, 2:] <= 1).all(), "non-normalized or out-of-bounds coordinates"
                _, i = np.unique(lb, axis=0, return_index=True)
                if len(i) < len(lb):
                    msg = f"WARNING: {im_file}: {len(lb) - len(i)} duplicate labels removed"
                    lb = lb[i]
            else:
                ne = 1
        else:
            nm = 1
            lb = np.zeros((0, LABEL_COLS), np.float32)
        return im_file, lb, shape, nm, nf, ne, nc, msg
    except Exception as e:
        return None, None, None, nm, nf, ne, 1, f"WARNING: ignoring corrupt {im_file}: {e}"


def build_label_cache(img_files: Sequence[str], label_files: Sequence[str],
                      cache_path: Path, use_xml: bool = False,
                      classnames: Optional[Sequence[str]] = None,
                      as_multi_label: bool = False, as_soft_label: bool = False) -> dict:
    """Build or load the {im_file: (labels, shape)} cache with hash+version
    invalidation (datasets.py:228-266)."""
    cache_path = Path(cache_path)
    want_hash = get_hash(list(label_files) + list(img_files))
    if cache_path.exists():
        try:
            cache = np.load(cache_path, allow_pickle=True).item()
            if cache.get("version") == CACHE_VERSION and cache.get("hash") == want_hash:
                return cache
        except Exception:
            pass
    results: Dict[str, tuple] = {}
    counts = np.zeros(4, int)  # nm, nf, ne, nc
    msgs = []
    for im_f, lb_f in zip(img_files, label_files):
        im_file, lb, shape, nm, nf, ne, nc, msg = verify_image_label(
            im_f, lb_f, use_xml, classnames, as_multi_label, as_soft_label)
        counts += (nm, nf, ne, nc)
        if msg:
            msgs.append(msg)
        if im_file is not None:
            results[im_file] = (lb, shape)
    cache = {
        "version": CACHE_VERSION,
        "hash": want_hash,
        "results": results,
        "stats": tuple(int(c) for c in counts),
        "msgs": msgs,
    }
    try:
        np.save(str(cache_path), cache, allow_pickle=True)
        if cache_path.with_suffix(".npy").exists():
            cache_path.with_suffix(".npy").rename(cache_path)
    except Exception:
        pass  # cache dir may be read-only; proceed uncached
    return cache


def list_images(path) -> List[str]:
    """Expand a dir / txt-list / glob into a sorted image file list
    (datasets.py:191-213 semantics)."""
    import glob

    files: List[str] = []
    for p in path if isinstance(path, (list, tuple)) else [path]:
        p = Path(p)
        if p.is_dir():
            files += glob.glob(str(p / "**" / "*.*"), recursive=True)
        elif p.is_file() and p.suffix == ".txt":
            with open(p) as f:
                parent = str(p.parent) + os.sep
                files += [x.strip().replace("./", parent) if x.startswith("./") else x.strip()
                          for x in f.read().strip().splitlines()]
        elif p.is_file():
            files.append(str(p))
        else:
            raise FileNotFoundError(f"{p} does not exist")
    return sorted(x for x in files if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS)
