"""The port's plots (cerberusdet_tpu_torch/utils/plots.py) against the JAX
package's (cerberusdet_tpu/utils/plots.py) on the CPU, from the same
numpy-seeded data: the mosaics pixel for pixel, each in its package's
layout (the port's images an NCHW tensor, JAX's NHWC numpy), uint8 and
float; the matplotlib figures as decoded PNG pixels; and without matplotlib
the mosaics are still written while each figure is skipped and named once."""

import sys

import cv2
import numpy as np
import pytest
import torch

from cerberusdet_tpu.utils import plots as jax_plots
from cerberusdet_tpu_torch.utils import plots


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")

NAMES = ["cat", "dog", "bird"]


def _batch(seed: int, b: int = 5, h: int = 48, w: int = 64, m: int = 6):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    xy = rng.uniform(0.2, 0.8, (b, m, 2))
    wh = rng.uniform(0.05, 0.3, (b, m, 2))
    return {"img": img, "bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
            "cls": rng.integers(0, len(NAMES), (b, m)).astype(np.int32),
            "mask": rng.random((b, m)) < 0.7}


def _port(batch, img=None):
    """The port's layout: the images an NCHW tensor, the labels tensors."""
    img = torch.from_numpy(batch["img"] if img is None else img).permute(0, 3, 1, 2)
    return {"img": img, **{k: torch.from_numpy(batch[k]) for k in ("bboxes", "cls", "mask")}}


def _pixels(path):
    im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert im is not None and im.size, path
    return im


def _dets(seed: int, b: int, h: int, w: int, k: int = 7):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, [w * 0.7, h * 0.7], (b, k, 2))
    wh = rng.uniform(4, 20, (b, k, 2))
    conf = rng.uniform(0.05, 1.0, (b, k, 1))
    cls = rng.integers(0, 4, (b, k, 1))  # class 3 has no name: drawn as "3"
    dets = np.concatenate([xy, xy + wh, conf, cls], -1).astype(np.float32)
    return dets, rng.integers(0, k + 1, b).astype(np.int32)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_plot_images_equals_jax(tmp_path, kind):
    batch = _batch(0)
    img = batch["img"]
    if kind == "float":  # float in [0, 1]: both scale by 255 and truncate
        img = (img.astype(np.float32) + 0.5) / 255.0
    jax_plots.plot_images({**batch, "img": img}, tmp_path / "j.png", names=NAMES)
    plots.plot_images(_port(batch, img), tmp_path / "p.png", names=NAMES)
    np.testing.assert_array_equal(_pixels(tmp_path / "p.png"), _pixels(tmp_path / "j.png"))


def test_plot_images_caps_and_shrinks(tmp_path):
    """max_images keeps the first images; max_size shrinks the grid, and
    without names the classes are drawn as numbers."""
    batch = _batch(1, b=7, h=40, w=40)
    jax_plots.plot_images(batch, tmp_path / "j.jpg", max_images=5, max_size=64)
    plots.plot_images(_port(batch), tmp_path / "p.jpg", max_images=5, max_size=64)
    a, b = _pixels(tmp_path / "p.jpg"), _pixels(tmp_path / "j.jpg")
    assert a.shape == (64, 64, 3)
    np.testing.assert_array_equal(a, b)


def test_plot_val_images_equals_jax(tmp_path):
    batch = _batch(2)
    dets, counts = _dets(3, 5, 48, 64)
    jax_plots.plot_val_images(batch, dets, counts, tmp_path / "j.jpg", names=NAMES)
    plots.plot_val_images(_port(batch), torch.from_numpy(dets), torch.from_numpy(counts),
                          tmp_path / "p.jpg", names=NAMES)
    np.testing.assert_array_equal(_pixels(tmp_path / "p.jpg"), _pixels(tmp_path / "j.jpg"))


def _curves(seed: int, nc: int):
    rng = np.random.default_rng(seed)
    px = np.linspace(0, 1, 1000)
    py = np.sort(rng.random((nc, 1000)), 1)[:, ::-1]
    ap = rng.random((nc, 10))
    return px, py, ap


@pytest.mark.parametrize("nc", [3, 25])  # named curves, and grey ones past 20 classes
def test_pr_and_mc_curves_equal_jax(tmp_path, nc):
    px, py, ap = _curves(4, nc)
    names = [f"c{i}" for i in range(nc)]
    for pkg, tag in ((jax_plots, "j"), (plots, "p")):
        pkg.plot_pr_curve(px, list(py), ap, tmp_path / f"{tag}_pr.png", names)
        pkg.plot_mc_curve(px, py, tmp_path / f"{tag}_mc.png", names, ylabel="F1")
    for what in ("pr", "mc"):
        np.testing.assert_array_equal(_pixels(tmp_path / f"p_{what}.png"),
                                      _pixels(tmp_path / f"j_{what}.png"))


def test_figures_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    labels = [np.concatenate([rng.integers(0, 3, (n, 1)), np.ones((n, 1)),
                              rng.uniform(0.1, 0.9, (n, 4))], 1).astype(np.float32)
              for n in (4, 0, 7)]
    matrix = rng.integers(0, 20, (4, 4)).astype(np.float64)
    feats = rng.standard_normal((2, 11, 9, 13)).astype(np.float32)
    for pkg, tag in ((jax_plots, "j"), (plots, "p")):
        d = tmp_path / tag
        d.mkdir()
        pkg.plot_labels(labels, NAMES, d)
        pkg.plot_lr_scheduler(lambda e: 1 - 0.09 * e, 0.01, 10, d)
        pkg.plot_confusion_matrix(matrix, NAMES, d / "confusion.png")
        x = feats.transpose(0, 2, 3, 1) if pkg is jax_plots else torch.from_numpy(feats)
        pkg.feature_visualization(x, "stage3", d, n=10)
    for name in ("labels.png", "LR.png", "confusion.png", "features_stage3.png"):
        np.testing.assert_array_equal(_pixels(tmp_path / "p" / name),
                                      _pixels(tmp_path / "j" / name))


def test_without_matplotlib_mosaics_still_drawn(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    monkeypatch.setattr(plots, "SKIPPED", set())
    batch = _batch(6)
    dets, counts = _dets(7, 5, 48, 64)
    px, py, ap = _curves(8, 3)
    for _ in range(2):
        plots.plot_images(_port(batch), tmp_path / "train.png", names=NAMES)
        plots.plot_val_images(_port(batch), dets, counts, tmp_path / "pred.jpg", names=NAMES)
        plots.plot_pr_curve(px, list(py), ap, tmp_path / "t_PR_curve.png", NAMES)
        plots.plot_confusion_matrix(np.eye(4), NAMES, tmp_path / "t_confusion_matrix.png")
        plots.plot_labels([np.ones((2, 6))], NAMES, tmp_path)
    assert _pixels(tmp_path / "train.png").shape == (3 * 48, 3 * 64, 3)
    assert _pixels(tmp_path / "pred.jpg").shape == (3 * 48, 3 * 64, 3)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["pred.jpg", "train.png"]
    err = capsys.readouterr().err.splitlines()
    assert plots.SKIPPED == {"t_PR_curve.png", "t_confusion_matrix.png", "labels.png"}
    assert len(err) == 3 and all("matplotlib is not installed" in e for e in err)
