"""The port's detect entry point (cli/detect.py) and visualizer
(infer/visualizer.py) against the JAX package's (root detect.py,
cerberusdet_tpu/infer/visualizer.py), on the CPU at yolov8n_2task, 64 px.

  * CerberusVisualizer.draw_detections: pixel-identical images on the same
    detection lists (labels merged for identical boxes, every hide_* switch,
    auto and fixed line thickness).
  * cli.detect.main on a seeded folder writes the same annotated file names
    and crops (crops/<label>/<stem>_<j>.jpg) as root detect.main on the same
    .ckpt.npz, in float32 on both sides. Detections are matched image by
    image: the same count, task, label and label_name, score within 1e-3
    absolute and boxes within 1 px. The device letterboxes agree to float32
    rounding (~3e-7), which the float32 forward of the seeded net amplifies:
    the scores differed by up to 2.5e-4 on these images, the boxes by 0 px,
    and the lowest score kept is 0.31, far from the threshold.
  * --int8 deep and .pt weights with --cfg/--data run; a .pt without them
    exits with the JAX package's message.
  * parse_opt: the root CLI's flags and defaults, flag by flag, except the
    documented --device for --platform and --compile-cache.
"""

import os
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from cerberusdet_tpu.infer.inference import CerberusDetInference as JaxInference
from cerberusdet_tpu.infer.visualizer import CerberusVisualizer as JaxVisualizer
from cerberusdet_tpu_torch.cli import detect as cli
from cerberusdet_tpu_torch.infer import CerberusDetInference, CerberusVisualizer
from cerberusdet_tpu_torch.manager.checkpoint import save_checkpoint
from cerberusdet_tpu_torch.manager.weights import export_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.testing import calibrate_bn, write_val_set
from cerberusdet_tpu_torch.tools import export_to_pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # the JAX package's detect.py at the repository root
import detect as jax_cli  # noqa: E402

CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["a", "b"], [3, 2]
NAMES = [["cat", "dog", "bird"], ["car", "big truck"]]
SIZES = [(96, 72), (64, 64), (50, 80)]
CONF = "0.2"

DETS = [
    {"box": [10, 12, 60, 70], "score": 0.91, "label": 0, "label_name": "cat", "task": "a"},
    {"box": [10, 12, 60, 70], "score": 0.55, "label": 4, "label_name": "big truck",
     "task": "b"},
    {"box": [0, 0, 30, 9], "score": 0.402, "label": 2, "label_name": "bird", "task": "a"},
    {"box": [70, 40, 119, 95], "score": 0.3, "label": 3, "label_name": "car", "task": "b"},
]


@pytest.mark.parametrize("kw,lw", [({}, 0), ({"hide_task": False}, 0),
                                   ({"hide_conf": True, "hide_task": False}, 2),
                                   ({"hide_labels": True}, 0), ({}, 5)])
def test_visualizer_pixel_identical(kw, lw):
    img = np.random.default_rng(0).integers(0, 256, (100, 120, 3), dtype=np.uint8)
    ours = CerberusVisualizer(line_thickness=lw).draw_detections(img, DETS, **kw)
    ref = JaxVisualizer(line_thickness=lw).draw_detections(img, DETS, **kw)
    np.testing.assert_array_equal(ours, ref)
    assert not np.array_equal(ours, img)  # something was drawn


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A seeded yolov8n_2task (BatchNorm statistics from a batch) as a
    .ckpt.npz and a .pt, a folder of seeded JPEGs, and a data yaml."""
    root = tmp_path_factory.mktemp("detect")
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(0)
    calibrate_bn(model, torch.from_numpy(
        np.random.default_rng(2).uniform(0, 1, (4, 3, 64, 64)).astype(np.float32)))
    ckpt = str(root / "w.ckpt.npz")
    save_checkpoint(ckpt, export_jax_params(model), {
        "cfg": CFG, "task_ids": TASKS, "nc": NCS, "names": NAMES}, half=False)
    pt = str(root / "w.pt")
    export_to_pt.main(["--weights", ckpt, "--out", pt])
    src = write_val_set(root / "src", 6, SIZES, seed=4)
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"task_ids": TASKS, "nc": NCS, "names": NAMES,
                                    "train": [src, src], "val": [src, src]}))
    return ckpt, pt, src, str(data), root


def _recorded(monkeypatch, cls):
    """Record every predict's results of the class `cls`."""
    out = []
    orig = cls.predict

    def predict(self, *a, **k):
        res = orig(self, *a, **k)
        out.append(res[0])
        return res

    monkeypatch.setattr(cls, "predict", predict)
    return out


def _files(d):
    return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*.jpg"))


def _matched(ours, ref):
    assert len(ours) == len(ref)
    for ro, rr in zip(ours, ref):
        assert len(ro) == len(rr), (ro, rr)
        for o, r in zip(ro, rr):
            assert (o["task"], o["label"], o["label_name"]) == \
                (r["task"], r["label"], r["label_name"]), (o, r)
            assert abs(o["score"] - r["score"]) <= 1e-3, (o, r)
            assert max(abs(a - b) for a, b in zip(o["box"], r["box"])) <= 1, (o, r)


def test_detect_matches_jax(case, tmp_path, monkeypatch):
    ckpt, _, src, _, _ = case
    args = ["--weights", ckpt, "--source", src, "--imgsz", "64", "--conf-thres", CONF,
            "--save-crop", "--hide-task", "--name", "exp"]
    ours = _recorded(monkeypatch, CerberusDetInference)
    ref = _recorded(monkeypatch, JaxInference)
    a = cli.main(args + ["--device", "cpu", "--project", str(tmp_path / "port")])
    b = jax_cli.main(args + ["--project", str(tmp_path / "jax")])
    assert len(ours) == len(ref) == 6
    _matched(ours, ref)
    assert sum(map(len, ours)) > 0
    assert _files(a) == _files(b)
    assert sum(f.startswith("crops") for f in _files(a)) > 0
    # every annotated file is the visualizer's drawing of the image's detections
    vis = CerberusVisualizer(line_thickness=0)
    for (path, im0), dets in zip(cli.iter_images(src), ours):
        want = cv2.imencode(".jpg", vis.draw_detections(im0, dets))[1]
        assert np.array_equal(want, np.fromfile(str(Path(a) / path.name), np.uint8))


def test_detect_int8_and_pt_routes(case, tmp_path, monkeypatch):
    ckpt, pt, src, data, _ = case
    common = ["--source", src, "--imgsz", "64", "--conf-thres", CONF, "--device", "cpu",
              "--project", str(tmp_path)]
    out = cli.main(["--weights", ckpt, "--int8", "deep", "--name", "int8"] + common)
    assert len(list(Path(out).glob("*.jpg"))) == 6
    runs = {}
    for name, w in (("npz", ["--weights", ckpt]),
                    ("pt", ["--weights", pt, "--cfg", CFG, "--data", data])):
        rec = _recorded(monkeypatch, CerberusDetInference)
        cli.main(w + ["--name", name] + common)
        runs[name] = list(rec)
        monkeypatch.undo()
    assert runs["pt"] == runs["npz"] and sum(map(len, runs["pt"])) > 0
    for extra in ([], ["--cfg", CFG], ["--data", data]):
        with pytest.raises(SystemExit, match="no architecture metadata"):
            cli.main(["--weights", pt, "--name", "bad"] + extra + common)


def test_parse_opt_matches_root_cli():
    argv = ["--weights", "w", "--source", "s"]
    ours, ref = vars(cli.parse_opt(argv)), vars(jax_cli.parse_opt(argv))
    assert ours.pop("device") == "cuda"
    assert ref.pop("platform") == "" and ref.pop("compile_cache") == "off"
    assert ours == ref
    flags = ["--half", "--agnostic-nms", "--save-crop", "--nosave", "--view-img",
             "--hide-labels", "--hide-conf", "--hide-task", "--exist-ok"]
    a, b = vars(cli.parse_opt(argv + flags)), vars(jax_cli.parse_opt(argv + flags))
    assert {k: a[k] for k in b if k in a} == {k: b[k] for k in a if k in b}


def test_view_img_without_display_skips(case, tmp_path, monkeypatch, capsys):
    ckpt, _, src, _, _ = case
    monkeypatch.delenv("DISPLAY", raising=False)
    cli.main(["--weights", ckpt, "--source", src, "--imgsz", "64", "--device", "cpu",
              "--view-img", "--nosave", "--project", str(tmp_path)])
    assert "no display available" in capsys.readouterr().out
    assert _files(tmp_path) == []


def test_detect_asks_for_the_card(case, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--weights", case[0], "--source", case[2], "--project", str(tmp_path)])
