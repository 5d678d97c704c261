"""The port's single-task wrapper (infer/yolo_wrapper.py) against the JAX
package's contract test (tests/test_yolo_wrapper.py: from_pretrained +
predict returning per-image {box, score, label, label_name} dicts WITHOUT
the multi-task 'task' key), and against the JAX wrapper on the same
checkpoint in float32 on both sides: the same detections, score within
1e-3 absolute and boxes within 1 px (as tests/test_torch_detect.py states
the float32 agreement of the two packages), and the .pt route equal to
the .ckpt.npz route exactly."""

import os

import jax
import numpy as np
import pytest
import torch

from cerberusdet_tpu.infer.yolo_wrapper import YOLOV8ForObjectDetection as JaxWrapper
from cerberusdet_tpu.manager.checkpoint import save_checkpoint
from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu_torch.infer.yolo_wrapper import YOLOV8ForObjectDetection
from cerberusdet_tpu_torch.manager.pt_export import export_pt
from cerberusdet_tpu_torch.manager.weights import export_jax_params, load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.testing import calibrate_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n.yaml")
NAMES = ["cat", "dog", "bird"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX-written single-task .ckpt.npz of yolov8n whose BatchNorm
    statistics come from a seeded batch, and the .pt of the same weights."""
    tmp = tmp_path_factory.mktemp("wrapper")
    params = jax.tree_util.tree_map(
        np.asarray, JaxModel(CFG, ["detect"], [3]).init(jax.random.PRNGKey(0)))
    model = load_jax_params(CerberusModel(CFG, ["detect"], [3], device="cpu"), params)
    calibrate_bn(model, torch.from_numpy(
        np.random.default_rng(1).uniform(0, 1, (4, 3, 64, 64)).astype(np.float32)))
    meta = {"cfg": CFG, "task_ids": ["detect"], "nc": [3], "names": [NAMES], "epoch": 0}
    p = tmp / "single.ckpt.npz"
    save_checkpoint(p, export_jax_params(model), meta, half=False)
    pt = tmp / "single.pt"
    export_pt(model, pt)
    return str(p), str(pt)


def _images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (96, 128, 3), dtype=np.uint8) for _ in range(2)]


def test_from_pretrained_and_predict_contract(ckpt):
    y = YOLOV8ForObjectDetection.from_pretrained(
        ckpt[0], img_size=64, conf_thres=0.0001, half=False, device="cpu")
    assert y.names == NAMES
    img = _images()[0]
    out = y.predict(img)
    assert isinstance(out, list) and len(out) == 1 and len(out[0]) > 0
    for det in out[0]:
        assert set(det) == {"box", "score", "label", "label_name"}  # no 'task'
        assert det["label_name"] in y.names
        x1, y1, x2, y2 = det["box"]
        assert 0 <= x1 <= x2 <= 128 and 0 <= y1 <= y2 <= 96
    # list input and per-call threshold override
    out2 = y.predict([img, img], conf_thres=0.9999)
    assert len(out2) == 2 and all(len(o) == 0 for o in out2)


def test_pt_weights_require_nc_or_names():
    with pytest.raises(ValueError, match="nc or names"):
        YOLOV8ForObjectDetection.from_pretrained("weights.pt", device="cpu")


def test_matches_jax_wrapper_and_pt_route(ckpt):
    common = dict(img_size=64, conf_thres=0.05, half=False)
    ours = YOLOV8ForObjectDetection.from_pretrained(ckpt[0], device="cpu", **common)
    ref = JaxWrapper.from_pretrained(ckpt[0], **common)
    imgs = _images()
    a, b = ours.predict(imgs), ref.predict(imgs)
    assert len(a) == len(b) == 2 and sum(map(len, a)) > 0
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert (x["label"], x["label_name"]) == (y["label"], y["label_name"]), (x, y)
            assert abs(x["score"] - y["score"]) <= 1e-3, (x, y)
            assert max(abs(u - v) for u, v in zip(x["box"], y["box"])) <= 1, (x, y)
    pt = YOLOV8ForObjectDetection.from_pretrained(ckpt[1], cfg=CFG, names=NAMES,
                                                  device="cpu", **common)
    assert pt.names == NAMES and pt.predict(imgs) == a
