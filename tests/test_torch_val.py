"""The port's validation path against the JAX package's.

  * evaluation/metrics.py: every function and class on seeded inputs,
    exactly equal (both are numpy, the same operations in the same order).
  * evaluation/val.py:run_task: yolov8n_2task on seeded 64 px rect val sets
    (pad 0.5, two letterbox shapes per task), in float64 on both sides (JAX
    under enable_x64, as tests/test_torch_inference.py runs it), with the
    weights carried across: identical tp matrices, labels and classes,
    detections within 1e-4 px and confidences within rtol 1e-6 (the decode
    and the sigmoid are float32 on both sides, on float64 logits summed in
    other orders: a float32 ulp), results within 1e-6; the loss terms
    (float32 on both sides) within rtol 1e-5.
  * the rect oracle (tests/test_rect_val.py's, on the port): mAP50 > 0.99.
  * cli/val.py on --device cpu with a JAX-written .ckpt.npz: main's results
    equal run_task's called directly; --task speed; --int8 all against the
    JAX CLI's quantized leaves: s_x within rtol 1e-5 (the calibration's
    float32 convs sum in other orders), s_w within rtol 3e-7 and w_q codes
    off by at most 1 in at most 1e-4 of them (each package fuses the
    checkpoint's BatchNorms itself, in float32: 19 of 3.0 M codes moved).
The seeded models take their BatchNorm statistics from a seeded batch
(testing.calibrate_bn): a random init alone scores the prior everywhere."""

import argparse
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import yaml

from cerberusdet_tpu.data.loaders import create_dataloader as jax_create_dataloader
from cerberusdet_tpu.evaluation import metrics as jm
from cerberusdet_tpu.evaluation import val as jax_val
from cerberusdet_tpu.manager.checkpoint import save_checkpoint as jax_save_checkpoint
from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu.train.loss import DetectionLoss as JaxLoss
from cerberusdet_tpu_torch.cli import val as cli
from cerberusdet_tpu_torch.data.loaders import create_dataloader
from cerberusdet_tpu_torch.evaluation import metrics as pm
from cerberusdet_tpu_torch.evaluation import val as port_val
from cerberusdet_tpu_torch.evaluation.val import run_task
from cerberusdet_tpu_torch.manager.run_manager import parse_data_config
from cerberusdet_tpu_torch.manager.weights import export_jax_params, load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.quant.ptq import fused_conv_weights
from cerberusdet_tpu_torch.testing import calibrate_bn, write_labels, write_val_set
from cerberusdet_tpu_torch.train.loss import DetectionLoss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["a", "b"], [3, 5]
NAMES = {"a": ["c0", "c1", "c2"], "b": ["k0", "k1", "k2", "k3", "k4"]}
# native (w, h): at imgsz 64 and batch 4 the rect batches take (64, 96) and (96, 64)
SIZES = [(80, 60), (100, 60), (96, 72), (90, 60), (60, 80), (60, 100), (72, 96), (60, 90)]


# ------------------------------------------------------------------ metrics


def _stats(seed, n=400, nc=6):
    rng = np.random.default_rng(seed)
    tp = rng.uniform(0, 1, (n, 10)) < np.linspace(0.8, 0.1, 10)
    conf = np.round(rng.uniform(0, 1, n), 3).astype(np.float32)  # ties
    pred_cls = rng.integers(0, nc, n).astype(np.float32)
    target_cls = rng.integers(0, nc - 1, n // 2).astype(np.float32)
    return tp, conf, pred_cls, target_cls


def _boxes(rng, n, scale=100.0):
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(2, scale / 3, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_per_class_matches_jax(seed):
    args = _stats(seed)
    _eq(pm.ap_per_class(*args), jm.ap_per_class(*args))
    rng = np.random.default_rng(seed)
    r = np.sort(rng.uniform(0, 1, 50))
    p = rng.uniform(0, 1, 50)
    _eq(pm.compute_ap(r, p), jm.compute_ap(r, p))
    y = rng.uniform(0, 1, 333)
    _eq(pm.smooth(y, 0.1), jm.smooth(y, 0.1))
    x = rng.uniform(0, 1, (5, 7))
    _eq(pm.fitness(x), jm.fitness(x))
    res = {"a": tuple(x[0]), "b": tuple(x[1])}
    assert pm.overall_fitness(res) == jm.overall_fitness(res)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_process_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    det = np.concatenate([_boxes(rng, 60), rng.uniform(0, 1, (60, 1)),
                          rng.integers(0, 3, (60, 1))], 1).astype(np.float32)
    # labels near some detections, so that every threshold matches some
    lab = np.concatenate([det[:25, 5:6], det[:25, :4] + rng.normal(0, 2, (25, 4))], 1)
    _eq(pm.box_iou_np(lab[:, 1:], det[:, :4]), jm.box_iou_np(lab[:, 1:], det[:, :4]))
    ours = pm.process_batch(det, lab)
    _eq(ours, jm.process_batch(det, lab))
    assert 0 < ours.sum() < ours.size
    _eq(pm.process_batch(det[:0], lab), jm.process_batch(det[:0], lab))
    _eq(pm.process_batch(det, lab[:0]), jm.process_batch(det, lab[:0]))


def test_det_metrics_and_confusion_match_jax():
    rng = np.random.default_rng(4)
    ours, ref = pm.DetMetrics(4, list("wxyz")), jm.DetMetrics(4, list("wxyz"))
    cm_o, cm_r = pm.ConfusionMatrix(4), jm.ConfusionMatrix(4)
    for i in range(6):
        n = 0 if i == 2 else 40
        det = np.concatenate([_boxes(rng, n), rng.uniform(0, 1, (n, 1)),
                              rng.integers(0, 4, (n, 1))], 1).astype(np.float32)
        m = 0 if i == 3 else 12
        lab = np.concatenate([rng.integers(0, 4, (m, 1)),
                              (det[:m, :4] if n else _boxes(rng, m))
                              + rng.normal(0, 3, (m, 4))], 1)
        correct = pm.process_batch(det, lab)
        for mt in (ours, ref):
            mt.update(correct, det[:, 4], det[:, 5], lab[:, 0])
        for cm in (cm_o, cm_r):
            cm.process_batch(det if n else None, lab)
    ours.process()
    ref.process()
    _eq(ours.mean_results(), ref.mean_results())
    _eq(ours.maps, ref.maps)
    _eq(ours.nt_per_class(), ref.nt_per_class())
    _eq(ours.ap_class_index, ref.ap_class_index)
    for i in range(len(ours.ap_class_index)):
        _eq(ours.class_result(i), ref.class_result(i))
    _eq(cm_o.matrix, cm_r.matrix)
    _eq(cm_o.tp_fp(), cm_r.tp_fp())
    assert cm_o.matrix.sum() > 0 and ours.mean_results()[2] > 0
    empty = pm.DetMetrics(3).process()
    assert empty.mean_results() == jm.DetMetrics(3).process().mean_results() == (0.0,) * 4


# ---------------------------------------------------------------- run_task


def _seeded_tree():
    """The port's yolov8n_2task with seeded weights (init(0), box-tower
    biases drawn from seed 1) and BatchNorm statistics from a seeded batch,
    as a JAX parameter tree of float64 arrays."""
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(0).double()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in TASKS:
            head = model.block(model.head_uid(t))
            for i in range(head.nl):
                b = getattr(head, f"box{i}")[2].b
                b.copy_(torch.randn(b.shape, generator=gen, dtype=b.dtype) * 3.0)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (4, 3, 64, 96)))
    calibrate_bn(model, x)
    return export_jax_params(model)


@pytest.fixture(scope="module")
def val_sets(tmp_path_factory, tree):
    """{task: image dir}: 8 images a task, labelled with the seeded model's
    4 best detections (jittered by its float32 forward) and 2 random boxes."""
    root = tmp_path_factory.mktemp("torch_val")
    model = load_jax_params(CerberusModel(CFG, TASKS, NCS, device="cpu"), tree).fuse()
    out = {}
    for i, (t, nc) in enumerate(zip(TASKS, NCS)):
        out[t] = write_val_set(str(root / t), 8, SIZES, seed=10 + i)
        _, loader = create_dataloader(out[t], 64, 4, rect=True, pad=0.5, task="seed",
                                      cache_dir=str(root / t))
        dets = run_task(model, t, loader, nc, return_dets=True)["dets"]
        rng = np.random.default_rng(i)
        for p, d in dets.items():  # 2 random boxes beside the 4 best detections
            h, w = cv2.imread(p).shape[:2]
            xy = rng.uniform(0, 0.5, (2, 2)) * (w, h)
            wh = rng.uniform(0.1, 0.5, (2, 2)) * (w, h)
            extra = np.concatenate([xy, xy + wh, np.ones((2, 1)),
                                    rng.integers(0, nc, (2, 1))], 1)
            dets[p] = np.concatenate([d[:4], extra.astype(np.float32)])
        write_labels(dets)
    return out


@pytest.fixture(scope="module")
def tree():
    return _seeded_tree()


def _capture(monkeypatch, module):
    """Record each image's (det, labels, correct) as run_task matches them."""
    seen = []
    orig = module.process_batch

    def wrapped(det, labels, iouv=module.IOUV):
        correct = orig(det, labels, iouv)
        seen.append((det.copy(), labels.copy(), correct))
        return correct

    monkeypatch.setattr(module, "process_batch", wrapped)
    return seen


MODES = {
    "multi-label": dict(),
    "single_cls, multi-label gts": dict(single_cls=True, use_multi_labels=True),
    "compute_loss, plots": dict(loss=True, plots=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_task_float64_matches_jax(monkeypatch, tmp_path, val_sets, tree, mode):
    kw = dict(MODES[mode])
    loss = kw.pop("loss", False)
    model = load_jax_params(CerberusModel(CFG, TASKS, NCS, device="cpu"), tree).double()
    jmodel = JaxModel(CFG, TASKS, NCS)
    for task, nc in zip(TASKS, NCS):
        dl = dict(imgsz=64, batch_size=4, augment=False, rect=True, pad=0.5,
                  task=f"{task}_val", cache_dir=str(tmp_path), max_labels=16,
                  single_cls=kw.get("single_cls", False))
        ours_seen = _capture(monkeypatch, port_val)
        ours = run_task(model, task, create_dataloader(val_sets[task], **dl)[1], nc,
                        names=NAMES[task], compute_loss=(DetectionLoss(nc, model.strides)
                                                         if loss else None), **kw)
        ref_seen = _capture(monkeypatch, jax_val)
        with jax.enable_x64():
            params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
            jax_loader = jax_create_dataloader(val_sets[task], shuffle=False, **dl)[1]
            ref = jax_val.run_task(
                jmodel, params, task, jax_loader, nc,
                names=NAMES[task], compute_dtype=jnp.float64,
                compute_loss=JaxLoss(nc, jmodel.strides, tal_impl="xla") if loss else None,
                **kw)
        assert len(ours_seen) == len(ref_seen) == ours["seen"] == 8
        n_tp = 0
        for (d, lab, tp), (dr, labr, tpr) in zip(ours_seen, ref_seen):
            assert d.shape == dr.shape and d.dtype == dr.dtype == np.float32
            np.testing.assert_array_equal(tp, tpr)
            np.testing.assert_array_equal(d[:, 5], dr[:, 5])
            np.testing.assert_allclose(d[:, 4], dr[:, 4], rtol=1e-6, atol=0)
            np.testing.assert_allclose(d[:, :4], dr[:, :4], rtol=0, atol=1e-4)
            np.testing.assert_array_equal(lab, labr)
            n_tp += int(tp[:, 0].sum())
        assert n_tp > 0 and sum(len(d) for d, _, _ in ours_seen) > 100
        np.testing.assert_allclose(ours["results"][:4], ref["results"][:4], rtol=0, atol=1e-6)
        np.testing.assert_allclose(ours["results"][4:], ref["results"][4:], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(ours["maps"], ref["maps"], rtol=0, atol=1e-6)
        assert ours["fitness"] == pytest.approx(ref["fitness"], abs=1e-6)
        # the confusion matrix: every label counted once in its column. Which
        # row takes it is decided by an unstable argsort of IoUs that tie
        # exactly where one box carries several classes (multi-label) and
        # nearly where boxes differ by 1e-5 px, so the rows are not held
        # here; test_det_metrics_and_confusion_match_jax holds the class
        # exactly on equal inputs
        cm, cm_ref = ours["confusion"].matrix, ref["confusion"].matrix
        np.testing.assert_array_equal(cm.sum(0)[:-1], cm_ref.sum(0)[:-1])
        assert ours["metrics"].nc == (1 if kw.get("single_cls") else nc)
        assert [t[0] for t in ours["times"]] == [(64, 96), (96, 64)]
        if loss:
            assert all(v > 0 for v in ours["results"][4:])
        if kw.get("plots"):
            assert ours["confusion"].matrix.sum() > 0


def test_run_task_returns_native_dets_and_keeps_train_mode(tmp_path, val_sets, tree):
    model = load_jax_params(CerberusModel(CFG, TASKS, NCS, device="cpu"), tree).train()
    _, loader = create_dataloader(val_sets["a"], 64, 4, rect=True, pad=0.5, task="a",
                                  cache_dir=str(tmp_path), max_labels=16)
    out = run_task(model, "a", loader, 3, return_dets=True, conf_thres=0.01)
    assert model.training and len(out["dets"]) == 8
    for path, det in out["dets"].items():
        h, w = cv2.imread(path).shape[:2]
        assert det.shape[1] == 6 and (det[:, 4] > 0.01).all()
        assert (det[:, [0, 2]] <= w).all() and (det[:, [1, 3]] <= h).all() and (det >= 0).all()
    # distributed=True is ported (tests/test_torch_parallel.py merges 2 ranks): in a
    # group of one the merge is the identity
    import torch.distributed as dist

    from cerberusdet_tpu_torch.parallel import init_distributed

    joined = dist.is_initialized()
    group = init_distributed(device="cpu") if not joined else dist.group.WORLD
    try:
        if dist.get_world_size(group) == 1:
            again = run_task(model, "a", loader, 3, return_dets=True, conf_thres=0.01,
                             distributed=True)
            assert again["results"] == out["results"] and again["seen"] == 8
    finally:
        if not joined:
            dist.destroy_process_group()


class OracleModel(nn.Module):
    """Reads the ground truth out of the image colours (tests/test_rect_val.py):
    red rectangle -> class 0, green -> class 1, as an NCHW port model."""

    def __init__(self):
        super().__init__()
        self.anchor = nn.Parameter(torch.zeros(()))  # gives run_task a device and dtype

    def forward(self, x, tasks=None):
        b, _, h, w = x.shape
        r, g, bl = x[:, 0], x[:, 1], x[:, 2]
        masks = [(r > 0.6) & (g < 0.3) & (bl < 0.3), (g > 0.6) & (r < 0.3) & (bl < 0.3)]
        xs = torch.arange(w, dtype=torch.float32)[None, None, :]
        ys = torch.arange(h, dtype=torch.float32)[None, :, None]
        preds = []
        for ci, m in enumerate(masks):
            big = torch.tensor(1e9)
            x1 = torch.where(m, xs, big).amin((1, 2))
            y1 = torch.where(m, ys, big).amin((1, 2))
            x2 = torch.where(m, xs, -big).amax((1, 2)) + 1.0
            y2 = torch.where(m, ys, -big).amax((1, 2)) + 1.0
            present = m.any(dim=2).any(dim=1)
            box = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
            box = torch.where(present[:, None], box, 0.0)
            scores = torch.zeros((b, 2))
            scores[:, ci] = torch.where(present, 0.99, 0.0)
            preds.append(torch.cat([box, scores], -1))
        pred = torch.stack(preds, 1)  # (B, 2, 4 + nc)
        return {t: (pred, None) for t in (tasks or ["toy"])}


def test_rect_val_oracle_reaches_full_map50(tmp_path):
    """The complete rect-val chain (letterbox to per-batch shapes, NMS,
    scale-back, 10-IoU matching) scores a perfect detector at mAP50 1.0."""
    rng = np.random.default_rng(0)
    img_dir, lb_dir = tmp_path / "images" / "val", tmp_path / "labels" / "val"
    img_dir.mkdir(parents=True)
    lb_dir.mkdir(parents=True)
    for i in range(10):
        h, w = int(rng.integers(60, 200)), int(rng.integers(60, 200))
        im = np.full((h, w, 3), 40, np.uint8)
        x1, y1, x2, y2 = int(0.25 * w), int(0.375 * h), int(0.75 * w), int(0.625 * h)
        im[y1:y2, x1:x2] = (30, 30, 200) if i % 2 == 0 else (30, 200, 30)  # BGR
        cv2.imwrite(str(img_dir / f"{i}.jpg"), im)
        (lb_dir / f"{i}.txt").write_text(f"{i % 2} 0.5 0.5 0.5 0.25")
    _, loader = create_dataloader(str(img_dir), imgsz=64, batch_size=4, rect=True, pad=0.5,
                                  task="oracle", cache_dir=str(tmp_path), max_labels=4)
    out = run_task(OracleModel(), "toy", loader, nc=2, names=["red", "green"])
    mp, mr, map50, mAP = out["results"][:4]
    assert len({t[0] for t in out["times"]}) > 1  # several letterbox shapes
    assert map50 > 0.99 and mr > 0.99, out["results"]
    assert mAP > 0.5, out["results"]  # the strict-IoU tail loses only to 1 px rasterisation


# -------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory, val_sets, tree):
    """A JAX-written .ckpt.npz of the seeded model and a 2-task data.yaml."""
    root = tmp_path_factory.mktemp("torch_val_cli")
    weights = str(root / "w.ckpt.npz")
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    jax_save_checkpoint(weights, params, {"cfg": CFG, "task_ids": TASKS, "nc": NCS,
                                          "names": [NAMES[t] for t in TASKS]})
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"task_ids": TASKS, "nc": NCS,
                                    "names": [NAMES[t] for t in TASKS],
                                    "train": [val_sets[t] for t in TASKS],
                                    "val": [val_sets[t] for t in TASKS]}))
    common = ["--weights", weights, "--data", str(data), "--device", "cpu", "--imgsz", "64",
              "--batch-size", "4", "--project", str(root / "runs"), "--workers", "2"]
    return weights, str(data), common


def test_cli_main_equals_run_task(cli_case):
    weights, data, common = cli_case
    got = cli.main(common)
    model = cli.load_model_for_eval(weights, "", "cpu")
    for ti, task in enumerate(TASKS):
        _, loader = create_dataloader(parse_data_config(data)["val"][ti], 64, 4,
                                      rect=True, pad=0.5, task=f"{task}_val")
        ref = run_task(model, task, loader, NCS[ti], names=NAMES[task])
        assert got[task]["results"] == ref["results"]
        np.testing.assert_array_equal(got[task]["maps"], ref["maps"])
        assert got[task]["seen"] == 8 and got[task]["results"][2] > 0


def test_cli_speed_and_refusals(cli_case, monkeypatch):
    weights, _, common = cli_case
    out = cli.main(common + ["--task", "speed", "--batch-size", "2"])
    assert set(out) == {"ms_per_image", "images_per_sec"} and out["images_per_sec"] > 0
    # --mlflow-url is ported: the metrics go to MLflow (a recording stub here),
    # and the run directory receives the mosaics and the per-task figures
    from test_integrations_stub import RecordingMlflow

    from cerberusdet_tpu_torch.utils import mlflow_logging

    stub = RecordingMlflow()
    monkeypatch.setattr(mlflow_logging, "mlflow", stub)
    monkeypatch.setattr(mlflow_logging, "MLFLOW_AVAILABLE", True)
    got = cli.main(common + ["--mlflow-url", "http://localhost:5000", "--name", "mlflow"])
    logged = {}
    for _, (m,), _ in stub.named("log_metrics"):
        logged.update(m)
    for task in TASKS:
        assert logged[f"val/{task}/mAP_0.5"] == got[task]["results"][2]
    run = os.path.join(common[common.index("--project") + 1], "mlflow")
    for task in TASKS:
        for name in (f"val_batch0_labels_{task}.jpg", f"val_batch0_pred_{task}.jpg",
                     f"{task}_confusion_matrix.png"):
            assert cv2.imread(os.path.join(run, name)) is not None, name
    with pytest.raises(SystemExit, match="--cfg required"):  # .pt weights need the model yaml
        cli.load_model_for_eval(weights.replace(".ckpt.npz", ".pt"), "", "cpu")
    if not torch.cuda.is_available():  # without --device the entry point asks for the card
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--weights", weights, "--data", common[3], "--imgsz", "64"])


def test_cli_int8_matches_jax_quantized_leaves(cli_case):
    weights, data, common = cli_case
    sys.path.insert(0, ROOT)
    import val as jax_cli  # the JAX package's val.py at the repository root

    data_dict = parse_data_config(data, check=True)
    opt = argparse.Namespace(imgsz=64, batch_size=4, workers=2, bf16=False, int8="all")
    jmodel, jparams = jax_cli.load_model_for_eval(weights, "", data_dict)
    ref = jax.tree_util.tree_map(np.asarray, jax_cli.quantize_for_eval(
        jmodel, jparams, data_dict, opt))
    model = cli.load_model_for_eval(weights, "", "cpu")
    fused = fused_conv_weights(model)
    cli.quantize_for_eval(model, data_dict, opt, torch.float32, fused)
    ours = export_jax_params(model)
    leaves = dict(jax.tree_util.tree_leaves_with_path(ref))
    n_q = n_diff = n_w = 0
    for path, a in jax.tree_util.tree_leaves_with_path(ours):
        key = path[-1].key
        if key in ("w_q", "s_w", "s_x"):
            b = leaves[path]
            assert a.dtype == b.dtype and a.shape == b.shape, path
            if key == "w_q":
                diff = np.abs(a.astype(int) - b.astype(int))
                n_diff += int((diff > 0).sum())
                n_w += diff.size
                assert diff.max() <= 1, path
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5 if key == "s_x" else 3e-7,
                                           err_msg=str(path))
            n_q += key == "w_q"
    assert n_q == sum(1 for p in leaves if p[-1].key == "w_q") > 50
    print(f"w_q codes off by one: {n_diff} of {n_w}")
    assert n_diff <= 1e-4 * n_w
    out = cli.main(common + ["--int8", "all"])
    assert all(np.isfinite(out[t]["results"][:4]).all() for t in TASKS)


@pytest.mark.cuda
def test_run_task_kernels_match_plain_on_card(val_sets, tmp_path, tree):
    """On the card: run_task with the NMS kernel and the int8 kernels gives
    the stats of the plain versions (use_kernel=False), exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cerberusdet_tpu_torch.quant import calibrate_amax, quantize_params, select_all

    model = load_jax_params(CerberusModel(CFG, TASKS, NCS, device="cuda"), tree).fuse()
    for int8 in (False, True):
        if int8:
            batch = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
            quantize_params(model, calibrate_amax(model, [batch]), select=select_all)
        for task, nc in zip(TASKS, NCS):
            _, loader = create_dataloader(val_sets[task], 64, 4, rect=True, pad=0.5,
                                          task=task, cache_dir=str(tmp_path))
            a = run_task(model, task, loader, nc)["metrics"].stats
            b = run_task(model, task, loader, nc, use_kernel=False)["metrics"].stats
            for x, y in zip(a, b):
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)
