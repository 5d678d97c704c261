"""The plain reference against the port at a tiny size on the CPU (the 2-task
yolov8n): the forward in float64, the served detection lists in float32, and
three train steps in float32; and the controls (the reference in the
precision below the configuration's, in the program's place), which must
come out as not correct at the tiny cells' limits."""

import numpy as np
import pytest
import torch

from benchmark.core import family, load_cell
from benchmark.drivers import offline, train
from benchmark.reference.compare import as_arrays, tasks_of, unmatched
from benchmark.reference.detect import iou_matrix, letterbox
from benchmark.serving import names_of
from benchmark.tests.tiny import make_root, tiny_config
from benchmark.trace import Tracer
from benchmark.weights import frames

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def seeded():
    cfg = tiny_config()
    gen = torch.Generator().manual_seed(3)
    calib = letterbox(frames(gen, 4, 48, 64, "cpu"), 64)
    return cfg, calib, family("yolov8").make_weights(cfg["model"], cfg["tasks"], cfg["nc"], gen,
                                                     calib)


def test_forward_matches_the_port(seeded):
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel

    cfg, x, w = seeded
    model = CerberusModel(cfg["model"], cfg["tasks"], cfg["nc"], device="cpu")
    model.load_state_dict(w)
    with torch.no_grad():
        port = model.double().eval()(x.double())
    ref = family("yolov8").Reference(cfg["model"], cfg["tasks"], cfg["nc"], w,
                                     torch.float64).forward(x)
    for t in cfg["tasks"]:
        scale = ref[t].abs().max()
        assert (port[t][0] - ref[t]).abs().max() <= 1e-6 * scale


def test_served_lists_match_the_port(tmp_path):
    from cerberusdet_tpu_torch.infer.inference import CerberusDetInference
    from cerberusdet_tpu_torch.infer.preprocessor import CerberusPreprocessor
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel

    cell = load_cell("tiny-offline", make_root(tmp_path))
    s = offline.Session(cell, 11, CPU, Tracer(False), program=False)
    model = CerberusModel(cell.config["model"], s.tasks, s.ncs, device="cpu")
    model.load_state_dict(s.weights)
    inf = CerberusDetInference(model=model, names=names_of(cell.config), img_size=s.size,
                               dtype=torch.float32, device="cpu")
    x, shapes = CerberusPreprocessor(img_size=s.size, device="cpu").preprocess(s.pool)
    out = inf.predict(x, original_shape=shapes)
    ref = s.reference_lists()
    counts = sum(unmatched(as_arrays(d), r, tasks_of(s.ncs)) for d, r in zip(out, ref))
    assert counts[1] > 0 and counts[0] == 0 and counts[2] == 0
    for d, (_, rs, _) in zip(out, ref):
        np.testing.assert_allclose([e["score"] for e in d], rs, rtol=0, atol=2e-5)


def test_train_steps_match_the_port(tmp_path):
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.train.loss import DetectionLoss
    from cerberusdet_tpu_torch.train.step import MultiTaskTrainer, init_train_state

    cell = load_cell("tiny-train", make_root(tmp_path))
    s = train.Session(cell, 5, CPU, Tracer(False), program=False)
    model = CerberusModel(cell.config["model"], s.tasks, s.ncs, device="cpu")
    model.load_state_dict(s.weights)
    trainer = MultiTaskTrainer(model, {t: DetectionLoss(nc=nc, strides=model.strides)
                                       for t, nc in zip(s.tasks, s.ncs)},
                               compute_dtype=torch.float32, device="cpu")
    state = init_train_state(model)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    losses = []
    for k in range(cell.traffic["checked_steps"]):
        lrs, mom = train.schedule(cell.traffic, k)
        state, items = trainer.step(state, s.pool[k], lrs, mom)
        losses.append([float(items[t].total) for t in s.tasks])
        if k == 0:
            grad1 = {n: v.clone() for n, v in state.opt_state.momentum_buf.items()}
            running1 = {n: v - s.weights[n] for n, v in model.named_buffers() if "running" in n}
    change = {k: v.detach() - p0[k] for k, v in model.named_parameters()}
    ema = {k: v.detach() - s.weights[k] for k, v in state.ema.named_parameters()}
    n = s.numbers((losses, grad1, change, running1, ema), s.follow())
    assert n["loss_gap"] < 1e-4 and n["grad_gap_worst"] < 1e-3 and n["change_gap_worst"] < 1e-3
    assert n["bn_var_gap_median"] < 1e-4 and n["bn_mean_gap_median"] < 1e-4
    assert n["ema_change_gap_median"] < 1e-3


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_serving_control_is_not_correct(tmp_path, seed):
    cell = load_cell("tiny-offline", make_root(tmp_path))
    s = offline.Session(cell, seed, CPU, Tracer(False), program=False)
    assert s.control({"quant_bits": 4})["unmatched_share"] > 0.3


@pytest.mark.parametrize("seed", [7, 8, 2 ** 31 + 8])
def test_train_control_is_not_correct(tmp_path, seed):
    cell = load_cell("tiny-train", make_root(tmp_path))
    s = train.Session(cell, seed, CPU, Tracer(False), program=False)
    assert s.control({"cast": "fp8"})["bn_var_gap_median"] > 0.1


def box(x, y, w=40.0, h=40.0):
    return [x, y, x + w, y + h]


@pytest.mark.parametrize("shift,counted", [(0, True), (4, True), (12, False), (18, False),
                                           (24, True)])
def test_a_box_that_nms_removes_is_counted_unless_near_the_threshold(shift, counted):
    """A program list with a same-label duplicate of a reference detection,
    shifted by `shift` px (IoU (40 - shift) / (40 + shift)): counted where it
    overlaps its better neighbour beyond the NMS threshold plus MARGIN (IoU
    1.0, 0.82), excused within MARGIN of the threshold (0.54, 0.38: rounding
    decides), and counted as an ordinary extra detection further off (0.25)."""
    ref = (np.array([box(100, 100)]), np.array([0.9]), np.array([3]))
    prog = (np.array([box(100, 100), box(100 + shift, 100)]), np.array([0.9, 0.8]),
            np.array([3, 3]))
    assert unmatched(prog, ref, tasks_of([20, 19]))[0] == int(counted)


@pytest.mark.parametrize("iou_shift,counted", [(1.0, True), (3.0, False)])
def test_a_box_that_the_suppression_between_tasks_removes_is_counted(iou_shift, counted):
    """The same for another task's duplicate (label 25 of task 1 on label 3 of
    task 0): beyond 0.8 + MARGIN counted, within MARGIN of 0.8 excused."""
    ref = (np.array([box(100, 100)]), np.array([0.9]), np.array([3]))
    prog = (np.array([box(100, 100), box(100 + iou_shift, 100)]), np.array([0.9, 0.8]),
            np.array([3, 25]))
    iou = float(iou_matrix(prog[0][:1], prog[0][1:])[0, 0])
    assert (iou > 0.9) is counted
    assert unmatched(prog, ref, tasks_of([20, 19]))[0] == int(counted)


def test_lists_without_nms_are_counted(tmp_path):
    """The reference's own lists with NMS skipped (IoU threshold 1) against its
    sound lists, over the tiny cell's frames: the duplicates count."""
    cell = load_cell("tiny-offline", make_root(tmp_path))
    s = offline.Session(cell, 11, CPU, Tracer(False), program=False)
    sound = s.reference_lists()
    cell.traffic["iou"] = 1.0
    dup = s.reference_lists()
    counts = sum(unmatched(a, b, tasks_of(s.ncs)) for a, b in zip(dup, sound))
    assert counts[1] > counts[3] and counts[0] > 0 and counts[2] == 0
