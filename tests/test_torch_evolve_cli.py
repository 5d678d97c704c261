"""A real `cli.train --evolve 2` of the port on the CPU (yolov8n_2task, 64 px,
a tiny seeded 2-task set): two generations, each a 1-epoch TrainLoop with
noval and its val per task, write evolve.json and hyp_evolved.yaml; the
second generation's hyps are the mutation of the first's results, as the
host replays it from the logged results with the same seed; each
generation's run draws its plots; TrainLoop.close leaves no captured step or
loader behind. In a file of its own, so that `--dist loadfile` runs it
beside the other files."""

import copy
import json
import os
import types

import numpy as np
import pytest
import torch
import yaml

from cerberusdet_tpu_torch.cli import train as cli
from cerberusdet_tpu_torch.evolve.yolov5_evolver import Yolov5Evolver
from cerberusdet_tpu_torch.manager.run_manager import RunManager
from cerberusdet_tpu_torch.testing import write_val_set
from cerberusdet_tpu_torch.train import trainer as port_trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
HYP = os.path.join(ROOT, "configs", "hyps", "hyp.cerber-voc_obj365.yaml")
TASKS, NCS = ["a", "b"], [3, 2]
SIZES = [(80, 60), (64, 64), (100, 40)]


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cli_evolve_two_generations(tmp_path, monkeypatch):
    monkeypatch.setattr(RunManager, "tb_writer", lambda self: None)
    data = {"task_ids": TASKS, "nc": NCS, "names": [["c0", "c1", "c2"], ["k0", "k1"]],
            "train": [], "val": []}
    for ti, (t, nc) in enumerate(zip(TASKS, NCS)):
        data["train"].append(write_val_set(str(tmp_path / t / "train"), 4, SIZES, seed=ti,
                                           n_labels=3, nc=nc))
        data["val"].append(write_val_set(str(tmp_path / t / "val"), 2, SIZES, seed=10 + ti,
                                         n_labels=2, nc=nc))
    (tmp_path / "data.yaml").write_text(yaml.safe_dump(data))

    closed = []
    real_close = port_trainer.TrainLoop.close

    def close(self):
        real_close(self)
        closed.append((self.trainer, self.model, self.train_loaders))

    monkeypatch.setattr(port_trainer.TrainLoop, "close", close)
    argv = ["--data", str(tmp_path / "data.yaml"), "--cfg", CFG, "--hyp", HYP, "--epochs", "1",
            "--batch-size", "2", "--imgsz", "64", "--project", str(tmp_path / "runs"),
            "--name", "exp", "--workers", "2", "--device", "cpu", "--warmup-min-iters", "2",
            "--evolve", "2", "--params-to-evolve", "lr0,momentum,box,mosaic,hsv_h"]
    opt_ns, opt, hyp, data_dict, device = cli.options(argv)
    ev = cli.evolver(opt, opt_ns, hyp, data_dict, device, seed=0)
    assert isinstance(ev, Yolov5Evolver) and opt.name == "yolov5_exp"
    ev.run_evolution()

    run = tmp_path / "runs" / "yolov5_exp"
    muts = [json.loads(line) for line in (run / "evolve.json").read_text().splitlines()]
    assert [m["step"] for m in muts] == [0, 1] and all(m["train_epochs"] == 1 for m in muts)
    assert set(muts[0]["results_per_task"]) == set(TASKS)
    assert (run / "hyp_evolved.yaml").exists()
    assert closed == [(None, None, {})] * 2
    # generation 1 is the bounded start hyp; generation 2 its mutation, which a
    # fresh evolver with the same seed replays from generation 1's results
    evolved = ["lr0", "momentum", "box", "mosaic", "hsv_h"]
    replay = Yolov5Evolver(types.SimpleNamespace(project=str(tmp_path / "replay"), name="r",
                                                 epochs=1), hyp, data_dict, generations=2,
                           params_to_evolve=evolved, seed=0)
    first = replay.bound_hyp_values(copy.deepcopy(hyp))
    assert first == muts[0]["hyps"]
    replay.file_logger.append_mutation_to_file(muts[0]["hyps"], muts[0]["results_per_task"],
                                               1, 0)
    assert replay.get_next_hyp(first) == muts[1]["hyps"] != muts[0]["hyps"]
    assert {k for k in hyp if muts[1]["hyps"][k] != muts[0]["hyps"][k]} <= set(evolved)
    # each generation's run (noval, in <run>/gen) drew its train mosaics and labels
    gen = run / "gen"
    assert sorted(p.name for p in gen.glob("train_batch_*.png")) == [
        "train_batch_a_0.png", "train_batch_a_1.png", "train_batch_b_0.png",
        "train_batch_b_1.png"]
    assert (gen / "labels.png").exists() and (run / "evolve.png").exists()
    assert np.isfinite([v for m in muts for r in m["results_per_task"].values()
                        for v in r]).all()


def test_train_cli_draws_what_jax_draws(tmp_path, monkeypatch):
    """A run that saves draws the label statistics, the first train batches,
    the final val's mosaics, PR curves and confusion matrices (the JAX
    package's trainer.py:240-345)."""
    monkeypatch.setattr(RunManager, "tb_writer", lambda self: None)
    data = {"task_ids": ["a"], "nc": [2], "names": [["c0", "c1"]], "train": [], "val": []}
    data["train"].append(write_val_set(str(tmp_path / "train"), 4, SIZES, seed=3, n_labels=2,
                                       nc=2))
    data["val"].append(write_val_set(str(tmp_path / "val"), 2, SIZES, seed=4, n_labels=2,
                                     nc=2))
    (tmp_path / "data.yaml").write_text(yaml.safe_dump(data))
    loop = cli.main(["--data", str(tmp_path / "data.yaml"), "--cfg",
                     os.path.join(ROOT, "configs", "models", "yolov8n.yaml"), "--hyp", HYP,
                     "--epochs", "1", "--batch-size", "2", "--imgsz", "64", "--project",
                     str(tmp_path / "runs"), "--workers", "2", "--device", "cpu",
                     "--warmup-min-iters", "2"])
    names = sorted(p.name for p in loop.manager.save_dir.iterdir() if p.is_file())
    assert {"labels.png", "train_batch_a_0.png", "train_batch_a_1.png",
            "val_batch0_labels_a.jpg", "val_batch0_pred_a.jpg", "a_PR_curve.png",
            "a_confusion_matrix.png"} <= set(names), names
