"""The port's reference-checkpoint bridge (manager/pt_import.py, pt_export.py,
tools/export_to_pt.py, tools/convert_to_cerber.py and the .pt routes of
load_single, RunManager.load_model and cli/val.py) against the JAX package's.

The files are written by the tests, as tests/test_pt_import.py writes its
own: a bare YOLOv8 state dict ('model.N.*', single task, the head copied to
every task), the same under a 'model.' wrapper, the JAX package's
export_state_dict of yolov8n_2task (split layout: clones after the heads),
an unsplit 'blocks.*' + 'heads.<task>.*' dict, and a module-pickled
checkpoint (an nn.Module graph pickled under a foreign module name, read
through the shim unpickler). On each, the port's import equals the JAX
import of the same file bit for bit, read back through the weight bridge
(both start from the same JAX init, so the leaves a file lacks agree too).
"""

import os
import sys
import types

import jax
import numpy as np
import pytest
import torch
import yaml

from cerberusdet_tpu.manager import pt_export as jax_export
from cerberusdet_tpu.manager import pt_import as jax_import
from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu_torch.cli import val as cli_val
from cerberusdet_tpu_torch.manager import pt_export, pt_import
from cerberusdet_tpu_torch.manager.attempt_load import load_single
from cerberusdet_tpu_torch.manager.checkpoint import load_checkpoint, save_checkpoint
from cerberusdet_tpu_torch.manager.run_manager import RunManager
from cerberusdet_tpu_torch.manager.weights import export_jax_params, load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.testing import calibrate_bn, write_val_set
from cerberusdet_tpu_torch.tools import convert_to_cerber, export_to_pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG1 = os.path.join(ROOT, "configs", "models", "yolov8n.yaml")
CFG2 = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["a", "b"], [3, 3]
NAMES = [["c0", "c1", "c2"], ["k0", "k1", "k2"]]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same_tree(a, b):
    a, b = dict(_flat(a)), dict(_flat(b))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))


def _jax_pair(cfg, tasks, ncs, seed=0):
    jmodel = JaxModel(cfg, tasks, ncs)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    return jmodel, params


def _port(cfg, tasks, ncs, params):
    return load_jax_params(CerberusModel(cfg, tasks, ncs, device="cpu"), params)


def _yolo_sd(seed=1):
    """A bare single-task YOLOv8n state dict in the ultralytics layout
    ('model.<i>.*', the Detect head at model.<len(nodes)>), from the JAX
    package's export of a seeded single-task model."""
    jmodel, params = _jax_pair(CFG1, ["detect"], [3], seed)
    n_bb, n_neck = jmodel.n_backbone, len(jmodel.parsed.nodes) - jmodel.n_backbone
    out = {}
    for k, v in jax_export.export_state_dict(jmodel, params).items():
        parts = k.split(".")
        if parts[1] == "0":
            key = "model." + ".".join(parts[3:])
        else:
            c = int(parts[1])
            node = n_bb + c - 1 if c <= n_neck else n_bb + n_neck
            key = f"model.{node}." + ".".join(parts[2:])
        out[key] = v
    return out


def _unsplit_sd(seed=2):
    """An unsplit 2-task CerberusDet dict: the neck once as blocks.1..n_neck
    (no clones), each task's head as heads.<task>.*."""
    jmodel, params = _jax_pair(CFG2, TASKS, NCS, seed)
    n_neck = len(jmodel.parsed.nodes) - jmodel.n_backbone
    out = {}
    for k, v in jax_export.export_state_dict(jmodel, params).items():
        idx = int(k.split(".")[1])
        if idx <= n_neck:
            out[k] = v
        elif idx <= n_neck + len(TASKS):
            rest = k.split(".", 2)[2]
            out[f"heads.{TASKS[idx - n_neck - 1]}.{rest}"] = v
    return out


def _module_pickled(path, sd):
    """Save `sd` as the reference does, a pickled module graph (half
    precision, under 'model', 'ema' None), whose classes live in a module
    that is gone when the file is read."""
    mod = types.ModuleType("cerberusdet_foreign_models")
    sys.modules[mod.__name__] = mod
    try:
        Container = type("CerberusDet", (torch.nn.Module,), {"__module__": mod.__name__})
        Block = type("Conv", (torch.nn.Module,), {"__module__": mod.__name__})
        setattr(mod, "CerberusDet", Container)
        setattr(mod, "Conv", Block)
        root = Container()
        for key, v in sd.items():
            *path_parts, leaf = key.split(".")
            node = root
            for p in path_parts:
                if p not in node._modules:
                    node.add_module(p, Block())
                node = node._modules[p]
            t = torch.from_numpy(np.array(v))
            if leaf in ("running_mean", "running_var", "num_batches_tracked"):
                node.register_buffer(leaf, t)
            else:
                node.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
        torch.save({"epoch": 0, "model": root.half(), "ema": None}, str(path))
    finally:
        del sys.modules[mod.__name__]
    return path


def _split_sd(seed=5):
    jmodel, params = _jax_pair(CFG2, TASKS, NCS, seed)
    return jax_export.export_state_dict(jmodel, params)


LAYOUTS = {  # name -> (cfg, tasks, ncs, make(tmp_path) -> a state dict or a .pt path)
    "yolov8 bare, single task": (CFG1, ["detect"], [3], lambda tmp: _yolo_sd()),
    "yolov8 bare to 2 tasks": (CFG2, TASKS, NCS, lambda tmp: _yolo_sd()),
    "model.model. wrapper": (CFG1, ["detect"], [3],
                             lambda tmp: {"model." + k: v for k, v in _yolo_sd().items()}),
    "split cerber (JAX export)": (CFG2, TASKS, NCS, lambda tmp: _split_sd()),
    "unsplit blocks + heads": (CFG2, TASKS, NCS, lambda tmp: _unsplit_sd()),
    "module-pickled (shim)": (CFG2, TASKS, NCS,
                              lambda tmp: _module_pickled(tmp / "mod.pt", _split_sd())),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_import_matches_jax(tmp_path, layout):
    cfg, tasks, ncs, make = LAYOUTS[layout]
    src = make(tmp_path)
    if not isinstance(src, dict):
        path = src
    else:
        path = tmp_path / "w.pt"
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in src.items()}, str(path))
    jmodel, init = _jax_pair(cfg, tasks, ncs, seed=9)
    ref = jax.tree_util.tree_map(np.asarray, jax_import.import_pt(jmodel, init, str(path)))
    ours = pt_import.import_pt(_port(cfg, tasks, ncs, init), str(path))
    _same_tree(export_jax_params(ours), ref)
    assert pt_import.load_torch_state_dict(str(path)).keys() == \
        jax_import.load_torch_state_dict(str(path)).keys()


def test_import_counts_and_split_refusal(tmp_path, capsys):
    jmodel, params = _jax_pair(CFG2, TASKS, NCS)
    sd = jax_export.export_state_dict(jmodel, params)
    jax_import.import_state_dict(jmodel, params, sd, verbose=True)
    want = capsys.readouterr().out
    pt_import.import_state_dict(_port(CFG2, TASKS, NCS, params), sd, verbose=True)
    got = capsys.readouterr().out
    assert got == want and got.startswith("imported ")
    flat_cfg = yaml.safe_load(open(CFG2))
    del flat_cfg["cerber"]
    with pytest.raises(ValueError, match="SPLIT"):
        pt_import.import_state_dict(CerberusModel(flat_cfg, TASKS, NCS, device="cpu").init(0),
                                    sd)


@pytest.mark.parametrize("cfg,tasks,ncs", [(CFG2, TASKS, NCS), (CFG1, ["detect"], [3])])
def test_export_matches_jax_and_round_trips(tmp_path, cfg, tasks, ncs):
    jmodel, params = _jax_pair(cfg, tasks, ncs, seed=3)
    ref = jax_export.export_state_dict(jmodel, params)
    model = _port(cfg, tasks, ncs, params)
    sd = pt_export.export_state_dict(model)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert sd[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)
    path = tmp_path / "x.pt"
    pt_export.export_pt(model, path)
    back = pt_import.import_pt(CerberusModel(cfg, tasks, ncs, device="cpu").init(7), path)
    _same_tree(export_jax_params(back), params)


@pytest.fixture(scope="module")
def pt_case(tmp_path_factory):
    """A seeded yolov8n_2task (BatchNorm statistics from a batch) as a
    .ckpt.npz and as the .pt that tools.export_to_pt writes from it, and a
    tiny labelled val set."""
    root = tmp_path_factory.mktemp("pt_case")
    model = CerberusModel(CFG2, TASKS, NCS, device="cpu").init(0)
    calibrate_bn(model, torch.from_numpy(
        np.random.default_rng(2).uniform(0, 1, (4, 3, 64, 64)).astype(np.float32)))
    ckpt = str(root / "w.ckpt.npz")
    save_checkpoint(ckpt, export_jax_params(model), {
        "cfg": CFG2, "task_ids": TASKS, "nc": NCS, "names": NAMES}, half=False)
    pt = str(root / "w.pt")
    export_to_pt.main(["--weights", ckpt, "--out", pt])
    dirs = [write_val_set(root / t, 4, [(80, 60), (64, 64)], seed=i, n_labels=2, nc=3)
            for i, t in enumerate(TASKS)]
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"task_ids": TASKS, "nc": NCS, "names": NAMES,
                                    "train": dirs, "val": dirs}))
    return ckpt, pt, str(data), model


def test_load_routes_accept_pt(pt_case, tmp_path):
    ckpt, pt, data, model = pt_case
    want = export_jax_params(model)
    m, meta = load_single(pt, CFG2, TASKS, NCS, fuse=False, device="cpu")
    _same_tree(export_jax_params(m), want)
    assert meta == {"task_ids": TASKS, "nc": NCS}
    fused_npz = export_jax_params(load_single(ckpt, device="cpu")[0])
    _same_tree(export_jax_params(load_single(pt, CFG2, TASKS, NCS, device="cpu")[0]), fused_npz)
    with pytest.raises(ValueError, match="architecture metadata"):
        load_single(pt, device="cpu")
    man = RunManager({}, yaml.safe_load(open(data)), CFG2, tmp_path / "run", device="cpu")
    m, meta = man.load_model(pt, seed=4)
    _same_tree(export_jax_params(m), want)
    assert meta == {}


def test_val_cli_takes_pt(pt_case, tmp_path):
    """cli.val on the .pt with --cfg gives the .ckpt.npz's statistics and
    results exactly; without --cfg it exits as the JAX val.py does."""
    ckpt, pt, data, _ = pt_case
    common = ["--data", data, "--device", "cpu", "--imgsz", "64", "--batch-size", "4",
              "--workers", "1", "--project", str(tmp_path)]
    a = cli_val.main(["--weights", ckpt] + common + ["--name", "npz"])
    b = cli_val.main(["--weights", pt, "--cfg", CFG2] + common + ["--name", "pt"])
    for t in TASKS:
        assert a[t]["results"] == b[t]["results"] and a[t]["seen"] == b[t]["seen"] == 4
        for x, y in zip(a[t]["metrics"].stats, b[t]["metrics"].stats):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
    assert sum(len(x[1]) for x in a[TASKS[0]]["metrics"].stats) > 0  # it detects
    with pytest.raises(SystemExit, match="--cfg required"):
        cli_val.main(["--weights", pt] + common + ["--name", "nocfg"])


def test_tools_round_trip(pt_case, tmp_path):
    """export_to_pt writes what the JAX tool writes; convert_to_cerber reads
    it back into a .ckpt.npz equal to the JAX tool's conversion."""
    from cerberusdet_tpu.tools import convert_to_cerber as jax_convert
    from cerberusdet_tpu.tools import export_to_pt as jax_export_tool

    ckpt, pt, data, _ = pt_case
    jax_pt = tmp_path / "jax.pt"
    jax_export_tool.main(["--weights", ckpt, "--out", str(jax_pt)])
    a, b = torch.load(pt), torch.load(str(jax_pt))
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ours, ref = tmp_path / "ours.ckpt.npz", tmp_path / "ref.ckpt.npz"
    convert_to_cerber.main(["--weights", pt, "--cfg", CFG2, "--data", data, "--out", str(ours)])
    jax_convert.main(["--weights", pt, "--cfg", CFG2, "--data", data, "--out", str(ref)])
    x, y = load_checkpoint(ours), load_checkpoint(ref)
    _same_tree(x["params"], y["params"])
    assert x["meta"] == y["meta"]
    # the float32 source round-trips to float16 leaves, as the JAX tool writes them
    back = load_checkpoint(ckpt)["params"]
    for k, v in _flat(x["params"]):
        np.testing.assert_array_equal(v, dict(_flat(back))[k].astype(np.float16).astype(
            np.float32), err_msg="/".join(k))
