"""Model families: the yolov8 family reproduces, value for value, what the
harness computed before it had families (work lists, seeded weights, the
reference's head maps: digests taken then); a family added as a file in a
benchmark root runs its configuration's cells with no harness file changed;
an unknown family ends a run before its set-up."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.core import family, load_cell
from benchmark.reference.detect import letterbox
from benchmark.tests.tiny import make_root, tiny_config
from benchmark.weights import frames

HERE = Path(__file__).resolve().parent
CONFIGS = HERE.parent / "configs"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 8


def digest(tensors) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    """CPU convolutions sum in an order that follows the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,items,gflops,sha", [
    ("cerberusdet-v8x-2task", 155, 381.311744,
     "3dbc50cb57ba3384f5a9373dd91465e5a6685831877f2d043cf64f695c319aeb"),
    ("cerberusdet-v8x-3task", 207, 505.099776,
     "0a4786e16bc308864bde2aedcc9d27da75316cb275911a2452714a22f74de3fe"),
])
def test_yolov8_work_list_is_the_one_before_families(name, items, gflops, sha):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    work = family("yolov8").convs(cfg["model"], cfg["tasks"], cfg["nc"], 640, 640)
    assert len(work) == items
    assert 2e-9 * sum(c.macs for c in work) == pytest.approx(gflops, abs=1e-9)
    assert hashlib.sha256(json.dumps([list(c) for c in work]).encode()).hexdigest() == sha


def test_yolov8_weights_and_head_maps_are_the_ones_before_families(one_thread):
    fam, cfg = family("yolov8"), tiny_config()
    gen = torch.Generator().manual_seed(2 ** 31 + 23)
    calib = letterbox(frames(gen, 2, 48, 64, CPU), 64)
    w = fam.make_weights(cfg["model"], cfg["tasks"], cfg["nc"], gen, calib)
    assert len(w) == 459
    assert digest(w) == "597c9537340bfacae2a3e319635f22e96d188b5b23f918c9ccb1d5183cf7d12f"
    x = letterbox(frames(torch.Generator().manual_seed(7), 2, 48, 64, CPU), 64)
    maps = fam.Reference(cfg["model"], cfg["tasks"], cfg["nc"], w, torch.float32).features(x)
    assert digest({f"{t}.{i}": m for t, ms in maps.items() for i, m in enumerate(ms)}) == \
        "688a260c31cb9b6ce62cff842d5138201d35c9dc06cb74e74ef367d9be791aba"


def toy_root(tmp_path: Path) -> Path:
    """The tiny root with a `toy` family and every tiny cell's config in it:
    the neck's first stride-2 Conv of each branch a DWConv."""
    root = make_root(tmp_path, limit={"unmatched_share": 0.3, "bn_var_gap_median": 0.1,
                                      "change_gap_median": 0.5, "ema_change_gap_median": 0.5})
    shutil.copy(HERE / "toy_family.py", root / "benchmark" / "families" / "toy.py")
    cfg = tiny_config()
    assert cfg["model"]["neck"][6][2] == "Conv"
    cfg["model"]["neck"][6][2] = "DWConv"
    cfg["family"] = "toy"
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    return root


def test_a_family_added_as_files_counts_its_own_blocks(tmp_path):
    cell = load_cell("tiny-offline", toy_root(tmp_path))
    cfg = cell.config
    with pytest.raises(ValueError, match="no DWConv"):
        family("yolov8").convs(cfg["model"], cfg["tasks"], cfg["nc"], 64, 64)
    dw = [c for c in cell.family.convs(cfg["model"], cfg["tasks"], cfg["nc"], 64, 64)
          if c.kind == "dwconv"]
    assert len(dw) == 2  # one a task's branch
    shapes = cell.family.param_shapes(cfg["model"], cfg["tasks"], cfg["nc"])
    assert [shapes[f"blocks.{c.name}.w"] for c in dw] == [(64, 1, 3, 3)] * 2
    assert [c.macs for c in dw] == [4 * 4 * 64 * 9] * 2


def test_a_grouped_weight_runs_only_where_its_family_says_so(tmp_path):
    cell = load_cell("tiny-offline", toy_root(tmp_path))
    cfg, fam = cell.config, cell.family
    gen = torch.Generator().manual_seed(SEED)
    w = fam.make_weights(cfg["model"], cfg["tasks"], cfg["nc"], gen,
                         letterbox(frames(gen, 2, 48, 64, CPU), 64))
    x = letterbox(frames(gen, 1, 48, 64, CPU), 64)
    assert fam.Reference(cfg["model"], cfg["tasks"], cfg["nc"], w).features(x)
    with pytest.raises(RuntimeError):  # the yolov8 reference groups nothing
        family("yolov8").Reference(fam.as_v8(cfg["model"]), cfg["tasks"], cfg["nc"],
                                   w).features(x)


@pytest.mark.parametrize("cell", ["tiny-offline", "tiny-train"])
def test_a_family_added_as_files_runs_correct(tmp_path, capsys, monkeypatch, cell):
    from cerberusdet_tpu_torch.nn.layers import DWConv

    built = []
    init = DWConv.__init__
    monkeypatch.setattr(DWConv, "__init__", lambda self, *a, **k: built.append(a) or init(
        self, *a, **k))
    assert run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0", "--trace", "0"],
                    device=CPU, root=toy_root(tmp_path)) == 0
    assert built  # the program built the family's block
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0


def test_an_unknown_family_ends_the_run_before_set_up(tmp_path, monkeypatch):
    from benchmark.drivers import offline

    root = make_root(tmp_path)
    cfg = tiny_config()
    cfg["family"] = "yolov99"
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(offline.Session, "__init__", lambda *a, **k: pytest.fail("set up"))
    with pytest.raises(SystemExit, match="no model family 'yolov99'"):
        run.main(["--workload", "tiny-offline", "--seed", "1", "--seconds", "0", "--trace", "0"],
                 device=CPU, root=root)
