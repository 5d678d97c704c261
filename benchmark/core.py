"""The harness's data: BENCHMARK.json, and the files it names, found by name.

  configs/<config>.json   the model as it is run (the yaml's rows, tasks, classes);
                          "family" names its model family (absent: FAMILY)
  families/<family>.py    everything that depends on the model's blocks, for a
                          config's model dict, tasks and class counts:
                            convs(cfg, tasks, ncs, h, w): [work.ConvWork] of one
                              (3, h, w) image's all-heads forward
                            param_shapes(cfg, tasks, ncs): {name: shape}, in the
                              program's parameter names
                            make_weights(cfg, tasks, ncs, gen, calib, served=None):
                              the seeded float32 weights (weights.py)
                            Reference(cfg, tasks, ncs, weights, dtype, quant_bits=None,
                              act_dtype=None): serving's plain reference (features,
                              forward, calibrate; its amax)
                            TrainReference(cfg, tasks, ncs, weights, conv_cast=None):
                              the plain train step (step, params, buf, ema, ref)
  traffic/<traffic>.json  the traffic mix one driver (drivers/<kind>.py) reads
  limits/<cell>.json      each compared number's limit, the readings it was
                          set from, and the control's precision
  metrics/<metric>.py     a reader: read(ctx) -> a number, or None where the
                          run has nothing for it to read
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import types
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cerberusdet_tpu")
FAMILY = "yolov8"  # the family of a configuration that names none


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    family: types.ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files read from the
    benchmark's folders under root."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "benchmark"
    config = load_json(root / cfg["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(here / "limits" / f"{name}.json"),
        family=family(config.get("family", FAMILY), root),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def _module(path: Path, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The `read` function of root/benchmark/metrics/<name>.py."""
    return _module(root / "benchmark" / "metrics" / f"{name}.py", f"benchmark_metric_{name}").read


def family(name: str, root: Path = ROOT) -> types.ModuleType:
    """The module root/benchmark/families/<name>.py; an unknown name ends the
    run before its set-up."""
    path = root / "benchmark" / "families" / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in path.parent.glob("*.py"))
        raise SystemExit(f"no model family {name!r} in benchmark/families (has {have})")
    return _module(path, f"benchmark_family_{name}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(numbers: Dict[str, float], limits: dict) -> bool:
    """True when every compared number is at most its limit."""
    return all(numbers[k] <= v["limit"] for k, v in limits["numbers"].items())


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
                device: dict, compared: Dict[str, float], limits: dict,
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": compared[k], "limit": v["limit"]}
                       for k, v in limits["numbers"].items()}
    return json.dumps(out)
