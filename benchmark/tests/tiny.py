"""A tiny benchmark root for CPU tests: BENCHMARK.json with cells of the
2-task yolov8n at 64 px, and the files they name, in a temporary directory;
the metric readers and the model families are copied from this folder."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import yaml

HERE = Path(__file__).resolve().parent.parent
REPO = HERE.parent
TINY = {"frame": [240, 320], "img_size": 320, "pool": 8, "calib_frames": 4, "conf": 0.25,
        "iou": 0.45, "iou_between": 0.8, "max_det": 300}
CELLS = {
    "tiny-offline": ("offline", {"kind": "offline", "precision": "int8", "batch": 8, **TINY}),
    "tiny-online": ("online", {"kind": "online", "precision": "int8", "max_batch": 4,
                               "max_wait_ms": 5.0, "rate_per_s": 40.0, **TINY}),
    "tiny-train": ("train", {"kind": "train", "precision": "bf16", "batch": 2, "img_size": 128,
                             "max_labels": 30, "real_labels": 6, "pool_steps": 4,
                             "checked_steps": 3, "calib_frames": 2, "lr0": 0.01,
                             "warmup_iters": 1000, "warmup_bias_lr": 0.1, "momentum": 0.937,
                             "warmup_momentum": 0.8}),
}
INT8_REFERENCE = {"quant_bits": 8, "calib_dtype": "bfloat16", "act_dtype": "bfloat16"}
LIMITS = {"offline": {"numbers": {"unmatched_share": {}}, "control": {"quant_bits": 4},
                      "reference": INT8_REFERENCE},
          "online": {"numbers": {"unmatched_share": {}}, "control": {"quant_bits": 4},
                     "reference": INT8_REFERENCE},
          "train": {"numbers": {"bn_var_gap_median": {}, "change_gap_median": {},
                                "ema_change_gap_median": {}},
                    "control": {"cast": "fp8"}}}


def tiny_config() -> dict:
    return {"name": "tiny", "model": yaml.safe_load(open(REPO / "configs/models/yolov8n_2task.yaml")),
            "tasks": ["voc", "animals"], "nc": [20, 19],
            "names": [[f"a{i}" for i in range(20)], [f"b{i}" for i in range(19)]]}


def make_root(tmp: Path, limit=0.5) -> Path:
    """tmp as a benchmark root holding the tiny cells; returns it. limit: every
    compared number's limit, or {number: limit}."""
    b = tmp / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (b / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "families"):
        shutil.copytree(HERE / d, b / d, dirs_exist_ok=True)
    (b / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = []
    for cell, (traffic, spec) in CELLS.items():
        (b / "traffic" / f"{cell}.json").write_text(json.dumps(spec))
        limits = json.loads(json.dumps(LIMITS[traffic]))
        for k, v in limits["numbers"].items():
            v["limit"] = limit.get(k, 0.5) if isinstance(limit, dict) else limit
        (b / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": cell, "chips": 1,
                                   "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
