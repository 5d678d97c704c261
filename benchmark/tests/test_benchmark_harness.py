"""The harness driven as the driver drives it, on the CPU at a tiny size
(tiny.py): a cell, a traffic mix and a per-layer metric added as files are
found by name; a sound run is correct and a run with its timed path broken
underneath is not; no card, or a JAX module loaded, ends a run without a
result."""

import json
import sys
import types

import pytest
import torch

from benchmark import run, serving
from benchmark.core import forbidden_modules
from benchmark.drivers import offline
from benchmark.faults import plant
from benchmark.tests.tiny import make_root

CPU = torch.device("cpu")
SEED = 2 ** 31 + 8  # beyond 32 signed bits, as the driver's seeds are


def result(capsys):
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return (json.loads(lines[-1]) if lines else None), err.strip().splitlines()


def args(cell, seconds=0.0, trace=0, seed=SEED):
    return ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path, capsys):
    root = make_root(tmp_path)
    b = root / "benchmark"
    traffic = json.loads((b / "traffic" / "tiny-offline.json").read_text())
    traffic["batch"] = 4
    (b / "traffic" / "added_b4.json").write_text(json.dumps(traffic))
    (b / "limits" / "added-cell.json").write_text((b / "limits" / "tiny-offline.json").read_text())
    (b / "metrics" / "rows_seen.added.py").write_text(
        "def read(ctx):\n    return float(ctx.record['rows'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "added-cell", "config": "tiny", "traffic": "added_b4",
                               "chips": 1, "why": "added as files"})
    bench["per_layer"].append({"name": "rows_seen.added", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "serve batcher",
                               "moves": "serve_img_s", "workloads": ["added-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert run.main(args("added-cell", trace=1), device=CPU, root=root) == 0
    line, err = result(capsys)
    assert line["metrics"]["rows_seen.added"] == {"value": 4.0, "unit": "rows"}
    assert list(line)[-1] == "compared"
    assert err[-1].startswith("compared unmatched_share ")


@pytest.mark.parametrize("fault,limit", [("", 0.3), ("half", 0.3), ("altered", 0.3),
                                         ("", 0.04), ("no_nms", 0.04)])
def test_serving_run_is_correct_unless_broken(tmp_path, capsys, monkeypatch, fault, limit):
    """At the tiny cell a sound run reads 0 and NMS skipped 0.06 (the tiny
    model's candidates seldom overlap), so that fault is read at 0.04."""
    root = make_root(tmp_path, limit=limit)
    monkeypatch.setattr(serving, "CHECKED", 1.0)
    monkeypatch.setattr(offline, "CHECKED", 1.0)
    warm = offline.Session.warm

    def warm_then_break(self):
        warm(self)
        if fault:
            plant(self, fault)

    monkeypatch.setattr(offline.Session, "warm", warm_then_break)
    assert run.main(args("tiny-offline"), device=CPU, root=root) == 0
    line, _ = result(capsys)
    assert line["correct"] is (fault == "")
    assert line["attempted"] == 8 and set(line["metrics"]) == {
        "serve_img_s", "latency_p95_ms", "train_img_s", "setup_s"} - {"latency_p95_ms"}


@pytest.mark.parametrize("fault", ["", "half", "unchanged", "ema_unchanged"])
def test_train_run_is_correct_unless_broken(tmp_path, capsys, monkeypatch, fault):
    from benchmark.drivers import train

    root = make_root(tmp_path, limit={"bn_var_gap_median": 0.1, "change_gap_median": 0.5,
                                      "ema_change_gap_median": 0.5})
    init = train.Session.__init__
    monkeypatch.setattr(train.Session, "__init__",
                        lambda self, *a, **k: init(self, *a, **k, fault=fault))
    assert run.main(args("tiny-train"), device=CPU, root=root) == 0
    line, _ = result(capsys)
    assert line["correct"] is (fault == "")


def test_online_run_answers_every_request(tmp_path, capsys):
    root = make_root(tmp_path)
    assert run.main(args("tiny-online", seconds=1.0), device=CPU, root=root) == 0
    line, _ = result(capsys)
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["metrics"]["latency_p95_ms"]["value"] > 0


def test_a_traced_run_reads_the_host_clock_in_its_untraced_window(tmp_path, capsys,
                                                                   monkeypatch):
    """--trace 1 runs two windows: the batcher's and mfu's metrics come from
    the first, the trace's from the second; both windows' requests count."""
    from benchmark.drivers import online

    root = make_root(tmp_path)
    seen = []
    window = online.Session.window

    def record_window(self, seconds):
        window(self, seconds)
        seen.append(self.record)

    monkeypatch.setattr(online.Session, "window", record_window)
    assert run.main(args("tiny-online", seconds=1.0, trace=1), device=CPU, root=root) == 0
    line, err = result(capsys)
    assert len(seen) == 2 and line["attempted"] == seen[0]["requests"] + seen[1]["requests"]
    fill = 100.0 * sum(seen[0]["batch_rows"]) / (len(seen[0]["batch_rows"]) * 4)
    assert line["metrics"]["batch_fill_pct.online"]["value"] == pytest.approx(fill)
    assert {"batch_fill_pct.online", "queue_wait_ms_p95.online", "mfu.online"} <= set(
        line["metrics"])
    assert not any(k.startswith(("device_idle", "conv_roofline")) for k in line["metrics"])
    assert '"traced_window"' in next(x for x in err if x.startswith("benchmark: {"))


def test_no_card_no_result(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(args("tiny-offline"), root=make_root(tmp_path)) == 2
    line, err = result(capsys)
    assert line is None and "needs 1 CUDA device" in err[-1]


def test_a_jax_module_loaded_after_the_window_ends_the_run(tmp_path, capsys, monkeypatch):
    import cerberusdet_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert "cerberusdet_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(args("tiny-offline"), device=CPU, root=make_root(tmp_path)) == 3
    line, err = result(capsys)
    assert line is None and err[-1] == "benchmark: loaded after the window: jax"
