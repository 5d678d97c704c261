"""The benchmark's work functions: the op counter against the published
GFLOPs and parameter counts of both configurations, and the least-time
arithmetic."""

import json
from pathlib import Path

import pytest

from benchmark import work as W

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


@pytest.mark.parametrize("name", ["cerberusdet-v8x-2task", "cerberusdet-v8x-3task"])
def test_counter_matches_published(name):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    convs = W.convs(cfg["model"], cfg["tasks"], cfg["nc"], 640, 640)
    pub = cfg["published"]
    assert W.forward_ops(convs) / 1e9 == pytest.approx(pub["gflops_at_640"], abs=0.05)
    assert sum(c.w_elems for c in convs) / 1e6 == pytest.approx(pub["params_millions"], rel=0.01)


def test_least_seconds_takes_the_larger_bound():
    big = W.ConvWork("big", "conv", macs=10 ** 9, in_elems=10, w_elems=10, out_elems=10)
    wide = W.ConvWork("wide", "conv", macs=1, in_elems=10 ** 9, w_elems=0, out_elems=0)
    assert W.least_seconds(big, "int8", 1) == pytest.approx(2e9 / W.PEAK_OPS["int8"])
    assert W.least_seconds(wide, "bf16", 1) == pytest.approx(2e9 / W.PEAK_BYTES)
    assert W.least_seconds(wide, "int8", 1) == pytest.approx(1e9 / W.PEAK_BYTES)


def test_peak_seconds_keeps_the_towers_last_conv_at_bf16():
    c = W.ConvWork("c", "conv", 10 ** 9, 0, 0, 0)
    p = W.ConvWork("p", "plain", 10 ** 9, 0, 0, 0)
    assert W.peak_seconds([c, p], "int8", 2) == pytest.approx(
        4e9 / W.PEAK_OPS["int8"] + 4e9 / W.PEAK_OPS["bf16"])
