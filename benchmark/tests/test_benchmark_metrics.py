"""The metric readers over synthetic windows: a rate and a tail taken over the
whole window move with a stall in it, the idle share and the idle gaps of a
synthetic trace, and a dropped trace record that cannot raise a share."""

import types

import numpy as np
import pytest

from benchmark import work as W
from benchmark.core import reader
from benchmark.trace import Trace


def ctx(**kw):
    base = dict(record={}, traced=None, trace=None, traffic={}, config={}, precision="int8", work=[])
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_rate_and_tail_cover_the_whole_window_with_a_stall():
    rng = np.random.default_rng(0)
    steady = list(rng.uniform(20, 30, 1000))
    stalled = list(steady)
    stalled[500:560] = [x + 400.0 for x in stalled[500:560]]  # a 0.4 s stall, 6% of requests
    p95 = reader("latency_p95_ms")
    assert p95(ctx(record={"latency_ms": steady})) < 31
    assert p95(ctx(record={"latency_ms": stalled})) > 400
    rate = reader("serve_img_s")
    assert rate(ctx(record={"images": 1000, "window_s": 10.0})) == pytest.approx(100.0)
    assert rate(ctx(record={"images": 1000, "window_s": 10.4})) < 97


def test_idle_share_and_gaps_of_a_synthetic_trace():
    t = Trace(window_s=1.0, busy_s=0.5,
              device=[("k1", 0.0, 0.3), ("k2", 0.2, 0.5)],
              spans=[("predict", 0.0, 0.8), ("preprocess", 0.8, 1.0)])
    assert reader("device_idle_pct.serve")(ctx(trace=t)) == pytest.approx(50.0)
    assert t.idle_gaps() == [(0.5, 1.0)]
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps == {"predict": pytest.approx(0.5)}
    assert reader("device_idle_pct.serve")(ctx(trace=None)) is None


def test_a_dropped_record_does_not_raise_the_conv_roofline():
    work = [W.ConvWork("c", "conv", 10 ** 9, 10 ** 6, 10 ** 4, 10 ** 6)]
    names = [("conv_s8_kernel<1>", 0.001 * i, 0.001 * i + 0.001) for i in range(10)]
    full = Trace(1.0, 0.01, names, [])
    dropped = Trace(1.0, 0.008, names[:8], [])
    rec = {"rows": 10, "launches": {"conv_s8_kernel": 10}}
    read = reader("conv_roofline_pct.serve")
    a = read(ctx(traced=rec, trace=full, work=work))
    b = read(ctx(traced=rec, trace=dropped, work=work))
    assert a == pytest.approx(b)
    assert a == pytest.approx(100 * W.least_seconds(work[0], "int8", 10) / 0.01)


def test_batcher_metrics():
    r = {"batch_rows": [8, 4, 8, 4], "max_batch": 8, "queue_wait_ms": list(range(100))}
    assert reader("batch_fill_pct.online")(ctx(record=r)) == pytest.approx(75.0)
    assert reader("queue_wait_ms_p95.online")(ctx(record=r)) == pytest.approx(94.05)
