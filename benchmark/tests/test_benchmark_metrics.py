"""The metric readers over synthetic windows: a rate and a tail taken over the
whole window move with a stall in it, the idle share and the idle gaps of a
synthetic trace, a dropped trace record that cannot raise a share, and work
of a family's own kind kept out of the conv rooflines."""

import types

import numpy as np
import pytest

from benchmark import work as W
from benchmark.core import reader
from benchmark.readers import BN_SILU_KERNELS
from benchmark.trace import Trace


def ctx(**kw):
    base = dict(record={}, traced=None, trace=None, traffic={}, config={}, precision="int8",
                work=[], family=None)
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


@pytest.mark.parametrize("precision,kernel", [("int8", "conv_s8_kernel<1>"),
                                              ("bf16", "sm90_xmma_fprop_implicit_gemm")])
def test_the_conv_roofline_reads_only_conv_work(precision, kernel):
    conv = W.ConvWork("c", "conv", 10 ** 9, 10 ** 6, 10 ** 4, 10 ** 6)
    other = W.ConvWork("a", "attention", 10 ** 10, 10 ** 7, 10 ** 5, 10 ** 7)
    t = Trace(1.0, 0.01, [(kernel, 0.001 * i, 0.001 * i + 0.001) for i in range(10)], [])
    rec = {"rows": 10, "launches": {"conv_s8_kernel": 10}}
    read = reader("conv_roofline_pct.serve")
    assert read(ctx(traced=rec, trace=t, work=[conv, other], precision=precision)) == \
        read(ctx(traced=rec, trace=t, work=[conv], precision=precision))


def test_the_conv_roofline_leaves_out_kernels_of_a_familys_other_kinds():
    conv = W.ConvWork("c", "conv", 10 ** 9, 10 ** 6, 10 ** 4, 10 ** 6)
    dw = W.ConvWork("d", "dwconv", 10 ** 7, 10 ** 6, 10 ** 2, 10 ** 6)
    fam = types.SimpleNamespace(KERNEL_KINDS={"depthwise": "dwconv", "xmma_fprop": "conv"})
    convs = [("sm90_xmma_fprop_implicit_gemm", 0.001 * i, 0.001 * i + 0.001) for i in range(10)]
    dws = [("void cudnn::depthwise_fprop_kernel", 0.01 + 0.001 * i, 0.011 + 0.001 * i)
           for i in range(5)]
    rec, read = {"rows": 10, "launches": {}}, reader("conv_roofline_pct.serve")
    alone = read(ctx(traced=rec, trace=Trace(1.0, 0.01, convs, []), work=[conv],
                     precision="bf16"))
    both = Trace(1.0, 0.015, convs + dws, [])
    assert read(ctx(traced=rec, trace=both, work=[conv, dw], family=fam, precision="bf16")) == \
        pytest.approx(alone)
    # a family without the table: the depthwise kernels' time counts
    assert read(ctx(traced=rec, trace=both, work=[conv, dw], precision="bf16")) == \
        pytest.approx(alone * 10 / 15)


def test_the_bn_silu_readers_count_dropped_records_and_read_nothing_without_kernels():
    work = [W.ConvWork("c", "conv", 0, 0, 0, 1000), W.ConvWork("p", "plain", 0, 0, 0, 10 ** 6)]
    fam = types.SimpleNamespace(convs=lambda cfg, tasks, ncs, h, w: work)
    kernels = ["bn_silu_stats_kernel<bf16>", "bn_silu_finalize_kernel", "bn_silu_apply_kernel",
               "bn_silu_grad_reduce_kernel", "bn_silu_grad_finalize_kernel", "bn_silu_dx_kernel"]
    launches = {"bn_stats": 8, "bn_apply": 4, "bn_grad_reduce": 8, "bn_dx": 4}
    full = [(k, 0.0, 0.001) for k in kernels for _ in range(4)]
    dropped = full[1:]  # one stats launch lost
    base = dict(config={"model": {}, "tasks": ["a", "b"], "nc": [1, 2]},
                traffic={"batch": 2, "img_size": 64}, family=fam,
                traced={"steps": 2, "launches": launches})
    assert W.BN_SILU_PASS_VALUES.keys() == BN_SILU_KERNELS.keys()
    ms, pct = reader("bn_silu_ms_per_step.train"), reader("bn_silu_roofline_pct.train")
    for dev in (full, dropped):
        c = ctx(trace=Trace(1.0, 0.024, dev, []), **base)
        assert ms(c) == pytest.approx(1e3 * 24 * 0.001 / 2)
        # 2 tasks x 2 images x 1000 values x (1 + 2 + 2 + 3) values moved a
        # value x 2 bytes, 2 steps, over 24 ms
        assert pct(c) == pytest.approx(100 * 2 * 2 * 1000 * 8 * 2 * 2 / W.PEAK_BYTES / 0.024)
    c = ctx(trace=Trace(1.0, 0.01, [("elementwise_kernel", 0.0, 0.01)], []), **base)
    assert ms(c) is None and pct(c) is None
