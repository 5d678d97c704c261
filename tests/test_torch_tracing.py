"""The port's tracing (utils/tracing.py) and the spans and counters it is
given in the serving path, the batcher and the captured steps, with the
benchmark's readers of them (benchmark/metrics), on the CPU at
yolov8n_2task, 64 px:

  * spans nest and take their parents per thread, across two threads;
  * the ring wraps, counts what it wrote over, and a window that may have
    lost records reads None;
  * under a CPU torch.profiler every span is a "cd." range, nested as the
    spans are, and `predict` records predict -> unpack -> format in order;
  * BatchingEngine's batch, queue and child spans, and its cumulative
    counters, over partial, full and failing batches;
  * each reader on a synthetic ring, and its None cases.

A span is written into the ring that numbered it; replays whose stages
are read come READ_GAP_S apart. summarize_trace splits the idle over the
spans of a ring dump placed on a trace's clock. The tests marked `cuda`
(run on the card with `-m cuda --noconftest`) hold the captured serving
program's stage marks: read after a replay, they tile it.
"""

import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from benchmark.core import reader
from cerberusdet_tpu_torch.infer import CerberusDetInference, CerberusPreprocessor
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.serve import BatchingEngine
from cerberusdet_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["t1", "t2"], [2, 3]
NAMES = {"t1": ["a", "b"], "t2": ["x", "y", "z"]}


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring in the module's place, so that a test reads only its own."""
    r = tracing.Ring()
    monkeypatch.setattr(tracing, "RING", r)
    return r


def _window(t0_ns):
    return tracing.window(t0_ns / 1e9, (time.perf_counter_ns() - t0_ns) / 1e9 + 1e-3)


def _names_parents(w, idx):
    return [(w.names[i], w._parents(np.array([i]))[0]) for i in idx]


def test_spans_nest_per_thread(ring):
    t0 = time.perf_counter_ns()
    ready = threading.Barrier(2)

    def work(tag):
        with tracing.span("outer." + tag, 7):
            ready.wait(timeout=30)  # both threads hold a span open at once
            with tracing.span("inner." + tag):
                pass
        with tracing.span("after." + tag):  # a root again
            pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    w = _window(t0)
    for tag in "ab":
        (outer,) = w.spans(("outer." + tag,))
        (inner,) = w.spans(("inner." + tag,))
        (after,) = w.spans(("after." + tag,))
        assert _names_parents(w, [inner, outer, after]) == [
            ("inner." + tag, "outer." + tag), ("outer." + tag, ""), ("after." + tag, "")]
        assert w.col["value"][outer] == 7
        assert w.col["t0"][outer] <= w.col["t0"][inner] <= w.col["t1"][inner] \
            <= w.col["t1"][outer]


def test_a_span_is_written_into_the_ring_that_numbered_it(monkeypatch):
    """A span that closes after another ring took RING's place (a thread's
    span left open across a test's swap) writes into its own ring, not at
    its number's slot of the new one."""
    old, new = tracing.Ring(), tracing.Ring()
    monkeypatch.setattr(tracing, "RING", old)
    for _ in range(3):
        old.number()
    s = tracing.span("left_open")
    s.__enter__()
    monkeypatch.setattr(tracing, "RING", new)
    with tracing.span("mine"):  # numbered 0 in the new ring
        pass
    s.__exit__(None, None, None)
    assert [new.names[i] for i in new.rec["name"][new.rec["seq"] >= 0]] == ["mine"]
    assert [old.names[i] for i in old.rec["name"][old.rec["seq"] >= 0]] == ["left_open"]
    assert old.rec["seq"][3] == 3


def test_replays_to_read_are_read_gap_apart(monkeypatch):
    marks = tracing.StageMarks()
    assert [marks.launched(i) for i in range(3)] == [0, 0, 0]  # a graph without marks
    marks = tracing.StageMarks()
    marks.stages = [("forward", 0)]
    monkeypatch.setattr(tracing, "READ_GAP_S", 60.0)
    assert [marks.launched(i) for i in range(4)] == [1, 0, 0, 0]  # the first only
    assert marks._pending is None  # the last launch is not one to read
    monkeypatch.setattr(tracing, "READ_GAP_S", 0.0)
    assert [marks.launched(i) for i in range(3)] == [1, 1, 1]
    assert marks._pending == (2, tracing.RING)


def test_ring_wraps_and_counts_what_it_wrote_over(monkeypatch):
    r = tracing.Ring(capacity=8)
    monkeypatch.setattr(tracing, "RING", r)
    for i in range(5):
        tracing.record("a", 1000 + i, 1001 + i)
    assert r.overwritten() == 0
    assert tracing.Window(r, 1000, 3000).complete
    for i in range(7):
        tracing.record("b", 2000 + i, 2001 + i)
    assert r.overwritten() == 4
    assert sorted(r.rec["seq"].tolist()) == list(range(4, 12))  # the 8 newest kept
    # the records written over (1000-1003) started before the oldest kept one
    # (1004): a window from 1005 lost none of its own, one from 1000 did
    late = tracing.Window(r, 1005, 3000)
    assert late.complete and len(late.spans(("b",))) == 7
    assert late.host_ms_per(("b",), (), "b") == pytest.approx(1e-6)
    early = tracing.Window(r, 1000, 3000)
    assert not early.complete
    assert early.host_ms_per(("b",), (), "b") is None


@pytest.fixture(scope="module")
def inference():
    torch.manual_seed(0)
    return CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu"),
                                names=NAMES, img_size=64, half=False, conf_thres=1e-4,
                                device="cpu")


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (48, 64, 3), dtype=np.uint8) for _ in range(n)]


def test_predict_records_its_spans_in_order(ring, inference):
    pre = CerberusPreprocessor(img_size=64, device="cpu")
    t0 = time.perf_counter_ns()
    x, shapes = pre.preprocess(_frames(2))
    out = inference.predict(x, original_shape=shapes)
    assert len(out) == 2
    # the window the readers below are given: these calls and nothing after them
    ctx = types.SimpleNamespace(record={"t0": t0 / 1e9,
                                        "window_s": (time.perf_counter_ns() - t0) / 1e9},
                                traffic={})
    w = tracing.window(ctx.record["t0"], ctx.record["window_s"])
    order = np.argsort(w.col["t0"][w.inside])
    names = list(w.names[w.inside][order])
    assert names == ["preprocess", "stack", "predict", "unpack", "format"]
    idx = np.flatnonzero(w.inside)[order]
    assert [p for _, p in _names_parents(w, idx)] == ["", "preprocess", "", "predict",
                                                       "predict"]
    assert w.col["value"][w.spans(("predict",))][0] == 2
    # the host readers of the offline cells read this window
    assert reader("host_format_ms_per_batch.serve")(ctx) == pytest.approx(
        float(w.ms(w.spans(("unpack", "format"))).sum()))
    assert reader("host_copy_in_ms_per_batch.serve")(ctx) == pytest.approx(
        float(w.ms(w.spans(("stack",))).sum()))
    assert reader("nms_ms_per_batch.serve")(ctx) is None  # no replay on the CPU


def test_spans_are_profiler_ranges_nested_as_the_spans(ring, inference):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(1, 64, 64, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inference.predict(x)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("cd."):
            assert e.device_type() == DeviceType.CPU
            ranges[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    assert set(ranges) == {"cd.predict", "cd.unpack", "cd.format"}
    a, b = ranges["cd.predict"]
    for child in ("cd.unpack", "cd.format"):
        assert a <= ranges[child][0] <= ranges[child][1] <= b
    assert ranges["cd.unpack"][1] <= ranges["cd.format"][0]
    inference.predict(x)  # without a profiler: no range, the span still recorded
    assert len(_window(0).spans(("predict",))) == 2


class _Pre:
    def preprocess(self, imgs):
        return torch.stack([torch.as_tensor(im, dtype=torch.float32) for im in imgs]), \
            [im.shape[:2] for im in imgs]


class _Held:
    """An inference stand-in that holds its first call until released, so
    that the requests sent meanwhile queue into one batch; it fails on a
    batch whose first pixel is 99."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()
        self.calls = 0

    def predict(self, batch, original_shape=None):
        self.calls += 1
        if self.calls == 1:
            self.entered.set()
            assert self.release.wait(timeout=60)
        if float(batch[0, 0, 0, 0]) == 99:
            raise RuntimeError("bad batch")
        return [[{"row": int(b[0, 0, 0])}] for b in batch]


def test_engine_spans_and_counters(ring):
    held = _Held()
    t0 = time.perf_counter_ns()  # the runner opens its first batch span as it starts
    engine = BatchingEngine(held, _Pre(), max_batch=4, max_wait_ms=50.0)
    try:
        img = lambda v: np.full((2, 2, 3), v, np.uint8)
        first = engine.submit(img(1))  # a partial batch of 1, held in predict
        assert held.entered.wait(timeout=60)
        full = [engine.submit(img(v)) for v in (2, 3, 4, 5)]  # one full batch of 4
        held.release.set()
        assert first.result(timeout=60) == [{"row": 1}]
        assert [f.result(timeout=60) for f in full] == [[{"row": v}] for v in (2, 3, 4, 5)]
        bad = engine.submit(img(99))  # a failing partial batch
        with pytest.raises(RuntimeError, match="bad batch"):
            bad.result(timeout=60)
        for _ in range(200):  # the runner counts the failure after resolving it
            if engine.stats["errors"]:
                break
            time.sleep(0.01)
        s = engine.stats
        assert {k: s[k] for k in ("requests", "batches", "errors", "rows", "padded_rows")} == \
            {"requests": 5, "batches": 2, "errors": 1, "rows": 8, "padded_rows": 3}
        assert s["latency_ms_sum"] >= s["queue_ms_sum"] > 0
    finally:
        engine.stop()
    w = _window(t0)
    batches = w.spans(("batch",))
    assert sorted(w.col["value"][batches].tolist())[-3:] == [1, 1, 4]
    queues = w.spans(("queue",), ("batch",))
    assert len(queues) == 6
    by_batch = {}
    for i in queues:
        by_batch.setdefault(int(w.col["parent"][i]), []).append(i)
    assert sorted(len(v) for v in by_batch.values()) == [1, 1, 4]
    for name in ("wait_first", "fill", "pad", "resolve"):
        assert len(w.spans((name,), ("batch",))) >= 2, name
    assert len(w.spans(("resolve",))) == 2  # the failing batch resolves nothing
    answered = queues[np.argsort(w.col["t0"][queues])][:5]  # the failing request came last
    assert s["queue_ms_sum"] == pytest.approx(float(w.ms(answered).sum()))
    ctx = types.SimpleNamespace(record={"t0": t0 / 1e9, "window_s": 60.0},
                                traffic={"max_batch": 4})
    assert reader("batcher_fill_pct.online")(ctx) == pytest.approx(100.0 * 6 / 12)
    assert reader("batcher_queue_ms_p95.online")(ctx) == pytest.approx(
        float(np.percentile(w.ms(queues), 95)))


def _replay(ring, parent, t, stages, read=True, value=1):
    """A synthetic launch: a `parent` span holding a `replay` span (value 1:
    one to read), and the replay's stage records (name, ms) where read."""
    p, r = ring.number(), ring.number()
    ring.write(r, "replay", tracing.SPAN, t + 10, t + 20, p, value)
    if read:
        k = {}
        for name, ms in stages:
            ring.write(ring.number(), name, tracing.STAGE, t + 30, t + 30 + int(ms * 1e6), r,
                       k.setdefault(name, 0))
            k[name] += 1
    ring.write(p, parent, tracing.SPAN, t, t + 40, -1, 8)


SERVE = [("forward", 5.0), ("nms", 0.5), ("cross_task", 2.0), ("pack", 0.1)]
TRAIN = [("forward_loss", 10.0), ("backward", 20.0), ("forward_loss", 11.0), ("backward", 21.0),
         ("clip", 1.0), ("optimizer", 2.0), ("ema", 3.0)]


def _ctx(t0_ns, seconds, **traffic):
    return types.SimpleNamespace(record={"t0": t0_ns / 1e9, "window_s": seconds},
                                 traffic=traffic)


@pytest.mark.parametrize("metric,parent,stages,want", [
    ("nms_ms_per_batch.serve", "predict", SERVE, 0.5),
    ("cross_task_ms_per_batch.serve", "predict", SERVE, 2.0),
    ("cross_task_ms_per_batch.online", "predict", SERVE, 2.0),
    ("forward_loss_ms_per_step.train", "train.step", TRAIN, 21.0),
    ("backward_ms_per_step.train", "train.step", TRAIN, 41.0),
    ("optimizer_ema_ms_per_step.train", "train.step", TRAIN, 6.0),
])
def test_stage_readers(ring, metric, parent, stages, want):
    read = reader(metric)
    base = 10 ** 12
    for i in range(20):  # 10 s windows, a launch a second from base
        _replay(ring, parent, base + i * 10 ** 9, stages, read=i != 3)
    assert read(_ctx(base, 10.0)) == pytest.approx(want)  # 9 of 10 read
    assert read(_ctx(base, 20.0)) == pytest.approx(want)  # 19 of 20
    for i in range(20):  # replays not to read (value 0) count neither way
        _replay(ring, parent, base + i * 10 ** 9 + 10 ** 8, stages, read=False, value=0)
    assert read(_ctx(base, 10.0)) == pytest.approx(want)
    _replay(ring, parent, base + 5 * 10 ** 8, stages, read=False)
    assert read(_ctx(base, 10.0)) is None  # 9 of 11 read: under 90%
    assert read(_ctx(base + 30 * 10 ** 9, 10.0)) is None  # no record in the window
    other = "train.step" if parent == "predict" else "predict"
    for i in range(3):  # another program's launches are not read
        _replay(ring, other, base + 40 * 10 ** 9 + i, stages)
    assert read(_ctx(base + 40 * 10 ** 9, 1.0)) is None


def test_host_readers_and_their_none_cases(monkeypatch):
    r = tracing.Ring(capacity=64)
    monkeypatch.setattr(tracing, "RING", r)
    base = 10 ** 12

    def batch(t):
        pre, pred = r.number(), r.number()
        tracing.record("stack", t + 1, t + 2 * 10 ** 6 + 1, pre)
        tracing.record("copy_in", t + 3, t + 3 * 10 ** 6 + 3, pre)
        r.write(pre, "preprocess", tracing.SPAN, t, t + 10 ** 7, -1, 32)
        tracing.record("copy_in", t + 2 * 10 ** 7, t + 21 * 10 ** 6, pred)
        tracing.record("copy_out", t + 3 * 10 ** 7, t + 4 * 10 ** 7, pred)
        tracing.record("unpack", t + 4 * 10 ** 7, t + 41 * 10 ** 6, pred)
        tracing.record("format", t + 5 * 10 ** 7, t + 6 * 10 ** 7, pred)
        r.write(pred, "predict", tracing.SPAN, t + 11 * 10 ** 6, t + 7 * 10 ** 7, -1, 32)

    for i in range(4):
        batch(base + i * 10 ** 8)
    copy_in, fmt = reader("host_copy_in_ms_per_batch.serve"), reader(
        "host_format_ms_per_batch.serve")
    assert copy_in(_ctx(base, 1.0)) == pytest.approx(2 + 3 + 1)
    assert fmt(_ctx(base, 1.0)) == pytest.approx(1 + 10)
    assert fmt(_ctx(base + 10 ** 10, 1.0)) is None  # no record in the window
    assert fmt(types.SimpleNamespace(record={}, traffic={})) is None  # a record without a window
    for i in range(4, 12):  # 64 entries hold 7 batches: the window at base lost records
        batch(base + i * 10 ** 8)
    assert r.overwritten() > 0
    assert fmt(_ctx(base, 1.0)) is None
    assert fmt(_ctx(base + 10 * 10 ** 8, 0.2)) == pytest.approx(11)
    for name in ("batcher_queue_ms_p95.online", "batcher_fill_pct.online"):
        assert reader(name)(_ctx(base + 10 * 10 ** 8, 0.2, max_batch=8)) is None


def test_summarize_trace_lists_idle_by_the_innermost_span(tmp_path, capsys):
    import json

    from cerberusdet_tpu_torch.tools import summarize_trace

    dev = lambda name, ts, dur, cat="kernel": {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                               "dur": dur, "pid": 0, "tid": 7}
    host = lambda name, ts, dur, cat="cpu_op": {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                                "dur": dur, "pid": 1, "tid": 1}
    events = [dev("void quant_nchw_kernel<__nv_bfloat16>(...)", 0, 10),
              dev("void conv_s8_kernel<128, 160>(...)", 5, 15),        # busy 0-20
              dev("Memcpy DtoH (Device -> Pinned)", 30, 5, "gpu_memcpy"),  # idle 20-30
              dev("nms_kernel(...)", 50, 10),                           # idle 35-50
              dev("cd.predict", 0, 60, "gpu_user_annotation"),           # not device work
              host("cd.predict", 0, 100, "user_annotation"),
              host("cd.replay", 1, 3), host("cd.copy_out", 19, 16),
              host("cd.format", 36, 12), host("bench.predict", 0, 100, "user_annotation")]
    (tmp_path / "x.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    out = summarize_trace.main([str(tmp_path), "--min-ms", "0"])
    assert out["by_category"]["quant_s8"] == pytest.approx(0.01)
    assert out["total_ms"] == pytest.approx(0.04)  # the durations summed
    # 20-30 inside copy_out; 35-50 inside predict, format holding 36-48
    assert out["idle_by_span"] == {"copy_out": pytest.approx(0.01),
                                   "format": pytest.approx(0.012),
                                   "predict": pytest.approx(0.003)}
    assert "by the innermost cd. span" in capsys.readouterr().out
    gaps = summarize_trace.idle_gaps(summarize_trace.device_events(events))
    assert summarize_trace.idle_by_span(gaps, []) == {summarize_trace.OUTSIDE: 25}


def test_summarize_trace_places_the_ring_on_the_trace_clock(tmp_path, capsys, monkeypatch):
    """--ring: the spans of a thread the profiler did not record (here
    `fill`, `format` and a request's `queue`) split the idle once the ring
    is moved onto the trace's clock by the spans both hold (`clock`)."""
    import json

    from cerberusdet_tpu_torch.tools import summarize_trace

    dev = lambda ts, dur: {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur}
    host = lambda name, ts, dur: {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur}
    events = [dev(0, 10), dev(30, 10), dev(60, 10),  # idle 10-30 and 40-60
              host("cd.clock", 0, 2), host("cd.clock", 70, 3)]
    (tmp_path / "t.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    ring = tracing.Ring()
    monkeypatch.setattr(tracing, "RING", ring)
    ns = lambda us: int((us + 5000) * 1000)  # the ring's clock: 5 ms after the trace's
    for name, a, b in [("clock", 0, 2), ("fill", 10, 30), ("queue", 5, 60), ("format", 40, 50),
                       ("clock", 70, 73), ("clock", 500, 502)]:
        tracing.record(name, ns(a), ns(b))
    tracing.save(tmp_path / "ring.npz")
    out = summarize_trace.main([str(tmp_path), "--ring", str(tmp_path / "ring.npz"),
                                "--min-ms", "0"])
    assert out["aligned"] == {"matched": 2, "traced": 2, "offset_spread_us": 0.0}
    assert out["idle_by_span"] == {"fill": pytest.approx(0.02), "format": pytest.approx(0.01),
                                   summarize_trace.OUTSIDE: pytest.approx(0.01)}
    assert "the ring's, every thread" in capsys.readouterr().out
    spans = summarize_trace.host_spans(summarize_trace.load_trace(tmp_path))
    with pytest.raises(ValueError, match="a tracing.span has to be open"):
        summarize_trace.ring_spans(tmp_path / "ring.npz", [(n + "x", a, b) for n, a, b in spans])


# ----------------------------------------------------------------- the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_serving_stages_tile_the_replay_on_card(ring, monkeypatch):
    """On the card: each replay's four stages are read after predict (every
    replay here), and they sum to the replay's time between CUDA events
    around it, less the launch."""
    _needs_card()
    monkeypatch.setattr(tracing, "READ_GAP_S", 0.0)  # every replay read
    torch.manual_seed(0)
    inf = CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cuda"), names=NAMES,
                               img_size=64, conf_thres=1e-4, device="cuda")
    x = torch.rand(2, 64, 64, 3, device="cuda")
    t0 = time.perf_counter_ns()
    for _ in range(4):
        inf.predict(x)
    (prog,) = inf.programs.values()
    assert [n for n, _ in prog.marks.stages] == ["forward", "nms", "cross_task", "pack"]
    w = _window(t0)
    replays = w.spans(("replay",), ("predict",))
    assert len(replays) == 4 and len(w.spans(("capture",), ("predict",))) == 1
    assert w.col["value"][replays].tolist() == [1, 1, 1, 1]
    for name, _ in SERVE:
        assert len(w.col["seq"][(w.names == name) & (w.col["kind"] == tracing.STAGE)]) == 4
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    prog.replay()
    b.record()
    torch.cuda.synchronize()
    prog.marks.collect()
    w = _window(t0)
    last = w.col["seq"][w.spans(("replay",))][-1]
    stages = w.col["kind"] == tracing.STAGE
    total = float(((w.col["t1"] - w.col["t0"])[stages & (w.col["parent"] == last)]).sum()) / 1e6
    assert 0.5 * a.elapsed_time(b) <= total <= a.elapsed_time(b)
    ctx = types.SimpleNamespace(record={"t0": t0 / 1e9, "window_s": 60.0}, traffic={})
    assert reader("nms_ms_per_batch.serve")(ctx) > 0
    assert reader("cross_task_ms_per_batch.serve")(ctx) > 0
