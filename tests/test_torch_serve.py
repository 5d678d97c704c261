"""The port's serving daemon (serve/server.py, cli/serve.py) against the JAX
package's (cerberusdet_tpu/serve, root serve.py), on the CPU at
yolov8n_2task, 64 px, after tests/test_serve.py.

  * The engine batches and resolves; HTTP /predict, /healthz, /stats; a bad
    body 400; an oversize body 413 and a bad Content-Length 400; unknown
    paths 404; an engine failure reaches every waiter and counts `errors`.
  * Concurrent requests are batched: the runner is held inside its first
    batch while four more requests queue, so the count of batches is
    deterministic (2 for 5 requests).
  * Every batch `predict` sees is padded to max_batch rows of one shape and
    dtype, on the device or host path alike.
  * Parity: the port's and the JAX package's engines, both in float64 (JAX
    under enable_x64, as tests/test_torch_inference.py runs it), answer the
    same JPEG bytes with the same JSON: the same detections in the same
    order, task, label and label_name exact, boxes within 1 px (they are
    rounded to whole pixels) and scores within rtol 1e-6. The two device
    letterboxes agree to float32 rounding (~3e-7), which is what is left.
  * The listen backlog takes a burst of 16 connecting clients (the JAX
    server's default of 5 does not: the port repairs it).
  * cli/serve.py: build() warms up and serves on port 0; --mesh replicates
    over the mesh and refuses a --max-batch that its size does not divide,
    with the JAX message; its flags and defaults are root serve.py's,
    except --device for --platform and --compile-cache.
"""

import http.client
import json
import os
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cerberusdet_tpu_torch.serve.server as srv_mod
from cerberusdet_tpu.infer.inference import CerberusDetInference as JaxInference
from cerberusdet_tpu.infer.preprocessor import CerberusPreprocessor as JaxPreprocessor
from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu.serve import BatchingEngine as JaxEngine
from cerberusdet_tpu.serve import make_server as jax_make_server
from cerberusdet_tpu_torch.cli import serve as cli
from cerberusdet_tpu_torch.infer import CerberusDetInference, CerberusPreprocessor
from cerberusdet_tpu_torch.manager.checkpoint import save_checkpoint
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.serve import BatchingEngine, make_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["t1", "t2"], [2, 3]
NAMES = {"t1": ["a", "b"], "t2": ["x", "y", "z"]}
SHAPES = [(80, 120), (64, 64), (50, 80), (80, 120)]
CONF = 1e-4


def _distinct_heads(params, seed):
    """Random box-tower biases (the prior bias draws one box everywhere)."""
    rng = np.random.default_rng(seed)
    for t in TASKS:
        for i in range(3):
            last = params[f"head_{t}"][f"box{i}"]["2"]
            last["b"] = rng.normal(0, 3, last["b"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def params():
    model = JaxModel(CFG, TASKS, NCS)
    p = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(lambda a: a.astype(np.float64), _distinct_heads(p, 1))


def _port_inference(params):
    return CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu"),
                                params=params, names=NAMES, conf_thres=CONF, img_size=64,
                                dtype=torch.float64, device="cpu")


class _Gate:
    """Wraps an inference: predict waits on `release` once `hold` is set,
    and records each batch it is given."""

    def __init__(self, inference):
        self.inference = inference
        self.hold, self.release, self.entered = (threading.Event() for _ in range(3))
        self.batches = []

    def predict(self, batch, **kw):
        self.batches.append((tuple(batch.shape), batch.dtype))
        if self.hold.is_set():
            self.entered.set()
            assert self.release.wait(timeout=60)
        return self.inference.predict(batch, **kw)


@pytest.fixture(scope="module")
def gate(params):
    return _Gate(_port_inference(params))


@pytest.fixture(scope="module")
def engine(gate):
    eng = BatchingEngine(gate, CerberusPreprocessor(img_size=64, device="cpu"),
                         max_batch=4, max_wait_ms=30.0)
    yield eng
    eng.stop()


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(engine):
    srv = make_server(engine, TASKS, host="127.0.0.1", port=0)
    yield _serve(srv)
    srv.shutdown()
    srv.server_close()


def _img(seed: int, shape=(80, 120)):
    return np.random.default_rng(seed).integers(0, 255, (*shape, 3), np.uint8)


def _jpg(seed: int, shape=(80, 120)) -> bytes:
    ok, buf = cv2.imencode(".jpg", _img(seed, shape))
    assert ok
    return buf.tobytes()


def _post(url: str, data: bytes):
    req = urllib.request.Request(url + "/predict", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _status(url: str, path: str, data=None) -> int:
    req = urllib.request.Request(url + path, data=data, method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_engine_batches_and_resolves(engine, gate):
    futs = [engine.submit(_img(i, (60, 90))) for i in range(6)]
    outs = [f.result(timeout=120) for f in futs]
    assert len(outs) == 6 and sum(map(len, outs)) > 0
    for dets in outs:
        for d in dets:
            assert set(d) == {"box", "score", "label", "label_name", "task"}
    assert engine.stats["batches"] >= 2 and engine.stats["requests"] >= 6


def test_padded_batches_have_one_shape(engine, gate, params):
    """Uniform (device letterbox) and ragged (host path) batches alike reach
    predict as (max_batch, 64, 64, 3) float32, and each response is the
    first rows of predict on that padded batch."""
    gate.batches.clear()
    imgs = [_img(20 + i, s) for i, s in enumerate(SHAPES)]
    gate.hold.set()
    first = engine.submit(imgs[0])  # held inside predict while the rest queue
    assert gate.entered.wait(timeout=60)
    futs = [engine.submit(im) for im in imgs]  # one ragged batch of 4
    gate.hold.clear()
    gate.entered.clear()
    gate.release.set()
    got = [f.result(timeout=120) for f in [first] + futs]
    gate.release.clear()
    assert gate.batches == [((4, 64, 64, 3), torch.float32)] * 2
    pre = CerberusPreprocessor(img_size=64, device="cpu")
    batch, shapes = pre.preprocess_host(imgs)
    assert got[1:] == gate.inference.predict(batch, original_shape=shapes)
    one, shape = pre.preprocess([imgs[0]])
    padded = torch.cat([one, one.new_zeros((3, 64, 64, 3))])
    assert got[0] == gate.inference.predict(padded, original_shape=shape * 4)[0]


def test_http_predict_health_stats(server):
    status, body = _post(server, _jpg(0))
    assert status == 200 and "detections" in body
    for d in body["detections"]:
        assert set(d) == {"box", "score", "label", "label_name", "task"}
        assert d["task"] in TASKS
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok", "tasks": TASKS}
    with urllib.request.urlopen(server + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert set(stats) == {"requests", "batches", "errors", "rows", "padded_rows", "queue_ms_sum",
                          "latency_ms_sum"}
    assert stats["requests"] >= 1


def test_http_concurrent_requests_batch(server, engine, gate):
    before = dict(engine.stats)
    results = [None] * 5

    def post(i):
        results[i] = _post(server, _jpg(i + 1))

    gate.hold.set()
    threads = [threading.Thread(target=post, args=(0,))]
    threads[0].start()
    assert gate.entered.wait(timeout=60)  # the runner holds the first batch
    threads += [threading.Thread(target=post, args=(i,)) for i in range(1, 5)]
    for t in threads[1:]:
        t.start()
    for _ in range(600):  # the four decoded requests wait in the queue
        if engine._q.qsize() == 4:
            break
        threading.Event().wait(0.05)
    gate.hold.clear()
    gate.entered.clear()
    gate.release.set()
    for t in threads:
        t.join(timeout=150)
        assert not t.is_alive()
    gate.release.clear()
    assert all(r is not None and r[0] == 200 for r in results)
    assert engine.stats["requests"] - before["requests"] == 5
    assert engine.stats["batches"] - before["batches"] == 2


def test_http_errors(server, monkeypatch):
    assert _status(server, "/predict", b"not an image") == 400
    assert _status(server, "/nope") == 404
    assert _status(server, "/nope", b"x") == 404
    host = urllib.parse.urlparse(server).netloc
    # oversize: a Content-Length above the cap is refused before the body is read
    monkeypatch.setattr(srv_mod, "MAX_BODY_BYTES", 16)
    conn = http.client.HTTPConnection(host, timeout=30)
    conn.request("POST", "/predict", body=b"x" * 64)
    resp = conn.getresponse()
    assert resp.status == 413 and "error" in json.loads(resp.read())
    conn.close()
    for length in ("abc", "0"):  # non-numeric, empty
        conn = http.client.HTTPConnection(host, timeout=30)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", length)
        conn.endheaders()
        assert conn.getresponse().status == 400
        conn.close()


def test_listen_backlog_takes_a_burst_of_clients(engine):
    """16 clients connecting at once all get their connection before the
    server accepts any. socketserver's default backlog of 5 (the JAX
    server's) completes ~6 and leaves the rest to a 1 s SYN retransmit."""
    import socket

    srv = make_server(engine, TASKS, host="127.0.0.1", port=0)
    socks = []
    try:
        for _ in range(16):
            s = socket.socket()
            socks.append(s)
            s.settimeout(0.3)
            s.connect(srv.server_address)  # raises a timeout when the backlog is full
    finally:
        for s in socks:
            s.close()
        srv.server_close()


def test_engine_failure_reaches_every_waiter():
    class Broken:
        def predict(self, batch, **kw):
            raise RuntimeError("boom")

    eng = BatchingEngine(Broken(), CerberusPreprocessor(img_size=64, device="cpu"),
                         max_batch=4, max_wait_ms=50.0)
    try:
        futs = [eng.submit(_img(i)) for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=60)
        assert eng.stats["errors"] == 3 and eng.stats["requests"] == 0
        srv = make_server(eng, TASKS, host="127.0.0.1", port=0)
        url = _serve(srv)
        try:
            assert _status(url, "/predict", _jpg(0)) == 500
        finally:
            srv.shutdown()
            srv.server_close()
    finally:
        eng.stop()
    assert not eng._runner.is_alive()


class _X64:
    """The JAX inference's predict under enable_x64 on the engine's thread."""

    def __init__(self, inference):
        self.inference = inference

    def predict(self, *a, **k):
        with jax.enable_x64():
            return self.inference.predict(*a, **k)


def test_http_matches_jax_float64(params, server):
    model = JaxModel(CFG, TASKS, NCS)
    with jax.enable_x64():
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        ref = JaxInference(model=model, params=jparams, names=NAMES, conf_thres=CONF,
                           img_size=64, half=False, dtype=jnp.float64, warmup_batch=4)
    eng = JaxEngine(_X64(ref), JaxPreprocessor(img_size=64), max_batch=4, max_wait_ms=30.0)
    srv = jax_make_server(eng, TASKS, host="127.0.0.1", port=0)
    url = _serve(srv)
    try:
        n = 0
        for i, shape in enumerate(SHAPES[:3]):
            data = _jpg(40 + i, shape)
            (sa, a), (sb, b) = _post(server, data), _post(url, data)
            assert sa == sb == 200
            a, b = a["detections"], b["detections"]
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert (x["task"], x["label"], x["label_name"]) == \
                    (y["task"], y["label"], y["label_name"]), (x, y)
                assert max(abs(u - v) for u, v in zip(x["box"], y["box"])) <= 1, (x, y)
                np.testing.assert_allclose(x["score"], y["score"], rtol=1e-6)
            n += len(a)
            assert {d["task"] for d in a} == set(TASKS)
        assert n > 0
    finally:
        srv.shutdown()
        srv.server_close()
        eng.stop()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, params):
    path = str(tmp_path_factory.mktemp("serve_cli") / "w.ckpt.npz")
    save_checkpoint(path, jax.tree_util.tree_map(lambda a: a.astype(np.float32), params),
                    {"cfg": CFG, "task_ids": TASKS, "nc": NCS,
                     "names": [NAMES[t] for t in TASKS]}, half=False)
    return path


def test_cli_build_serves(ckpt):
    opt = cli.parse_opt(["--weights", ckpt, "--imgsz", "64", "--conf-thres", "0.0001",
                         "--max-batch", "2", "--host", "127.0.0.1", "--port", "0",
                         "--device", "cpu"])
    inference, engine, server = cli.build(opt)
    url = _serve(server)
    try:
        assert engine.stats["requests"] == 1 and engine.stats["batches"] == 1  # warm-up
        assert inference.device.type == "cpu" and engine.max_batch == 2
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["tasks"] == TASKS
        status, body = _post(url, _jpg(3))
        assert status == 200 and len(body["detections"]) > 0
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


def test_cli_refusals_and_flags(ckpt, monkeypatch):
    # --mesh is ported (tests/test_torch_parallel.py serves over a mesh of two):
    # the service replicates over the mesh, whose size --max-batch must divide
    from cerberusdet_tpu_torch.parallel import mesh as port_mesh

    monkeypatch.setattr(port_mesh, "make_mesh", lambda devices=None: [torch.device("cpu")] * 3)
    with pytest.raises(SystemExit, match="--max-batch 8 must divide by the 3-device mesh"):
        cli.build(cli.parse_opt(["--weights", ckpt, "--mesh", "--device", "cpu"]))
    inference, engine, server = cli.build(cli.parse_opt(
        ["--weights", ckpt, "--mesh", "--device", "cpu", "--imgsz", "64", "--max-batch", "6",
         "--port", "0", "--host", "127.0.0.1"]))
    try:
        assert len(inference.replicas) == 3 and inference.mesh == [torch.device("cpu")] * 3
        assert engine.stats["requests"] == 1 and engine.max_batch == 6
    finally:
        server.server_close()
        engine.stop()
    if not torch.cuda.is_available():  # without --device the service asks for the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.build(cli.parse_opt(["--weights", ckpt]))
    sys.path.insert(0, ROOT)
    import serve as jax_cli  # the JAX package's serve.py at the repository root

    argv = ["--weights", "w"]
    ours, ref = vars(cli.parse_opt(argv)), vars(jax_cli.parse_opt(argv))
    assert ours.pop("device") == "cuda"
    assert ref.pop("platform") == "" and ref.pop("compile_cache") == ""
    assert ours == ref
    flags = ["--half", "--int8", "all", "--max-batch", "16", "--max-wait-ms", "2"]
    assert {k: v for k, v in vars(cli.parse_opt(argv + flags)).items() if k != "device"} == \
        {k: v for k, v in vars(jax_cli.parse_opt(argv + flags)).items()
         if k not in ("platform", "compile_cache")}
