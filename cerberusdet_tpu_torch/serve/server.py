"""Serving daemon: dynamic request batching over the captured inference
program (`CerberusDetInference`), with a stdlib HTTP front end.

Counterpart of cerberusdet_tpu/serve/server.py. The reference ships only an
offline CLI and a library API; this is the deployment surface of its
serving half:

  * One program shape. Requests are drained into batches of at most
    `max_batch`, and a partial batch is padded with zero rows to
    `max_batch`, on the device that the preprocessor left it on, so that
    every served batch has one shape and dtype and `predict` replays one
    captured CUDA graph (infer/inference.py). Padding rows are computed and
    dropped before the responses.
  * The batcher thread is the only one that touches the card: it
    preprocesses (the letterbox graphs are captured and replayed there),
    pads, and runs `predict`. The HTTP threads decode the image with cv2
    and wait on a future. A CUDA graph is captured in the global capture
    mode, which fails if another thread makes a CUDA call meanwhile, so no
    handler touches a tensor and `stats` holds plain Python numbers.
  * `max_wait_ms` trades tail latency for batch fill.
  * The listening socket's backlog is the kernel's maximum, not socketserver's
    default of 5 that the JAX server keeps: with 5, a burst of more than ~6
    concurrent clients has its connections dropped until a 1 s SYN
    retransmit, or reset (its tail latency was ~1.1 s under 16 clients).

Endpoints (JSON; see cli/serve.py for the CLI):
  POST /predict    image bytes (jpg/png/bmp) -> {"detections": [...]} in the
                   reference's detection-dict contract (box, score, label,
                   label_name, task).
  GET  /healthz    {"status": "ok", "tasks": [...]}
  GET  /stats      request, batch and error counts, latency and batch-fill
                   EWMAs.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List

import numpy as np
import torch

# request-body ceiling: generously above any real camera frame (a 100MP jpg
# is ~30 MB) while bounding per-connection RAM under hostile Content-Length
MAX_BODY_BYTES = 64 * 1024 * 1024


class BatchingEngine:
    """Dynamic batcher: submit() images from any thread; one runner thread
    drains the queue into batches of `max_batch` rows."""

    def __init__(self, inference, preprocessor, max_batch: int = 8,
                 max_wait_ms: float = 5.0):
        self.inference = inference
        self.pre = preprocessor
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "latency_ms": 0.0, "batch_fill": 0.0}
        self._runner = threading.Thread(target=self._run, daemon=True)
        self._runner.start()

    def submit(self, img_bgr: np.ndarray) -> Future:
        """img_bgr: HWC uint8 (cv2 layout). Returns a Future resolving to
        the image's detections list."""
        fut: Future = Future()
        self._q.put((img_bgr, fut, time.perf_counter()))
        return fut

    def stop(self):
        self._stop.set()
        self._q.put(None)
        self._runner.join(timeout=5)

    # ------------------------------------------------------------- runner
    def _drain(self):
        """Collect up to max_batch requests; after the first arrives, wait
        at most max_wait for the batch to fill."""
        items = []
        first = self._q.get()
        if first is None:
            return items
        items.append(first)
        deadline = time.perf_counter() + self.max_wait
        while len(items) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _run(self):
        while not self._stop.is_set():
            items = self._drain()
            if not items:
                continue
            try:
                imgs = [it[0] for it in items]
                batch, shapes = self.pre.preprocess(imgs)
                batch = torch.as_tensor(batch)  # a device tensor, or the host path's array
                n = len(imgs)
                if n < self.max_batch:
                    # pad to the one served batch shape, where the batch lies
                    pad = batch.new_zeros((self.max_batch - n,) + tuple(batch.shape[1:]))
                    batch = torch.cat([batch, pad], 0)
                    shapes = list(shapes) + [shapes[-1]] * (self.max_batch - n)
                out = self.inference.predict(batch, original_shape=shapes)
                now = time.perf_counter()
                for (_, fut, t0), dets in zip(items, out[:n]):
                    fut.set_result(dets)
                    lat = (now - t0) * 1000.0
                    s = self.stats
                    s["latency_ms"] = 0.9 * s["latency_ms"] + 0.1 * lat
                s = self.stats
                s["requests"] += n
                s["batches"] += 1
                s["batch_fill"] = 0.9 * s["batch_fill"] + 0.1 * (n / self.max_batch)
            except Exception as e:  # surface the failure to every waiter
                self.stats["errors"] += len(items)
                for _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(e)


def _to_jsonable(dets: List[dict]) -> List[dict]:
    out = []
    for d in dets:
        out.append({
            "box": [float(v) for v in d["box"]],
            "score": float(d["score"]),
            "label": int(d["label"]),
            "label_name": str(d["label_name"]),
            "task": str(d["task"]),
        })
    return out


class _HTTPServer(ThreadingHTTPServer):
    request_queue_size = socket.SOMAXCONN  # the listen backlog (the kernel caps it)


def make_server(engine: BatchingEngine, tasks: List[str], host: str = "0.0.0.0",
                port: int = 8000, timeout_s: float = 60.0) -> ThreadingHTTPServer:
    """Build (not start) the threaded HTTP server wired to `engine`."""
    import cv2

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"status": "ok", "tasks": tasks})
            elif self.path.startswith("/stats"):
                self._json(200, engine.stats)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/predict"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._json(400, {"error": "bad Content-Length"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body"})
                return
            if length > MAX_BODY_BYTES:
                self._json(413, {"error": f"body too large "
                                          f"(max {MAX_BODY_BYTES} bytes)"})
                return
            data = self.rfile.read(length)
            img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            if img is None:
                self._json(400, {"error": "could not decode image"})
                return
            try:
                dets = engine.submit(img).result(timeout=timeout_s)
            except Exception as e:
                self._json(500, {"error": str(e)})
                return
            self._json(200, {"detections": _to_jsonable(dets)})

    return _HTTPServer((host, port), Handler)
