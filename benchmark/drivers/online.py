"""Online serving: an open loop of single frames with Poisson arrivals at the
traffic's fixed rate, into the port's BatchingEngine (serve/server.py), in
process, without the HTTP front end. A sender thread submits each request at
its due time; a request's latency runs from its due time to its future
resolving. The answers of a seeded share of the requests are kept for the
check; the others are dropped as they resolve. The engine is handed thin wrappers of the preprocessor and the
inference object that record each call (rows, start, end): the batcher's
per-layer metrics come from them."""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List

import numpy as np

from benchmark.serving import CHECKED, ServingSession

GRACE_S = 60.0  # how long after the last due time the answers are awaited


class _Calls:
    """Wraps the engine's preprocessor and inference object: each call's rows
    and times, and the requests (by frame object) each predict carried."""

    def __init__(self, pre, inference, span):
        self._pre, self._inf, self._span = pre, inference, span
        self.batch_ids: List[int] = []
        self.calls: List[tuple] = []      # (rows, predict start, predict end)
        self.started: Dict[int, float] = {}
        self.ids: Dict[int, int] = {}     # id(frame view) -> request

    def preprocess(self, imgs):
        self.batch_ids = [self.ids[id(im)] for im in imgs]
        with self._span("preprocess"):
            return self._pre.preprocess(imgs)

    def predict(self, batch, **kw):
        t = time.perf_counter()
        for i in self.batch_ids:
            self.started[i] = t
        with self._span("predict"):
            out = self._inf.predict(batch, **kw)
        self.calls.append((len(self.batch_ids), t, time.perf_counter()))
        return out


class Session(ServingSession):
    def warm(self) -> None:
        from cerberusdet_tpu_torch.serve.server import BatchingEngine

        tr = self.cell.traffic
        mb = int(tr["max_batch"])
        for n in range(1, mb + 1):  # every batch the engine can form: a letterbox graph each
            x, shapes = self.pre.preprocess(self.pool[:n])
        for _ in range(2):
            self.inference.predict(x, original_shape=shapes)
        self.calls = _Calls(self.pre, self.inference, self.tracer.span)
        self._views = []
        self.engine = BatchingEngine(self.calls, self.calls, max_batch=mb,
                                     max_wait_ms=float(tr["max_wait_ms"]))
        for n in (1, mb):  # the engine's own path, once with a partial and a full batch
            futs = [self._submit(self.pool[i]) for i in range(n)]
            for f in futs:
                f.result(timeout=GRACE_S)
        self.calls.calls.clear()
        self.calls.started.clear()

    def _submit(self, frame) -> Future:
        view = frame[:]  # a distinct object a request, so the wrappers know it
        self.calls.ids[id(view)] = len(self.calls.ids)
        self._views.append(view)
        return self.engine.submit(view)

    def window(self, seconds: float) -> None:
        rate = float(self.cell.traffic["rate_per_s"])
        n = max(1, int(rate * seconds * 1.5) + 16)
        due = np.cumsum(self.rng.exponential(1.0 / rate, n))
        due = due[due < seconds]
        which = self.rng.integers(0, len(self.pool), len(due))
        checked = self.rng.random(len(due)) < CHECKED
        self._views = []
        self.calls.ids.clear()
        self.calls.calls.clear()
        self.calls.started.clear()
        done = np.full(len(due), np.nan)
        sent = np.full(len(due), np.nan)
        errors = np.zeros(len(due), bool)
        kept: Dict[int, list] = {}
        answered = threading.Semaphore(0)
        before, captures = self.counters(), self.captures()

        def finish(i):
            def cb(f):
                done[i] = time.perf_counter()
                if f.exception() is not None:
                    errors[i] = True
                elif checked[i]:
                    kept[i] = f.result()
                answered.release()
            return cb

        t0 = time.perf_counter() + 0.01

        def send():
            for i, (d, f) in enumerate(zip(due, which)):
                wait = t0 + d - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent[i] = time.perf_counter()
                self._submit(self.pool[f]).add_done_callback(finish(i))

        sender = threading.Thread(target=send, daemon=True)
        sender.start()
        sender.join(timeout=seconds + GRACE_S)
        deadline = t0 + seconds + GRACE_S
        for _ in range(len(due)):  # every answer, or the deadline
            if not answered.acquire(timeout=max(0.0, deadline - time.perf_counter())):
                break
        # a request never answered, or answered with an error, failed
        failed = int((~np.isfinite(done)).sum() + errors.sum())
        self.answers.extend((int(which[i]), kept[i]) for i in sorted(kept))
        t1 = np.nanmax(done) if np.isfinite(done).any() else time.perf_counter()
        after = self.counters()
        due_abs = t0 + due
        lat = (done - due_abs) * 1e3
        starts = np.array([self.calls.started.get(i, np.nan) for i in range(len(due))])
        rows = [c[0] for c in self.calls.calls]
        self.record = {
            "images": int(np.isfinite(done).sum()), "requests": len(due), "failed": failed,
            "window_s": float(t1 - t0), "t0": t0, "latency_ms": lat[np.isfinite(lat)].tolist(),
            "queue_wait_ms": ((starts - due_abs) * 1e3)[np.isfinite(starts)].tolist(),
            "batch_rows": rows, "max_batch": int(self.cell.traffic["max_batch"]),
            "rows": len(rows) * int(self.cell.traffic["max_batch"]),
            "lateness_p99_ms": float(np.percentile((sent - due_abs) * 1e3, 99)) if len(due) else 0.0,
            "captures_in_window": self.captures() - captures,
            "launches": {k: after[k] - before[k] for k in after},
        }

    def release(self) -> None:
        if hasattr(self, "engine"):
            self.engine.stop()
        super().release()
