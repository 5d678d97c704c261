"""Offline (batch) serving: one caller in a closed loop sends batches of
`batch` frames drawn from the pool (a seeded order), through the port's
preprocessor and `predict`, and takes each batch's answers on the host
before it sends the next; it keeps the answers of a seeded share of each
batch's rows for the check."""

from __future__ import annotations

import time

from benchmark.serving import CHECKED, ServingSession


class Session(ServingSession):
    def warm(self) -> None:
        b = int(self.cell.traffic["batch"])
        imgs = self.pool[:b]
        for _ in range(2):  # the capture of each program, then one replay
            x, shapes = self.pre.preprocess(imgs)
            self.inference.predict(x, original_shape=shapes)

    def window(self, seconds: float) -> None:
        b, n_pool = int(self.cell.traffic["batch"]), len(self.pool)
        order = [self.rng.permutation(n_pool)[:b] for _ in range(4096)]
        kept = [self.rng.permutation(b)[:max(1, round(b * CHECKED))] for _ in range(4096)]
        span = self.tracer.span
        before, captures = self.counters(), self.captures()
        t0 = time.perf_counter()
        k = 0
        while True:
            idx = order[k % len(order)]
            with span("preprocess"):
                x, shapes = self.pre.preprocess([self.pool[i] for i in idx])
            with span("predict"):
                out = self.inference.predict(x, original_shape=shapes)
            self.answers.extend((int(idx[j]), out[j]) for j in kept[k % len(kept)])
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        after = self.counters()
        self.record = {
            "images": k * b, "rows": k * b, "requests": k * b, "failed": 0,
            "window_s": t1 - t0, "t0": t0, "captures_in_window": self.captures() - captures,
            "launches": {n: after[n] - before[n] for n in after},
        }
