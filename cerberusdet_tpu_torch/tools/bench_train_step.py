"""Train-step benchmark: the plain assigner against the TAL kernels.

The port's counterpart of cerberusdet_tpu/tools/bench_train_step.py, which
compares the JAX package's XLA and Pallas assigners with K steps inside one
jitted lax.scan, timed to one fetch of the losses. Here the two routes are
train/loss.py's DetectionLoss with use_kernel=False (the plain assigner,
train/tal.py) and use_kernel=True (csrc/tal.cu through ops/tal_cuda.py).
Each route builds the seeded 2-task v8x (CerberusModel.init(0)) and its
train state, so both start from the same state, and steps it on the same
seeded batches (per-task batch 8 at 640 px, 300 gt rows of which 40 are
real, bf16 compute over float32 masters). First the eager step
(MultiTaskTrainer.raw_step): 2 warm-up steps, then --iters steps, each
ended by a synchronise, by the host clock (its ms a step on the route's
line). Then the captured step (MultiTaskTrainer.step): one call that
captures it, one replay, then --iters replays back to back between CUDA
events, ended by one fetch of the losses: the counterpart of the JAX tool's
scan (on the CPU, where step is the eager step, the host clock around the
same calls). The routes run in turns, plain, kernels, kernels, plain, and
each route's ms a step is the mean of its two runs, so that the order in
which they run does not decide the comparison. Also holds the routes' losses
of the first step against each other (loss_rel_diff, the largest relative
difference of the per-task totals).

Usage: python -m cerberusdet_tpu_torch.tools.bench_train_step [--iters 10]
       [--max-labels 300] [--imgsz 640] [--batch 8] [--device cpu --cfg ...]
Prints one line a route, then ONE JSON object with the JAX tool's keys:
{"xla": {"ms_per_step", "img_per_s"}, "pallas": {...}, "loss_rel_diff",
"speedup"}, where "xla" is the plain route (the assigner in plain tensor
operations, as XLA compiled it there) and "pallas" the kernels' route, each
timed as the captured step.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.testing import train_batches
from cerberusdet_tpu_torch.train.loss import DetectionLoss
from cerberusdet_tpu_torch.train.step import MultiTaskTrainer, init_train_state
from cerberusdet_tpu_torch.utils.profiling import device_label, time_sync

TASKS, NCS = ["a", "b"], [20, 19]
WARMUP_STEPS = 2
TURNS = ("xla", "pallas", "pallas", "xla")


@torch.enable_grad()
def bench(use_kernel: bool, args, device):
    """(seconds a step captured, seconds a step eager, the first step's
    per-task totals) of one route."""
    model = CerberusModel(args.cfg, TASKS, NCS, device=device).init(0)
    losses = {t: DetectionLoss(nc=nc, strides=model.strides, use_kernel=use_kernel)
              for t, nc in zip(TASKS, NCS)}
    trainer = MultiTaskTrainer(model, losses, compute_dtype=torch.bfloat16, device=device)
    state = init_train_state(model)
    batches = train_batches(TASKS, NCS, args.batch, args.imgsz, args.max_labels, 40, seed=0)
    batches = {t: {k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for t, b in batches.items()}
    lrs, mom = np.full((3,), 0.01, np.float32), 0.9
    first = None
    for _ in range(WARMUP_STEPS):
        state, items = trainer.raw_step(state, batches, lrs, mom)
        if first is None:
            first = np.array([float(items[t].total) for t in TASKS])
    t0 = time_sync()
    for _ in range(args.iters):
        state, items = trainer.raw_step(state, batches, lrs, mom)
        time_sync()
    eager = (time_sync() - t0) / args.iters

    for _ in range(WARMUP_STEPS):  # the capture, then one replay
        state, items = trainer.step(state, batches, lrs, mom)
    on_card = device.type == "cuda"
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time_sync()
    if on_card:
        start.record()
    for _ in range(args.iters):
        state, items = trainer.step(state, batches, lrs, mom)
    if on_card:
        end.record()
    totals = torch.stack([items[t].total for t in TASKS]).cpu().numpy()  # the one fetch
    captured = start.elapsed_time(end) / 1e3 / args.iters if on_card else \
        (time.perf_counter() - t0) / args.iters
    if not np.all(np.isfinite(totals)):
        raise RuntimeError(f"non-finite losses after {args.iters} steps: {totals}")
    return captured, eager, first


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-labels", type=int, default=300)
    ap.add_argument("--cfg", default="configs/models/yolov8x_2task.yaml")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    times, losses = {"xla": [], "pallas": []}, {"xla": [], "pallas": []}
    for route in TURNS:
        dt, eager, first_losses = bench(route == "pallas", args, device)
        times[route].append(dt)
        losses[route].append(first_losses)
        how = "replays between CUDA events" if device.type == "cuda" else "host clock"
        print(route, f"{dt * 1e3:.1f} ms a step ({how}), eager {eager * 1e3:.1f} ms a step, "
              "first-step losses:", first_losses,
              f" [{device_label(device)}]", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out = {}
    for route, dts in times.items():
        dt = float(np.mean(dts))
        out[route] = {"ms_per_step": round(dt * 1e3, 1),
                      "img_per_s": round(len(TASKS) * args.batch / dt, 1)}
    ref = losses["xla"][0]
    rel = np.abs(np.stack(losses["xla"] + losses["pallas"]) - ref) / np.abs(ref)
    out["loss_rel_diff"] = float(rel.max())
    out["speedup"] = round(out["xla"]["ms_per_step"] / out["pallas"]["ms_per_step"], 3)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
