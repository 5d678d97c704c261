"""Multi-task training: the port's captured train step (MultiTaskTrainer.step)
on seeded batches of `batch` images a task at `img_size`, each task's batch
with `max_labels` ground-truth rows of which the first `real_labels` are
valid (the JAX package's train-step benchmark batch), copied in from host
memory each step; SGD-nesterov with YOLO's warm-up learning rates and
momentum, new every step; the EMA.

Set-up builds the trainer and its state once, and steps it through its first
`checked_steps` steps (the first captures the step; rows that all differ);
the window goes on stepping the same object. The reference follows those
first steps from the same weights and batches: the model family's
TrainReference (families/)."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.detect import letterbox
from benchmark.readers import BN_SILU_KERNELS
from benchmark.reference.train import fp8_cast
from benchmark.serving import no_tf32, program_peak
from benchmark.weights import frames

CASTS = {"fp8": fp8_cast}


def schedule(tr: dict, k: int):
    """(lrs (3,), momentum) of step k (0-based): YOLO's warm-up, linear over
    warmup_iters: the biases' lr from warmup_bias_lr to lr0, the others' from
    0, momentum from warmup_momentum."""
    xi = [0, tr["warmup_iters"]]
    other = float(np.interp(k, xi, [0.0, tr["lr0"]]))
    bias = float(np.interp(k, xi, [tr["warmup_bias_lr"], tr["lr0"]]))
    mom = float(np.interp(k, xi, [tr["warmup_momentum"], tr["momentum"]]))
    return np.array([other, other, bias], np.float32), mom


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> List[float]:
    """Per leaf in `keep`: |norm(prog) - norm(ref)| / max(norm(ref), the median
    leaf's norm)."""
    rn = {k: float(ref[k].norm()) for k in keep}
    med = float(np.median(list(rn.values())))
    return [abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med) for k in keep]


def kept_leaves(grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least 1e-3 of the median
    leaf's (the others move by round-off alone)."""
    norms = {k: float(v.norm()) for k, v in grad.items()}
    med = float(np.median(list(norms.values())))
    return [k for k in grad if norms[k] >= 1e-3 * med]


class Session:
    def __init__(self, cell, seed: int, device: torch.device, tracer, program: bool = True,
                 fault: str = ""):
        self.cell, self.seed, self.device, self.tracer = cell, seed, device, tracer
        tr, cfg = cell.traffic, cell.config
        self.tasks, self.ncs = list(cfg["tasks"]), list(cfg["nc"])
        s, b = int(tr["img_size"]), int(tr["batch"])
        gen = torch.Generator(device=device).manual_seed(int(seed))
        calib = letterbox(frames(gen, int(tr["calib_frames"]), s, s, device), s)
        with torch.no_grad(), no_tf32():
            self.weights = cell.family.make_weights(cfg["model"], self.tasks, self.ncs, gen,
                                                    calib)
        del calib
        rng = np.random.default_rng(int(seed))
        m, n_real = int(tr["max_labels"]), int(tr["real_labels"])
        self.pool = []
        for _ in range(int(tr["pool_steps"])):
            imgs = frames(gen, b * len(self.tasks), s, s, device).cpu().numpy()
            self.pool.append({t: {
                "img": imgs[i * b:(i + 1) * b],
                "cls": rng.integers(0, nc, (b, m)).astype(np.int32),
                "bboxes": rng.uniform(0.2, 0.6, (b, m, 4)).astype(np.float32),
                "mask": np.broadcast_to(np.arange(m)[None] < n_real, (b, m)).copy(),
                "prob": np.ones((b, m), np.float32)} for i, (t, nc) in enumerate(zip(
                    self.tasks, self.ncs))})
        self.k = 0
        self.fault = fault  # faults.py: planted in the program's steps
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        if program:
            program_peak(device)
            self.build()

    def build(self) -> None:
        from cerberusdet_tpu_torch.models.cerberus import CerberusModel
        from cerberusdet_tpu_torch.train.loss import DetectionLoss
        from cerberusdet_tpu_torch.train.step import MultiTaskTrainer, init_train_state

        cfg = self.cell.config
        model = CerberusModel(cfg["model"], self.tasks, self.ncs, device=self.device)
        model.load_state_dict(self.weights)
        losses = {t: DetectionLoss(nc=nc, strides=model.strides)
                  for t, nc in zip(self.tasks, self.ncs)}
        self.trainer = MultiTaskTrainer(model, losses, compute_dtype=torch.bfloat16,
                                        device=self.device)
        self.state = init_train_state(model)
        p0 = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
        self.losses: List[List[float]] = []
        for k in range(int(self.cell.traffic["checked_steps"])):
            items = self.step()
            self.losses.append([float(items[t].total) for t in self.tasks])
            if k == 0:
                self.grad1 = {n: v.cpu().clone()
                              for n, v in self.state.opt_state.momentum_buf.items()}
                self.running1 = {n: v.cpu() - self.weights[n].cpu()
                                 for n, v in model.named_buffers() if "running" in n}
        self.change = {k: v.detach().cpu() - p0[k] for k, v in model.named_parameters()}
        self.ema_change = {k: v.detach().cpu() - self.weights[k]
                           for k, v in self.state.ema.named_parameters()}

    def step(self):
        lrs, mom = schedule(self.cell.traffic, self.k)
        batch = self.pool[self.k % len(self.pool)]
        self.k += 1
        if self.fault == "unchanged":  # the state left as it was (BatchNorm's too), the losses zero
            from cerberusdet_tpu_torch.train.loss import LossItems
            return {t: LossItems(*[torch.zeros((), device=self.device)] * 4) for t in self.tasks}
        if self.fault == "half":
            batch = {t: {k: v[:len(v) // 2] for k, v in b.items()} for t, b in batch.items()}
        if self.fault == "ema_unchanged":
            ema = [t.clone() for t in self.state.ema.state_dict().values()]
        self.state, items = self.trainer.step(self.state, batch, lrs, mom)
        if self.fault == "ema_unchanged":  # everything stepped but the EMA
            for t, old in zip(self.state.ema.state_dict().values(), ema):
                t.copy_(old)
        return items

    def captures(self) -> int:
        return len(self.trainer.programs)

    def counters(self) -> Dict[str, int]:
        """The port's launch counters: the TAL kernels', and each BatchNorm +
        SiLU wrapper's (readers.BN_SILU_KERNELS)."""
        from cerberusdet_tpu_torch.ops import bn_cuda, tal_cuda
        out = {"tal": sum(k.launches for k in (tal_cuda.select_kernel, tal_cuda.assign_kernel,
                                               tal_cuda.norm_kernel))}
        out.update((w, getattr(bn_cuda, w).launches) for w in BN_SILU_KERNELS)
        return out

    def window(self, seconds: float) -> None:
        before, captures = self.counters(), self.captures()
        t0 = time.perf_counter()
        n = 0
        while True:
            with self.tracer.span("step"):
                items = self.step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        last = torch.stack([items[t].total for t in self.tasks]).cpu()  # ends with the device
        t1 = time.perf_counter()
        after = self.counters()
        b = int(self.cell.traffic["batch"]) * len(self.tasks)
        self.record = {
            "steps": n, "images": n * b, "rows": n * b, "requests": n,
            "failed": int(not torch.isfinite(last).all()), "window_s": t1 - t0, "t0": t0,
            "captures_in_window": self.captures() - captures,
            "launches": {k: after[k] - before[k] for k in after},
        }

    def release(self) -> None:
        for name in ("trainer", "state"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def follow(self, conv_cast=None):
        """The reference's first checked_steps steps: (losses, first step's
        gradient as the optimizer got it, parameter change, the BatchNorm
        running statistics' change in the first step, the EMA's change of
        each parameter)."""
        w = {k: v.to(self.device) for k, v in self.weights.items()}
        ref = self.cell.family.TrainReference(self.cell.config["model"], self.tasks, self.ncs,
                                              w, conv_cast)
        p0 = {k: v.detach().clone() for k, v in ref.params.items()}
        losses = []
        with no_tf32(), torch.enable_grad():
            for k in range(int(self.cell.traffic["checked_steps"])):
                lrs, mom = schedule(self.cell.traffic, k)
                batch = {t: {f: torch.as_tensor(v).to(self.device) for f, v in b.items()}
                         for t, b in self.pool[k].items()}
                losses.append(list(ref.step(batch, lrs.tolist(), mom).values()))
                if k == 0:
                    grad1 = {n: v.cpu().clone() for n, v in ref.buf.items()}
                    running1 = {n: (v - w[n]).cpu() for n, v in ref.ref.running.items()}
        change = {k: (ref.params[k].detach() - p0[k]).cpu() for k in ref.params}
        ema = {k: (ref.ema[k] - w[k]).cpu() for k in ref.params}
        del ref, w, p0
        return losses, grad1, change, running1, ema

    @staticmethod
    def numbers(prog, ref) -> Dict[str, float]:
        """loss_gap_first: the largest relative gap of a task's loss at the first
        step; loss_gap: the same over every checked step; grad_gap_median,
        change_gap_median: the median leaf's gap of norms (leaf_gaps) of the
        first gradient as the optimizer got it and of the parameters' change
        over the checked steps, over the leaves whose reference gradient is at
        least 1e-3 of the median leaf's; ema_change_gap_median: the same of
        the EMA's change over the checked steps; the _worst forms take the
        worst leaf;
        bn_var_gap_median, bn_mean_gap_median: the median over the BatchNorms
        of |program - reference| / |reference| of the first step's change of
        the running variance and mean (norms over the channels)."""
        (pl, pg, pc, pr, pe), (rl, rg, rc, rr, re) = prog, ref
        keep = kept_leaves(rg)
        loss = np.abs(np.array(pl) - np.array(rl)) / np.abs(np.array(rl))
        grad, change = leaf_gaps(pg, rg, keep), leaf_gaps(pc, rc, keep)

        def bn(stat):
            return float(np.median([float((pr[k] - rr[k]).norm() / rr[k].norm())
                                    for k in rr if k.endswith(stat)]))

        return {"loss_gap_first": float(loss[0].max()), "loss_gap": float(loss.max()),
                "grad_gap_median": float(np.median(grad)),
                "change_gap_median": float(np.median(change)),
                "ema_change_gap_median": float(np.median(leaf_gaps(pe, re, keep))),
                "grad_gap_worst": float(max(grad)), "change_gap_worst": float(max(change)),
                "bn_var_gap_median": bn("running_var"), "bn_mean_gap_median": bn("running_mean")}

    @staticmethod
    def look(prog, ref) -> Dict[str, list]:
        """The worst leaf of the first gradient and of the change: [name, the
        program's norm, the reference's, the median leaf's (reference)]."""
        keep = kept_leaves(ref[1])
        out = {}
        for what, i in (("grad_worst", 1), ("change_worst", 2)):
            gaps = leaf_gaps(prog[i], ref[i], keep)
            k = keep[int(np.argmax(gaps))]
            out[what] = [k, float(prog[i][k].norm()), float(ref[i][k].norm()),
                         float(np.median([float(ref[i][n].norm()) for n in keep]))]
        return out

    def check(self) -> Dict[str, float]:
        prog = (self.losses, self.grad1, self.change, self.running1, self.ema_change)
        ref = self.follow()
        self.look_at = self.look(prog, ref)
        return self.numbers(prog, ref)

    def control(self, spec: dict) -> Dict[str, float]:
        return self.numbers(self.follow(CASTS[spec["cast"]]), self.follow())
