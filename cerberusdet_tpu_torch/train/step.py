"""The multi-task gradient-averaging train step.

Counterpart of cerberusdet_tpu/train/step.py (the reference's
averaging.py:97-223). One step, over the active tasks in model task order:

    for t: loss_t = w_t * DetectionLoss_t(model(batch_t, tasks=[t]))
           backward(loss_t)                   # gradients summed in .grad
    grads  = sum over the ranks of grads      # with a process group only
    grads *= 1 / serving count (per block, over the active tasks)
    grads  = clip_by_global_norm(grads, 10)
    params = optimizer(params, grads)         # 3 groups, active blocks only
    ema    = ramped-decay EMA(params and BN buffers)

The JAX step is one pure function, jitted once per (active tasks,
freeze_shared) with the state donated; `raw_step` there is the unjitted
function. Here the state is updated in place: the model holds float32 master
parameters and BN buffers, and a backward per task frees that task's graph
before the next forward. BatchNorm folds each task's batch statistics into
its running statistics during that task's forward (nn/module.py), in task
order, which is where the JAX step folds them after the optimizer: the
optimizer does not touch them, and a training forward does not read them.

`raw_step` runs the step eagerly (with stage marks on request); it is what
the CPU runs. `step` on the card keeps one CUDA graph of the step per key
(`step_key`: what the step's Python reads besides the state's tensors) and
replays it (infer/graphs.py:CapturedProgram): the first call of a key runs
the step eagerly as the real step, with any host synchronisation raising,
then captures it; later calls copy the batches and the per-step scalars
(lrs, momentum, Adam's bias corrections, the EMA decay) into the key's
static buffers and replay, and return while the card runs the step. The graph updates the state's
tensors at the addresses it captured: a parameter, BN buffer, optimizer
buffer or EMA tensor replaced since (not updated in place) makes the next
replay raise with its name. The graph holds raw_step's stage marks as
device marks (utils/tracing.py): every replay times forward+loss and
backward per task, then clip, optimizer and EMA, and the host reads them
into the ring.

With a process group (`group`, data parallelism: parallel/mesh.py) each
rank steps its replica of the state on its own rows, and the step is the
one step over the global batch that the JAX step takes over a mesh: the
loss normalises by the global target-score sum and row count, BatchNorm
takes the global statistics, and after every task's backward one
all-reduce sums the flat gradients of the active blocks over the ranks
(summed, not averaged: the losses are already shares of the global loss).
An NCCL group's collectives are captured with the step; a Gloo group's run
on the host, so `step` refuses to capture them and `raw_step` runs them.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.infer.graphs import CapturedProgram
from cerberusdet_tpu_torch.models.cerberus import CerberusModel, module_key
from cerberusdet_tpu_torch.ops import bn_cuda, tal_cuda
from cerberusdet_tpu_torch.train.loss import DetectionLoss, LossItems
from cerberusdet_tpu_torch.train.optim import (
    N_UPDATE_SCALARS,
    OptState,
    SGDConfig,
    clip_by_global_norm,
    ema_apply,
    ema_scalars,
    param_group,
    sgd_apply,
    sgd_init,
    update_scalars,
)
from cerberusdet_tpu_torch.utils import tracing

TAL_KERNELS = (tal_cuda.select_kernel, tal_cuda.assign_kernel, tal_cuda.norm_kernel)
COUNTED = TAL_KERNELS + bn_cuda.COUNTED  # what a replay of the step counts again


@dataclasses.dataclass
class TrainState:
    """model: the trained CerberusModel (parameters and BN buffers, updated
    in place); opt_state: optimizer buffers keyed by parameter name; ema: a
    copy of the model holding the EMA of every parameter and buffer;
    n_updates: optimizer steps taken."""
    model: CerberusModel
    opt_state: OptState
    ema: CerberusModel
    n_updates: int = 0


def init_train_state(model: CerberusModel, sgd: SGDConfig = SGDConfig()) -> TrainState:
    ema = copy.deepcopy(model).requires_grad_(False)
    params = {k: p for k, p in model.named_parameters()}
    return TrainState(model, sgd_init(params, sgd), ema, 0)


def state_tensors(state: TrainState) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor a step reads or updates in place: the
    model's parameters and buffers, the optimizer's buffers, the EMA's."""
    out = [(f"model.{n}", t) for n, t in state.model.named_parameters()]
    out += [(f"model.{n}", t) for n, t in state.model.named_buffers()]
    opt = state.opt_state
    out += [(f"opt_state.momentum_buf[{n!r}]", t) for n, t in opt.momentum_buf.items()]
    if opt.second_moment is not None:
        out += [(f"opt_state.second_moment[{n!r}]", t) for n, t in opt.second_moment.items()]
    out += [(f"ema.{n}", t) for n, t in state.ema.named_parameters()]
    out += [(f"ema.{n}", t) for n, t in state.ema.named_buffers()]
    return out


@contextlib.contextmanager
def no_host_sync():
    """Make any host synchronisation inside raise: a capture cannot hold
    one. torch.cuda.set_sync_debug_mode is process-wide, so this spans only
    a key's first eager run (MultiTaskTrainer._capture)."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def _sum_over_ranks(grads: List[torch.Tensor], group) -> None:
    """Sum the gradients over the ranks of `group`, in place: one all-reduce
    of their concatenation, every active parameter's gradient in it (zeros
    where this rank's backward gave none), so that every rank reduces the
    same buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


class MultiTaskTrainer:
    """Steps a TrainState of `model` with per-task DetectionLosses. Runs on
    the card unless device="cpu"; the model must already be there. group: a
    process group over which each rank steps its own rows of the global
    batch (see the module's docstring); every rank must hold the same state
    (parallel/mesh.py:replicate) and step the same tasks."""

    def __init__(self, model: CerberusModel, losses: Dict[str, DetectionLoss],
                 task_weights: Optional[Dict[str, float]] = None,
                 sgd: SGDConfig = SGDConfig(), compute_dtype=torch.float32,
                 max_grad_norm: float = 10.0, ema_decay0: float = 0.9999, device=None,
                 group=None):
        self.device = resolve_device(device)
        self.group = group
        dev = next(model.parameters()).device
        if dev.type != self.device.type or (self.device.index is not None
                                            and dev != self.device):
            raise ValueError(f"the model is on {dev}, the trainer on {self.device}")
        self.model = model
        self.losses = losses
        self.task_weights = task_weights or {t: 1.0 for t in model.task_ids}
        self.sgd = sgd
        self.compute_dtype = compute_dtype
        self.max_grad_norm = max_grad_norm
        self.ema_decay0 = ema_decay0
        uids = list(model.block_nodes) + [model.head_uid(t) for t in model.task_ids]
        self._uid_of_key = {module_key(u): u for u in uids}
        # (name, parameter, block uid) of every optimised parameter
        self._params: List[Tuple[str, torch.nn.Parameter, str]] = [
            (name, p, self._uid_of_key[name.split(".")[1]])
            for name, p in model.named_parameters() if param_group(name) >= 0]
        self.programs: Dict[tuple, CapturedProgram] = {}  # step_key -> the captured step
        self.pool = None  # the graph memory pool of every key's program

    def step_key(self, batches: Dict[str, Dict], freeze_shared: bool = False) -> tuple:
        """The key of `step`'s captured program: everything the step's Python
        reads besides the state's tensors. The active tasks in model order
        and freeze_shared; each task's batch fields with their shapes and
        dtypes (an `img_mask` field changes the BN statistics' code); each
        active loss's use_kernel; the compute dtype, the optimizer's
        configuration, the task weights and the clipping norm."""
        tasks = tuple(sorted(batches, key=self.model.task_ids.index))
        fields = []
        for t in tasks:
            arrays = {k: torch.as_tensor(v) for k, v in batches[t].items()}
            fields.append(tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(arrays.items())))
        return (tasks, bool(freeze_shared), tuple(fields),
                tuple(self.losses[t].use_kernel for t in tasks), self.compute_dtype, self.sgd,
                tuple(self.task_weights[t] for t in tasks), self.max_grad_norm)

    def step(self, state: TrainState, batches: Dict[str, Dict], lrs, momentum,
             freeze_shared: bool = False) -> Tuple[TrainState, Dict[str, LossItems]]:
        """One optimizer step over the given per-task batches: raw_step's
        step, which on the card replays the CUDA graph of its key
        (`step_key`), captured by the key's first call, which runs the step
        eagerly. The returned LossItems of a replay are the graph's static
        outputs, which the next step overwrites: read them (or enqueue what
        reads them) first. Raises if a tensor of the state was replaced since
        the key's capture (see the module's docstring)."""
        if self.device.type != "cuda":
            return self.raw_step(state, batches, lrs, momentum, freeze_shared)
        if self.group is not None and dist.get_backend(self.group) != "nccl":
            raise RuntimeError(f"a {dist.get_backend(self.group)} group's collectives run on "
                               "the host, which a CUDA graph cannot capture: step a Gloo "
                               "group on the card with raw_step (eager), or join an NCCL "
                               "group to capture the step")
        if state.model is not self.model:
            raise ValueError("the state belongs to another model")
        with tracing.span("train.step"):
            tasks = sorted(batches, key=self.model.task_ids.index)
            inputs = {t: {k: torch.as_tensor(batches[t][k]) for k in sorted(batches[t])}
                      for t in tasks}
            key = self.step_key(inputs, freeze_shared)
            inputs = {"batches": inputs, "scalars": self._scalars(state, lrs, momentum)}
            watched = state_tensors(state)
            prog = self.programs.get(key)
            if prog is None:
                self.programs[key] = prog = self._capture(state, inputs, freeze_shared, watched)
                items = prog.first
            else:
                items = prog.run(inputs, watched)
        self._advance(state)
        return state, items

    def _capture(self, state: TrainState, inputs: Dict, freeze_shared: bool,
                 watched) -> CapturedProgram:
        """The key's program: its eager run steps the state once, with any
        host synchronisation raising, then the capture records the step.
        If the capture fails after that run, the host counters are advanced
        to match the stepped state before the error propagates."""
        ran = [0]

        def fn(x):
            if ran[0]:  # the capture, which records without running, and marks the stages
                return self._run(state, x["batches"], x["scalars"], freeze_shared,
                                 tracing.mark)
            with no_host_sync():
                out = self._run(state, x["batches"], x["scalars"], freeze_shared)
            ran[0] = 1
            return out

        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        try:
            return CapturedProgram(fn, inputs, self.device, self.pool, COUNTED, watched)
        except Exception as err:
            if not ran[0]:
                raise
            self._advance(state)
            raise RuntimeError("capturing the train step failed after its eager run had "
                               "stepped the state once (n_updates and opt_state.step count "
                               "that step)") from err

    def release(self) -> None:
        """Free every captured step and the graph pool they share."""
        for prog in self.programs.values():
            prog.graph.reset()
        self.programs.clear()
        self.pool = None

    def drop_programs(self, freeze_shared: bool) -> None:
        """Forget the captured steps of freeze_shared's keys."""
        for key in [k for k in self.programs if k[1] == freeze_shared]:
            del self.programs[key]

    def raw_step(self, state: TrainState, batches: Dict[str, Dict], lrs, momentum,
                 freeze_shared: bool = False,
                 mark: Optional[Callable[[str], None]] = None
                 ) -> Tuple[TrainState, Dict[str, LossItems]]:
        """One optimizer step over the given per-task batches, run eagerly.

        batches: {task: {'img': (B, H, W, 3) float in [0, 1] or uint8, 'cls',
        'bboxes', 'mask', 'prob', optional 'img_mask'}} as arrays or tensors.
        lrs: (3,) per-group learning rates; momentum: a scalar. Returns
        (state, {task: LossItems}); the state is the same object, updated.
        `mark`, when given, is called with each stage's name as it ends:
        "forward_loss" and "backward" per task, then "clip" (the scaling by
        serving count, the sum over ranks and the clipping), "optimizer" and
        "ema"."""
        if state.model is not self.model:
            raise ValueError("the state belongs to another model")
        batches = {t: _to_device(b, self.device) for t, b in batches.items()}
        scalars = self._scalars(state, lrs, momentum).to(self.device, non_blocking=True)
        items = self._run(state, batches, scalars, freeze_shared, mark)
        self._advance(state)
        return state, items

    def _scalars(self, state: TrainState, lrs, momentum) -> torch.Tensor:
        """The next step's update_scalars and ema_scalars, on the host in
        the parameters' dtype (float32 values)."""
        values = np.concatenate([update_scalars(self.sgd, lrs, momentum, state.opt_state.step + 1),
                                 ema_scalars(state.n_updates + 1, self.ema_decay0)])
        return torch.from_numpy(values).to(self._params[0][1].dtype)

    @staticmethod
    def _advance(state: TrainState) -> None:
        state.opt_state.step += 1
        state.n_updates += 1

    def _run(self, state: TrainState, batches: Dict[str, Dict[str, torch.Tensor]],
             scalars: torch.Tensor, freeze_shared: bool,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, LossItems]:
        """The step's device work on batches and scalars (_scalars) already
        on the device; advances no host count."""
        model = state.model
        tasks = sorted(batches, key=model.task_ids.index)
        shared = set(model.shared_uids()) if freeze_shared else set()
        active = {s.uid for s in model.plan(tasks)} - shared
        model.train()
        for _, p, _ in self._params:
            p.grad = None

        items: Dict[str, LossItems] = {}
        for t in tasks:
            batch = batches[t]
            img = batch["img"]
            if img.dtype == torch.uint8:
                img = img.float() / 255.0
            x = img.permute(0, 3, 1, 2).to(self.compute_dtype)
            feats = model(x, tasks=[t], img_mask=batch.get("img_mask"),
                          freeze_bn_uids=shared, group=self.group)[t]
            loss_t, items[t] = self.losses[t](feats, batch, group=self.group)
            if mark:
                mark("forward_loss")
            (self.task_weights[t] * loss_t).backward()
            del feats, loss_t
            if mark:
                mark("backward")

        with torch.no_grad():
            scales = model.grad_scale(tasks)
            params, grads = {}, {}
            by_scale: Dict[float, List[torch.Tensor]] = {}
            for name, p, uid in self._params:
                if uid not in active:
                    p.grad = None  # no update, decay or momentum at all
                    continue
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                params[name], grads[name] = p, p.grad
                by_scale.setdefault(scales[uid], []).append(p.grad)
            if self.group is not None:
                _sum_over_ranks(list(grads.values()), self.group)
            for s, gs in by_scale.items():
                if s != 1.0:
                    torch._foreach_mul_(gs, s)
            clip_by_global_norm(list(grads.values()), self.max_grad_norm)
            if mark:
                mark("clip")
            sgd_apply(self.sgd, params, grads, state.opt_state, scalars[:N_UPDATE_SCALARS])
            if mark:
                mark("optimizer")
            ema_apply(state.ema.state_dict().values(), model.state_dict().values(),
                      scalars[N_UPDATE_SCALARS:])
        if mark:
            mark("ema")
        return items
