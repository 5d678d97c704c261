"""The multi-task gradient-averaging train step.

Counterpart of cerberusdet_tpu/train/step.py (the reference's
averaging.py:97-223). One step, over the active tasks in model task order:

    for t: loss_t = w_t * DetectionLoss_t(model(batch_t, tasks=[t]))
           backward(loss_t)                   # gradients summed in .grad
    grads *= 1 / serving count (per block, over the active tasks)
    grads  = clip_by_global_norm(grads, 10)
    params = optimizer(params, grads)         # 3 groups, active blocks only
    ema    = ramped-decay EMA(params and BN buffers)

The JAX step is one pure function. Here the state is updated in place: the
model holds float32 master parameters and BN buffers, and a backward per
task frees that task's graph before the next forward. BatchNorm folds each
task's batch statistics into its running statistics during that task's
forward (nn/module.py), in task order, which is where the JAX step folds
them after the optimizer: the optimizer does not touch them, and a training
forward does not read them.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.models.cerberus import CerberusModel, module_key
from cerberusdet_tpu_torch.train.loss import DetectionLoss, LossItems
from cerberusdet_tpu_torch.train.optim import (
    OptState,
    SGDConfig,
    clip_by_global_norm,
    ema_update,
    param_group,
    sgd_init,
    sgd_update,
)


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


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class MultiTaskTrainer:
    """Steps a TrainState of `model` with per-task DetectionLosses. Runs on
    the card unless device="cpu"; the model must already be there."""

    def __init__(self, model: CerberusModel, losses: Dict[str, DetectionLoss],
                 task_weights: Optional[Dict[str, float]] = None,
                 sgd: SGDConfig = SGDConfig(), compute_dtype=torch.float32,
                 max_grad_norm: float = 10.0, ema_decay0: float = 0.9999, device=None):
        self.device = resolve_device(device)
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

    def step(self, state: TrainState, batches: Dict[str, Dict], lrs, momentum,
             freeze_shared: bool = False,
             mark: Optional[Callable[[str], None]] = None
             ) -> Tuple[TrainState, Dict[str, LossItems]]:
        """One optimizer step over the given per-task batches.

        batches: {task: {'img': (B, H, W, 3) float in [0, 1] or uint8, 'cls',
        'bboxes', 'mask', 'prob', optional 'img_mask'}} as arrays or tensors.
        lrs: (3,) per-group learning rates; momentum: a scalar. Returns
        (state, {task: LossItems}); the state is the same object, updated.
        `mark`, when given, is called with each stage's name as it ends:
        "forward_loss" and "backward" per task, then "update"."""
        model = state.model
        if model is not self.model:
            raise ValueError("the state belongs to another model")
        tasks = sorted(batches, key=model.task_ids.index)
        shared = set(model.shared_uids()) if freeze_shared else set()
        active = {s.uid for s in model.plan(tasks)} - shared
        model.train()
        for _, p, _ in self._params:
            p.grad = None

        items: Dict[str, LossItems] = {}
        for t in tasks:
            batch = _to_device(batches[t], self.device)
            img = batch["img"]
            if img.dtype == torch.uint8:
                img = img.float() / 255.0
            x = img.permute(0, 3, 1, 2).to(self.compute_dtype)
            feats = model(x, tasks=[t], img_mask=batch.get("img_mask"),
                          freeze_bn_uids=shared)[t]
            loss_t, items[t] = self.losses[t](feats, batch)
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
            for s, gs in by_scale.items():
                if s != 1.0:
                    torch._foreach_mul_(gs, s)
            clip_by_global_norm(list(grads.values()), self.max_grad_norm)
            sgd_update(self.sgd, params, grads, state.opt_state,
                       np.asarray(lrs, np.float32), momentum)
            state.n_updates += 1
            ema_update(state.ema.state_dict().values(), model.state_dict().values(),
                       state.n_updates, self.ema_decay0)
        if mark:
            mark("update")
        return state, items
