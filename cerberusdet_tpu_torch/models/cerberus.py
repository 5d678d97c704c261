"""CerberusDet multi-task model: static branch plan + forward over all heads.

Counterpart of cerberusdet_tpu/models/cerberus.py. The `cerber` schedule is
resolved once into per-(task, neck layer) branch labels; every unique
(layer, label) pair is one block ("uid"), and the forward walks the union of
the requested tasks' chains, computing each shared block once. Blocks live in
one ModuleDict keyed by uid ('.' is not allowed in a module name, so it is
stored as '_'; `block(uid)` hides that).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.models.config import ParsedModel, parse_model_cfg
from cerberusdet_tpu_torch.nn.layers import SEEDED, Conv, Detect
from cerberusdet_tpu_torch.nn.module import BatchNorm
from cerberusdet_tpu_torch.parallel.spatial import sharded

Label = Tuple[Tuple[int, int], ...]  # ((split_layer, group_idx), ...)


def _head_id_to_task(head_id: int, n_neck: int, n_tasks: int) -> int:
    """cerber head numbering: backbone=0, neck=1..n_neck, heads follow."""
    t = head_id - (n_neck + 1)
    if not 0 <= t < n_tasks:
        raise ValueError(f"cerber head id {head_id} out of range for {n_tasks} tasks")
    return t


def build_branch_labels(cerber: Optional[list], n_neck: int, n_tasks: int
                        ) -> Dict[int, List[Label]]:
    """For each task, the branch label of every neck layer (cerber index
    1..n_neck): the (split_layer, group) pairs of every split before it."""
    splits: List[Tuple[int, List[List[int]]]] = []
    for k, groups in (cerber or []):
        task_groups = [[_head_id_to_task(h, n_neck, n_tasks) for h in g] for g in groups]
        splits.append((int(k), task_groups))
    splits.sort(key=lambda s: s[0])

    out: Dict[int, List[Label]] = {}
    for t in range(n_tasks):
        labels: List[Label] = []
        for layer in range(1, n_neck + 1):
            comps: List[Tuple[int, int]] = []
            for k, groups in splits:
                if layer <= k:
                    continue
                for gi, g in enumerate(groups):
                    if t in g:
                        comps.append((k, gi))
                        break
            labels.append(tuple(comps))
        out[t] = labels
    return out


def _label_str(label: Label) -> str:
    return "" if not label else ":" + "-".join(f"{k}.{g}" for k, g in label)


def module_key(uid: str) -> str:
    """ModuleDict key of a block uid."""
    return uid.replace(".", "_")


@dataclasses.dataclass
class PlanStep:
    uid: str                 # block uid
    node_idx: int            # yolo index into parsed.nodes (-1 for heads)
    in_uids: List[str]       # uids of the inputs ('__input__' for the image)
    task: Optional[str] = None  # set for head steps


class CerberusModel(nn.Module):
    """Multi-task detector. forward(x NCHW, tasks=None) -> {task: (preds, feats)}
    with the Detect outputs of nn/layers.py. Parameters are created on
    `device` (the card when None) and are undefined until `init(seed)` or a
    weight load (manager/weights.py)."""

    def __init__(self, cfg: Union[str, dict], task_ids: Sequence[str],
                 nc: Union[int, Sequence[int]], device=None):
        super().__init__()
        self.task_ids = list(task_ids)
        ncs = [nc] * len(task_ids) if isinstance(nc, int) else list(nc)
        if len(ncs) != len(self.task_ids):
            raise ValueError("nc list must match task_ids")
        self.nc = {t: n for t, n in zip(self.task_ids, ncs)}
        device = resolve_device(device)
        with device:
            self.parsed: ParsedModel = parse_model_cfg(cfg)
        p = self.parsed
        self.n_backbone = p.n_backbone
        self.n_neck = len(p.nodes) - p.n_backbone
        self.strides = tuple(p.head_strides)
        self.labels = build_branch_labels(p.cerber, self.n_neck, len(self.task_ids))

        # backbone node i -> "b{i}"; neck node j of task t -> "n{j}{label}"
        self._task_node_uid: Dict[Tuple[int, int], str] = {
            (ti, j): self._uid_for(ti, j)
            for ti in range(len(self.task_ids)) for j in range(len(p.nodes))}
        self.block_nodes: Dict[str, int] = {}
        for (ti, j), uid in self._task_node_uid.items():
            self.block_nodes.setdefault(uid, j)

        self.serving_counts: Dict[str, int] = {}
        for ti, t in enumerate(self.task_ids):
            for j in range(len(p.nodes)):
                uid = self._task_node_uid[(ti, j)]
                self.serving_counts[uid] = self.serving_counts.get(uid, 0) + 1
            self.serving_counts[self.head_uid(t)] = 1

        # one module per uid: a node's first uid takes the parsed layer, its
        # branched clones take copies of it
        blocks: Dict[str, nn.Module] = {}
        used = set()
        for uid, j in self.block_nodes.items():
            layer = p.nodes[j].layer
            blocks[module_key(uid)] = copy.deepcopy(layer) if j in used else layer
            used.add(j)
        with device:
            for t in self.task_ids:
                head = Detect(self.nc[t], p.head_ch)
                head.stride = self.strides
                blocks[module_key(self.head_uid(t))] = head
        self.blocks = nn.ModuleDict(blocks)
        self._bn_of: Dict[str, List[BatchNorm]] = {}  # uid -> its BatchNorms

    # ------------------------------------------------------------------ uids
    def _uid_for(self, task_idx: int, node_idx: int) -> str:
        if node_idx < self.n_backbone:
            return f"b{node_idx}"
        c = node_idx - self.n_backbone + 1  # cerber index
        label = self.labels[task_idx][c - 1]
        return f"n{node_idx}{_label_str(label)}"

    def head_uid(self, task: str) -> str:
        return f"head_{task}"

    def block(self, uid: str) -> nn.Module:
        return self.blocks[module_key(uid)]

    # ------------------------------------------------------------------ plan
    def plan(self, tasks: Optional[Sequence[str]] = None) -> List[PlanStep]:
        """Topologically ordered unique steps for the requested task subset."""
        tasks = list(tasks) if tasks is not None else list(self.task_ids)
        p = self.parsed
        steps: List[PlanStep] = []
        seen = set()
        for t in tasks:
            ti = self.task_ids.index(t)
            for j in range(len(p.nodes)):
                uid = self._task_node_uid[(ti, j)]
                if uid in seen:
                    continue
                seen.add(uid)
                in_uids = ["__input__" if f < 0 else self._task_node_uid[(ti, f)]
                           for f in p.nodes[j].frm]
                steps.append(PlanStep(uid=uid, node_idx=j, in_uids=in_uids))
        for t in tasks:
            ti = self.task_ids.index(t)
            in_uids = [self._task_node_uid[(ti, f)] for f in p.head_from]
            steps.append(PlanStep(uid=self.head_uid(t), node_idx=-1, in_uids=in_uids, task=t))
        return steps

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, seed: int = 0) -> "CerberusModel":
        """Random init from `seed`: kaiming-uniform convs, unit BatchNorm and
        the Detect prior biases, the JAX package's scheme (its numbers differ:
        weights move between the two through manager/weights.py); the other
        layers of nn/layers.py:SEEDED as the JAX package inits them."""
        gen = torch.Generator().manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, SEEDED):
                m.reset(gen)
        for t in self.task_ids:
            self.block(self.head_uid(t)).bias_init()
        return self

    # ---------------------------------------------------------- training aids
    def grad_scale(self, tasks: Optional[Sequence[str]] = None) -> Dict[str, float]:
        """{uid: 1 / serving count} over the active `tasks` (all when None):
        the gradient averaging of the reference (averaging.py:211-217)."""
        if tasks is None:
            counts = self.serving_counts
        else:
            counts = {}
            for t in tasks:
                ti = self.task_ids.index(t)
                for j in range(len(self.parsed.nodes)):
                    uid = self._task_node_uid[(ti, j)]
                    counts[uid] = counts.get(uid, 0) + 1
                counts[self.head_uid(t)] = 1
        uids = list(self.block_nodes) + [self.head_uid(t) for t in self.task_ids]
        return {uid: 1.0 / float(max(counts.get(uid, 1), 1)) for uid in uids}

    def shared_uids(self) -> List[str]:
        """Blocks serving more than one task (every backbone/neck block when
        there is a single task): the freeze_shared target set."""
        if len(self.task_ids) == 1:
            return list(self.block_nodes)
        return [u for u, n in self.serving_counts.items() if n > 1]

    def _batch_norms(self, uid: str) -> List[BatchNorm]:
        if uid not in self._bn_of:
            self._bn_of[uid] = [m for m in self.block(uid).modules()
                                if isinstance(m, BatchNorm)]
        return self._bn_of[uid]

    # --------------------------------------------------------------- forward
    def forward(self, x, tasks: Optional[Sequence[str]] = None, img_mask=None,
                freeze_bn_uids: Sequence[str] = (), group=None, spatial=None):
        """x: (B, 3, H, W) in the compute dtype. Returns {task: (preds, feats)}
        in eval mode, {task: feats} in training mode. In training, the
        BatchNorms of blocks in `freeze_bn_uids` use their running
        statistics, and `img_mask` (B,) weights the batch statistics of the
        others, taken over the ranks of `group` when it is given (data
        parallelism, nn/module.py:BatchNorm). A block annotated with `q_out`
        (quant/ptq.py:propagate_act_quant) hands its output on quantized to
        int8 with that scale, as the JAX package's forward does: the block
        quantizes it itself (nn/layers.py), in its last Conv. With `spatial`
        (parallel/spatial.py: a SpatialMesh, eval only) x is this rank's rows
        of the image and the layers exchange halo rows with the other ranks;
        the Detect heads return the whole maps and predictions."""
        with sharded(spatial):
            return self._forward(x, tasks, img_mask, freeze_bn_uids, group)

    def _forward(self, x, tasks, img_mask, freeze_bn_uids, group):
        frozen = frozenset(freeze_bn_uids)
        outputs = {"__input__": x}
        results = {}
        for step in self.plan(tasks):
            for bn in self._batch_norms(step.uid):
                bn.frozen = step.uid in frozen
                bn.img_mask = img_mask
                bn.group = group
            if step.task is not None:
                xs = [outputs[u] for u in step.in_uids]
                results[step.task] = self.block(step.uid)(xs)
                continue
            if self.parsed.nodes[step.node_idx].name == "Concat":
                inp = [outputs[u] for u in step.in_uids]
            else:
                inp = outputs[step.in_uids[0]]
            outputs[step.uid] = self.block(step.uid)(inp)
        return results

    # ---------------------------------------------------------------- fuse
    @torch.no_grad()
    def fuse(self) -> "CerberusModel":
        """Fold every BatchNorm into its conv, in place (inference)."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.fuse()
        self._bn_of.clear()
        return self

    @property
    def fused(self) -> bool:
        return not any(isinstance(m, Conv) and hasattr(m, "bn") for m in self.modules())
