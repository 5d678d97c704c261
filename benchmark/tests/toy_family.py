"""A model family added as a file (families/toy.py in a test's root): the
YOLOv8 family's rows with depthwise Convs among them (DWConv, groups
gcd(c1, c2), as the program builds it), a block the YOLOv8 family's parser
lacks. A DWConv row reads as a Conv row of the same widths and stride, with
its weight's input channels divided by its groups, which the references
take from `groups`; its work is of its own kind, which the conv rooflines
leave out, and so are the kernels KERNEL_KINDS names for it."""

from __future__ import annotations

import math

import torch

from benchmark import weights
from benchmark.reference import model as M
from benchmark.reference import train as T
from benchmark.work import convs as v8_convs


def as_v8(cfg: dict) -> dict:
    rows = lambda part: [[f, n, "Conv" if m == "DWConv" else m, a] for f, n, m, a in cfg[part]]
    return {**cfg, "backbone": rows("backbone"), "neck": rows("neck")}


# the kernels of its depthwise work, by name fragment (PyTorch's conv_depthwise2d_*)
KERNEL_KINDS = {"depthwise": "dwconv"}


def depthwise(cfg: dict, tasks) -> dict:
    """{uid: groups} of the DWConv rows' blocks."""
    nodes = M.parse(as_v8(cfg))[0]
    rows = list(cfg["backbone"]) + list(cfg["neck"])
    return {uid: math.gcd(node.args["c1"], node.args["c2"])
            for uids in M.branch_uids(as_v8(cfg), tasks).values()
            for node, uid, row in zip(nodes, uids, rows) if row[2] == "DWConv"}


def param_shapes(cfg, tasks, ncs):
    out = M.param_shapes(as_v8(cfg), tasks, ncs)
    for uid, g in depthwise(cfg, tasks).items():
        c2, c1, k, _ = out[f"blocks.{uid}.w"]
        out[f"blocks.{uid}.w"] = (c2, c1 // g, k, k)
    return out


def convs(cfg, tasks, ncs, h, w):
    dw = depthwise(cfg, tasks)
    return [c._replace(kind="dwconv", macs=c.macs // dw[c.name], w_elems=c.w_elems // dw[c.name])
            if c.name in dw else c for c in v8_convs(as_v8(cfg), tasks, ncs, h, w)]


def groups(cfg: dict, tasks) -> dict:
    """{Conv prefix: groups} of the DWConv rows, as the references name them."""
    return {f"blocks.{uid}": g for uid, g in depthwise(cfg, tasks).items()}


class Reference(M.Reference):
    def __init__(self, cfg, tasks, *args, **kw):
        super().__init__(as_v8(cfg), tasks, *args, **kw)
        self.groups = groups(cfg, tasks)


class TrainReference(T.TrainReference):
    def __init__(self, cfg, tasks, *args, **kw):
        super().__init__(as_v8(cfg), tasks, *args, **kw)
        self.ref.groups = groups(cfg, tasks)


def make_weights(cfg, tasks, ncs, gen, calib, served=None):
    return weights.make_weights(param_shapes(cfg, tasks, ncs),
                                lambda w: Reference(cfg, tasks, ncs, w, torch.float32),
                                gen, calib, served)
