"""Model-YAML interpreter: backbone/neck/head sections -> static layer specs.

Copy of cerberusdet_tpu/models/config.py for the port: the same channel
propagation, depth/width multiples and make_divisible rounding, so that the
port's modules line up one to one with the JAX parameter tree. Layers are
built from the port's registry (nn/layers.py). The JAX parser's rules are
kept as they are: the blocks it builds from yaml are those of _CH_MODULES
beside Concat and Upsample (MixConv2d, Contract, Expand, TransformerLayer,
TransformerBlock, ImplicitA and ImplicitM are modules for Python only and
raise here); the repeat count goes in at argument 2, which is C3SPP's `k`,
so a C3SPP row raises TypeError as it does there; and a stride counts only
for Conv, DWConv, GhostConv and Focus (a CrossConv or GhostBottleneck at
s=2 keeps its input's log2_stride).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import List, Optional, Union

import yaml

from cerberusdet_tpu_torch.nn.layers import LAYERS, Concat, Upsample

# Modules whose first arg is an output-channel count subject to width scaling.
_CH_MODULES = {
    "Conv", "DWConv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP",
    "SPPF", "Focus", "CrossConv", "BottleneckCSP", "C3", "C3TR", "C3SPP",
    "C2f", "C2",
}
# Modules that take a repeat count `n` (inserted as 3rd ctor arg).
_REPEAT_MODULES = {"BottleneckCSP", "C3", "C3TR", "C3SPP", "C2f", "C2"}


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


@dataclasses.dataclass
class NodeSpec:
    """One layer of the unified backbone+neck graph (yolo numbering)."""

    idx: int                      # absolute yolo index (backbone 0.., neck after)
    frm: List[int]                # absolute input indices (resolved, no -1)
    name: str                     # module name from yaml
    layer: object                 # constructed nn.Module
    section: str                  # 'backbone' | 'neck'
    c2: int                       # output channels
    log2_stride: int              # spatial downscale (log2) of the OUTPUT


@dataclasses.dataclass
class ParsedModel:
    nodes: List[NodeSpec]                 # backbone + neck, yolo-indexed
    n_backbone: int
    head_from: List[int]                  # absolute indices feeding each Detect
    head_strides: List[float]
    head_ch: List[int]
    cerber: Optional[list]                # raw cerber schedule (or None)
    yaml_dict: dict


def load_cfg(cfg: Union[str, Path, dict]) -> dict:
    if isinstance(cfg, (str, Path)):
        with open(cfg) as f:
            return yaml.safe_load(f)
    return dict(cfg)


def parse_model_cfg(cfg: Union[str, Path, dict], ch_in: int = 3) -> ParsedModel:
    """Interpret a model yaml into NodeSpecs with resolved channels, routing
    and strides (strides computed analytically)."""
    d = load_cfg(cfg)
    gd = d.get("depth_multiple", 1.0)
    gw = d.get("width_multiple", 1.0)

    backbone = d["backbone"]
    neck = d.get("neck", [])
    head = d["head"]
    if len(head) != 1 or head[0][2] != "Detect":
        raise ValueError("expected a single Detect head section")

    nodes: List[NodeSpec] = []
    ch: List[int] = []          # output channels per node
    scale: List[int] = []       # log2 stride per node

    def resolve_from(f, i: int) -> List[int]:
        """Resolve relative refs to absolute node indices; -1 for node 0 maps
        to the virtual input node (kept as -1)."""
        fs = f if isinstance(f, list) else [f]
        return [max(i + j, -1) if j < 0 else j for j in fs]

    def in_ch(j: int) -> int:
        return ch_in if j < 0 else ch[j]

    def in_scale(j: int) -> int:
        return 0 if j < 0 else scale[j]

    for section, rows in (("backbone", backbone), ("neck", neck)):
        for row in rows:
            i = len(nodes)
            f, n, name, args = row
            frm = resolve_from(f, i)
            args = [None if a == "None" else a for a in args]
            n_ = max(round(n * gd), 1) if n > 1 else n
            if name in _CH_MODULES:
                c1 = in_ch(frm[0])
                c2 = make_divisible(args[0] * gw, 8)
                largs = [c1, c2, *args[1:]]
                if name in _REPEAT_MODULES:
                    largs.insert(2, n_)
                    n_ = 1
                layer = LAYERS[name](*largs)
                out_c = c2
                ds = 0
                # stride from ctor: Conv-like args (c1, c2, k, s, ...)
                s_arg = None
                if name in ("Conv", "DWConv", "GhostConv"):
                    s_arg = largs[3] if len(largs) > 3 else 1
                elif name == "Focus":
                    ds = 1
                if s_arg is not None and s_arg == 2:
                    ds = 1
                log2s = in_scale(frm[0]) + ds
            elif name in ("nn.Upsample", "Upsample"):
                layer = Upsample(*args)
                out_c = in_ch(frm[0])
                log2s = in_scale(frm[0]) - int(math.log2(layer.f))
            elif name == "Concat":
                layer = Concat(*args)
                out_c = sum(in_ch(j) for j in frm)
                layer.c2 = out_c
                log2s = in_scale(frm[0])
            else:
                raise ValueError(f"unsupported module in yaml: {name}")
            nodes.append(
                NodeSpec(idx=i, frm=frm, name=name, layer=layer, section=section,
                         c2=out_c, log2_stride=log2s)
            )
            ch.append(out_c)
            scale.append(log2s)

    hf, hn, hname, hargs = head[0]
    head_from = [j if j >= 0 else len(nodes) + j for j in (hf if isinstance(hf, list) else [hf])]
    head_strides = [float(2 ** scale[j]) for j in head_from]
    head_ch = [ch[j] for j in head_from]
    return ParsedModel(
        nodes=nodes,
        n_backbone=len(backbone),
        head_from=head_from,
        head_strides=head_strides,
        head_ch=head_ch,
        cerber=d.get("cerber"),
        yaml_dict=d,
    )
