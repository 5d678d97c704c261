"""Plain PyTorch reference of the CerberusDet multi-task YOLOv8 detector.

Written from the model description (a YOLOv8 backbone and neck in the yaml's
rows, branched per task after the `cerber` split, one decoupled Detect head a
task), independent of the program: it reads the configuration dict and a flat
{name: tensor} weight dict whose names follow the program's parameter names,
which is how the benchmark hands one set of weights to both. NCHW, float32
(or float64), eval-mode BatchNorm from running statistics.

`quant_bits` emulates post-training quantization of every Conv (not the
Detect towers' last 1x1): weights per output channel from the BatchNorm-folded
float32 weights, activations per tensor from max |input| over calibration
frames, both symmetric, rounded half to even; the conv then runs on the
dequantized values in float32. 8 bits is the int8 serving configuration, 4
bits its control. `act_dtype` (bfloat16 for int8 served with bf16 elsewhere)
rounds each quantized Conv's input and output to that dtype, where the
serving configuration stores its activations.

`groups` ({Conv prefix: groups}, empty here) lets a family whose blocks hold
grouped or depthwise Convs run them through `conv`; every other Conv is
ungrouped, and a weight that does not fit its input raises.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # the running statistics' update in training
REG_MAX = 16
CH_MODULES = {"Conv", "C2f", "SPPF"}
REPEAT_MODULES = {"C2f"}


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


class Node:
    def __init__(self, idx, frm, name, args, c2, log2s):
        self.idx, self.frm, self.name, self.args, self.c2, self.log2s = (
            idx, frm, name, args, c2, log2s)


def parse(cfg: dict):
    """(nodes, n_backbone, head_from, strides, head_ch) of a model dict with
    backbone / neck / head rows [from, repeats, module, args]."""
    gd, gw = cfg.get("depth_multiple", 1.0), cfg.get("width_multiple", 1.0)
    nodes: List[Node] = []
    for row in list(cfg["backbone"]) + list(cfg.get("neck", [])):
        i = len(nodes)
        f, n, name, args = row
        frm = [max(i + j, -1) if j < 0 else j for j in (f if isinstance(f, list) else [f])]
        ch = [3 if j < 0 else nodes[j].c2 for j in frm]
        sc = [0 if j < 0 else nodes[j].log2s for j in frm]
        n = max(round(n * gd), 1) if n > 1 else n
        if name in CH_MODULES:
            c2 = make_divisible(args[0] * gw, 8)
            if name == "Conv":
                k = args[1] if len(args) > 1 else 1
                s = args[2] if len(args) > 2 else 1
                a = dict(c1=ch[0], c2=c2, k=k, s=s)
                log2s = sc[0] + (1 if s == 2 else 0)
            elif name == "C2f":
                a = dict(c1=ch[0], c2=c2, n=n, shortcut=bool(args[1]) if len(args) > 1 else False)
                log2s = sc[0]
            else:  # SPPF
                a = dict(c1=ch[0], c2=c2, k=args[1] if len(args) > 1 else 5)
                log2s = sc[0]
        elif name in ("nn.Upsample", "Upsample"):
            name, c2, a, log2s = "Upsample", ch[0], dict(f=int(args[1])), sc[0] - int(math.log2(args[1]))
        elif name == "Concat":
            c2, a, log2s = sum(ch), {}, sc[0]
        else:
            raise ValueError(f"the reference has no {name}")
        nodes.append(Node(i, frm, name, a, c2, log2s))
    hf = cfg["head"][0][0]
    head_from = [j if j >= 0 else len(nodes) + j for j in hf]
    strides = [2.0 ** nodes[j].log2s for j in head_from]
    return nodes, len(cfg["backbone"]), head_from, strides, [nodes[j].c2 for j in head_from]


def branch_uids(cfg: dict, tasks: Sequence[str]) -> Dict[str, List[str]]:
    """{task: [uid of node j]}: backbone node j is "b{j}"; a neck node is
    "n{j}" plus, for each cerber split before it, ":{k}_{group}" (joined by
    "-"), the group of the split that holds the task. Head ids in the
    schedule count backbone 0, neck layers 1..n_neck, then the tasks."""
    nodes, nb, _, _, _ = parse(cfg)
    n_neck = len(nodes) - nb
    splits = sorted((int(k), [[h - (n_neck + 1) for h in g] for g in groups])
                    for k, groups in (cfg.get("cerber") or []))
    out = {}
    for ti, t in enumerate(tasks):
        uids = []
        for j in range(len(nodes)):
            if j < nb:
                uids.append(f"b{j}")
                continue
            c = j - nb + 1
            comps = [f"{k}_{gi}" for k, groups in splits if c > k
                     for gi, g in enumerate(groups) if ti in g]
            uids.append(f"n{j}" + (":" + "-".join(comps) if comps else ""))
        out[t] = uids
    return out


def head_widths(ch0: int, nc: int) -> Tuple[int, int]:
    return max(16, ch0 // 4, REG_MAX * 4), max(ch0, nc)


def param_shapes(cfg: dict, tasks: Sequence[str], ncs: Sequence[int]) -> Dict[str, tuple]:
    """{name: shape} of every weight, in a fixed order: per Conv `w`, `bn.weight`,
    `bn.bias`, `bn.running_mean`, `bn.running_var`; per tower's last 1x1 `w`, `b`."""
    nodes, _, _, _, head_ch = parse(cfg)
    out: Dict[str, tuple] = {}

    def conv(p, c1, c2, k):
        out[f"{p}.w"] = (c2, c1, k, k)
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[f"{p}.bn.{s}"] = (c2,)

    seen = set()
    for t, uids in branch_uids(cfg, tasks).items():
        for node, uid in zip(nodes, uids):
            if uid in seen:
                continue
            seen.add(uid)
            p, a = f"blocks.{uid}", node.args
            if node.name == "Conv":
                conv(p, a["c1"], a["c2"], a["k"])
            elif node.name == "C2f":
                c = a["c2"] // 2
                conv(f"{p}.cv1", a["c1"], 2 * c, 1)
                conv(f"{p}.cv2", (2 + a["n"]) * c, a["c2"], 1)
                for i in range(a["n"]):
                    conv(f"{p}.m.{i}.cv1", c, c, 3)
                    conv(f"{p}.m.{i}.cv2", c, c, 3)
            elif node.name == "SPPF":
                c = a["c1"] // 2
                conv(f"{p}.cv1", a["c1"], c, 1)
                conv(f"{p}.cv2", 4 * c, a["c2"], 1)
    for t, nc in zip(tasks, ncs):
        c2, c3 = head_widths(head_ch[0], nc)
        for i, c in enumerate(head_ch):
            for tower, width, n_out in (("box", c2, 4 * REG_MAX), ("cls", c3, nc)):
                p = f"blocks.head_{t}.{tower}{i}"
                conv(f"{p}.0", c, width, 3)
                conv(f"{p}.1", width, width, 3)
                out[f"{p}.2.w"] = (n_out, width, 1, 1)
                out[f"{p}.2.b"] = (n_out,)
    return out


class Reference:
    """forward(x (B, 3, H, W) in [0, 1]) -> {task: (B, N, 4 + nc) xywh pixel
    boxes and sigmoid scores}, anchors level-major then row-major.

    dtype: the compute dtype (float32 or float64; bfloat16 for a control).
    quant_bits: None, or the bits of the emulated quantized Convs; their
    activation scales come from `calibrate` (max |input| over frames in the
    float model), which must run first."""

    def __init__(self, cfg: dict, tasks: Sequence[str], ncs: Sequence[int],
                 weights: Dict[str, torch.Tensor], dtype=torch.float32,
                 quant_bits: Optional[int] = None, act_dtype: Optional[torch.dtype] = None):
        self.cfg, self.tasks, self.ncs = cfg, list(tasks), list(ncs)
        self.nodes, self.nb, self.head_from, self.strides, self.head_ch = parse(cfg)
        self.uids = branch_uids(cfg, tasks)
        self.dtype, self.quant_bits, self.act_dtype = dtype, quant_bits, act_dtype
        self.amax: Dict[str, float] = {}
        self.taps: Optional[Dict[str, torch.Tensor]] = None  # calibration
        self.bn_hook = None  # (prefix, conv output) -> None, before the BatchNorm
        self.training = False  # BatchNorm from each batch's statistics
        self.running = None  # training: {name: running statistic}, updated as each batch passes
        self.conv_cast = None  # (tensor) -> tensor: a control's rounding of conv inputs and weights
        self.groups: Dict[str, int] = {}  # Conv prefix -> groups (a family's grouped Convs)
        self.w = weights
        self._folded: Dict[Tuple[str, bool], Tuple[torch.Tensor, torch.Tensor]] = {}

    # ------------------------------------------------------------ layers
    def folded(self, p: str, quant: bool):
        """(w, b) of Conv `p` with its BatchNorm folded in, float32 (float64
        for a float64 reference), then with `quant` quantized per output
        channel to quant_bits, and cast to the compute dtype."""
        if (p, quant) not in self._folded:
            hi = torch.float64 if self.dtype == torch.float64 else torch.float32
            w = self.w[f"{p}.w"].to(hi)
            inv = torch.rsqrt(self.w[f"{p}.bn.running_var"].to(hi) + BN_EPS) \
                * self.w[f"{p}.bn.weight"].to(hi)
            b = self.w[f"{p}.bn.bias"].to(hi) - self.w[f"{p}.bn.running_mean"].to(hi) * inv
            w = w * inv[:, None, None, None]
            if quant:
                q = 2 ** (self.quant_bits - 1) - 1
                s = w.abs().amax(dim=(1, 2, 3)) / q
                s = torch.where(s == 0, torch.ones_like(s), s)
                w = torch.clamp(torch.round(w / s[:, None, None, None]), -q, q) * s[:, None, None, None]
            self._folded[p, quant] = (w.to(self.dtype), b.to(self.dtype))
        return self._folded[p, quant]

    def conv(self, p: str, x, k: int, s: int = 1, act: bool = True):
        if self.taps is not None:
            self.taps[p] = torch.maximum(self.taps.get(p, x.new_zeros(())), x.abs().amax().float())
        if self.training:
            w = self.w[f"{p}.w"]
            if self.conv_cast is not None:
                x, w = self.conv_cast(x), self.conv_cast(w)
            y = F.conv2d(x, w, None, s, k // 2, 1, self.groups.get(p, 1))
            mean = y.mean((0, 2, 3))
            var = (y - mean[:, None, None]).square().mean((0, 2, 3))
            if self.running is not None:
                with torch.no_grad():
                    n = y.numel() / y.shape[1]
                    for stat, v in (("mean", mean), ("var", var * n / max(n - 1, 1))):
                        r = self.running[f"{p}.bn.running_{stat}"]
                        r.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * v.detach())
            y = (y - mean[:, None, None]) * (torch.rsqrt(var + BN_EPS)
                                             * self.w[f"{p}.bn.weight"])[:, None, None] \
                + self.w[f"{p}.bn.bias"][:, None, None]
            return F.silu(y) if act else y
        if self.bn_hook is not None:  # unfolded: the hook sets the statistics first
            w = self.w[f"{p}.w"]
            y = F.conv2d(x, w.to(x.dtype), None, s, k // 2, 1, self.groups.get(p, 1))
            self.bn_hook(p, y)
            inv = torch.rsqrt(self.w[f"{p}.bn.running_var"] + BN_EPS) * self.w[f"{p}.bn.weight"]
            y = y * inv[:, None, None] + (self.w[f"{p}.bn.bias"]
                                          - self.w[f"{p}.bn.running_mean"] * inv)[:, None, None]
            return F.silu(y) if act else y
        quant = bool(self.quant_bits) and self.taps is None
        stored = quant and self.act_dtype is not None
        if stored:
            x = x.to(self.act_dtype).to(self.dtype)
        if quant:
            q = 2 ** (self.quant_bits - 1) - 1
            sx = torch.tensor(self.amax[p] / q, dtype=torch.float32)
            inv_sx = (1.0 / sx).item()
            xq = torch.clamp(torch.round(x.float() * inv_sx), -q, q)
            x = (xq * sx.item()).to(self.dtype)
        w, b = self.folded(p, quant)
        y = F.conv2d(x, w, b, s, k // 2, 1, self.groups.get(p, 1))
        y = F.silu(y) if act else y
        return y.to(self.act_dtype).to(self.dtype) if stored else y

    def c2f(self, p, x, a):
        c = a["c2"] // 2
        y = self.conv(f"{p}.cv1", x, 1)
        ys = [y[:, :c], y[:, c:]]
        for i in range(a["n"]):
            h = self.conv(f"{p}.m.{i}.cv2", self.conv(f"{p}.m.{i}.cv1", ys[-1], 3), 3)
            ys.append(ys[-1] + h if a["shortcut"] else h)
        return self.conv(f"{p}.cv2", torch.cat(ys, 1), 1)

    def sppf(self, p, x, a):
        x = self.conv(f"{p}.cv1", x, 1)
        k = a["k"]
        y1 = F.max_pool2d(x, k, 1, k // 2)
        y2 = F.max_pool2d(y1, k, 1, k // 2)
        y3 = F.max_pool2d(y2, k, 1, k // 2)
        return self.conv(f"{p}.cv2", torch.cat([x, y1, y2, y3], 1), 1)

    def node(self, node: Node, uid: str, xs):
        p, a = f"blocks.{uid}", node.args
        if node.name == "Conv":
            return self.conv(p, xs[0], a["k"], a["s"])
        if node.name == "C2f":
            return self.c2f(p, xs[0], a)
        if node.name == "SPPF":
            return self.sppf(p, xs[0], a)
        if node.name == "Upsample":
            return F.interpolate(xs[0], scale_factor=a["f"], mode="nearest")
        return torch.cat(xs, 1)  # Concat

    def head_maps(self, t: str, xs) -> List[torch.Tensor]:
        """The per-level (B, 4 * REG_MAX + nc, H, W) maps of task t's head."""
        out = []
        for i, x in enumerate(xs):
            towers = []
            for tower in ("box", "cls"):
                p = f"blocks.head_{t}.{tower}{i}"
                h = self.conv(f"{p}.1", self.conv(f"{p}.0", x, 3), 3)
                w = self.w[f"{p}.2.w"].to(h.dtype)
                if self.training and self.conv_cast is not None:
                    h, w = self.conv_cast(h), self.conv_cast(w)
                towers.append(F.conv2d(h, w, self.w[f"{p}.2.b"].to(h.dtype)))
            out.append(torch.cat(towers, 1))
        return out

    def features(self, x, tasks: Optional[Sequence[str]] = None):
        """{task: [head maps]}, every shared block computed once."""
        x = x.to(self.dtype)
        done: Dict[str, torch.Tensor] = {}
        result = {}
        for t in (self.tasks if tasks is None else tasks):
            uids = self.uids[t]
            for node, uid in zip(self.nodes, uids):
                if uid not in done:
                    done[uid] = self.node(node, uid, [x if j < 0 else done[uids[j]]
                                                      for j in node.frm])
            result[t] = self.head_maps(t, [done[uids[j]] for j in self.head_from])
        return result

    def decode(self, maps: List[torch.Tensor]):
        b = maps[0].shape[0]
        dev = maps[0].device
        pts, strd = [], []
        for f, s in zip(maps, self.strides):
            h, w = f.shape[2:]
            gy, gx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64) + 0.5,
                                    torch.arange(w, device=dev, dtype=torch.float64) + 0.5,
                                    indexing="ij")
            pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
            strd.append(torch.full((h * w, 1), s, device=dev, dtype=torch.float64))
        pts, strd = torch.cat(pts), torch.cat(strd)
        hi = torch.float64 if self.dtype == torch.float64 else torch.float32
        flat = torch.cat([f.reshape(b, f.shape[1], -1) for f in maps], 2).transpose(1, 2).to(hi)
        dist = torch.softmax(flat[..., :4 * REG_MAX].reshape(b, -1, 4, REG_MAX), -1) \
            @ torch.arange(REG_MAX, device=dev, dtype=hi)
        lt, rb = dist[..., :2], dist[..., 2:]
        pts, strd = pts.to(hi), strd.to(hi)
        x1y1, x2y2 = pts - lt, pts + rb
        boxes = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1) * strd
        return torch.cat([boxes, torch.sigmoid(flat[..., 4 * REG_MAX:])], -1)

    @torch.no_grad()
    def forward(self, x) -> Dict[str, torch.Tensor]:
        return {t: self.decode(m) for t, m in self.features(x).items()}

    @torch.no_grad()
    def calibrate(self, frames: Sequence[torch.Tensor]) -> None:
        """Activation amax of every Conv over `frames` ((B, 3, H, W) in [0, 1]),
        from the float model (quantization off while it runs)."""
        taps: Dict[str, torch.Tensor] = {}
        self.taps = taps
        try:
            for x in frames:
                self.features(x)
        finally:
            self.taps = None
        self.amax = {k: float(v) for k, v in zip(taps, torch.stack(list(taps.values())).tolist())}
