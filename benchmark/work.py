"""Work counted from shapes: each convolution's operations and bytes, the
published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W), and
the least time a convolution can take on them. `convs` counts the YOLOv8
family's forward (families/yolov8.py); another family counts its own.

A convolution's operations are 2 x MACs (Ho * Wo * Co * Ci * k * k per
image); its bytes are its input, weight and output, each counted once, at
the precision it runs in: an int8 conv reads int8 activations and weights
and writes the compute dtype (bfloat16); a bfloat16 conv reads and writes
bfloat16.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

from benchmark.reference.model import REG_MAX, branch_uids, head_widths, parse

PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
BYTES = {"int8": 1, "bf16": 2}
# the values each pass of a training BatchNorm + SiLU reads or writes, for a
# value of its map, by the wrapper that launches it (readers.BN_SILU_KERNELS):
# the statistics read x; the affine + SiLU reads x, writes y; the gradient's
# reduction reads x, dy; dx reads x, dy, writes dx
BN_SILU_PASS_VALUES = {"bn_stats": 1, "bn_apply": 2, "bn_grad_reduce": 2, "bn_dx": 3}


class ConvWork(NamedTuple):
    name: str
    # "conv" (Conv: conv + BN + SiLU) or "plain" (a tower's last 1x1); a family
    # may add kinds, each read by readers of its own (conv_roofline reads these two)
    kind: str
    macs: int          # per image
    in_elems: int      # per image
    w_elems: int
    out_elems: int     # per image


def convs(cfg: dict, tasks: Sequence[str], ncs: Sequence[int], h: int, w: int) -> List[ConvWork]:
    """Every convolution of the all-heads forward of one (3, h, w) image."""
    nodes, _, head_from, strides, head_ch = parse(cfg)
    out: List[ConvWork] = []
    size: Dict[int, tuple] = {}  # node -> (c, h, w)

    def conv(name, c1, c2, k, s, hw, kind="conv"):
        ho, wo = (hw[0] + s - 1) // s, (hw[1] + s - 1) // s
        out.append(ConvWork(name, kind, ho * wo * c2 * c1 * k * k, c1 * hw[0] * hw[1],
                            c2 * c1 * k * k, c2 * ho * wo))
        return ho, wo

    seen = set()
    uids = branch_uids(cfg, tasks)
    for t in tasks:
        for j, (node, uid) in enumerate(zip(nodes, uids[t])):
            ins = [(3, h, w) if f < 0 else size[(t, f)] for f in node.frm]
            c1, hw = ins[0][0], ins[0][1:]
            a = node.args
            if node.name == "Conv":
                o = conv(uid, c1, a["c2"], a["k"], a["s"], hw) if uid not in seen else \
                    ((hw[0] + a["s"] - 1) // a["s"], (hw[1] + a["s"] - 1) // a["s"])
                size[(t, j)] = (a["c2"],) + tuple(o)
            elif node.name == "C2f":
                c = a["c2"] // 2
                if uid not in seen:
                    conv(f"{uid}.cv1", c1, 2 * c, 1, 1, hw)
                    for i in range(a["n"]):
                        conv(f"{uid}.m.{i}.cv1", c, c, 3, 1, hw)
                        conv(f"{uid}.m.{i}.cv2", c, c, 3, 1, hw)
                    conv(f"{uid}.cv2", (2 + a["n"]) * c, a["c2"], 1, 1, hw)
                size[(t, j)] = (a["c2"],) + tuple(hw)
            elif node.name == "SPPF":
                c = c1 // 2
                if uid not in seen:
                    conv(f"{uid}.cv1", c1, c, 1, 1, hw)
                    conv(f"{uid}.cv2", 4 * c, a["c2"], 1, 1, hw)
                size[(t, j)] = (a["c2"],) + tuple(hw)
            elif node.name == "Upsample":
                size[(t, j)] = (c1, hw[0] * a["f"], hw[1] * a["f"])
            else:  # Concat
                size[(t, j)] = (sum(x[0] for x in ins),) + tuple(hw)
            seen.add(uid)
        for nc in [ncs[tasks.index(t)]]:
            c2, c3 = head_widths(head_ch[0], nc)
            for i, f in enumerate(head_from):
                c, hh, ww = size[(t, f)]
                for tower, width, n_out in (("box", c2, 4 * REG_MAX), ("cls", c3, nc)):
                    p = f"head_{t}.{tower}{i}"
                    conv(f"{p}.0", c, width, 3, 1, (hh, ww))
                    conv(f"{p}.1", width, width, 3, 1, (hh, ww))
                    conv(f"{p}.2", width, n_out, 1, 1, (hh, ww), kind="plain")
    return out


def forward_ops(work: List[ConvWork]) -> float:
    """Operations (2 x MACs) of one image's forward."""
    return 2.0 * sum(c.macs for c in work)


def least_seconds(c: ConvWork, precision: str, images: int) -> float:
    """The least time of conv `c` over `images` images at `precision`
    ("int8" or "bf16"): the larger of its operations over the peak and its
    bytes over the bandwidth (int8 writes bfloat16)."""
    b_in = BYTES[precision]
    nbytes = images * (c.in_elems * b_in + c.out_elems * 2) + c.w_elems * b_in
    return max(2.0 * c.macs * images / PEAK_OPS[precision], nbytes / PEAK_BYTES)


def bn_silu_bytes(work: List[ConvWork], images: int) -> float:
    """The bytes the training BatchNorm + SiLU passes move over `images`
    images' forward `work`: a BatchNorm on each Conv's output ("conv"
    kind), each value read or written once a pass (BN_SILU_PASS_VALUES), in
    bfloat16."""
    return sum(BN_SILU_PASS_VALUES.values()) * BYTES["bf16"] * images * sum(
        c.out_elems for c in work if c.kind == "conv")


def peak_seconds(work: List[ConvWork], precision: str, images: int) -> float:
    """The time the forward's operations take at the peaks: a Conv at the
    cell's precision, a tower's last 1x1 (never quantized) at bfloat16."""
    return sum(2.0 * c.macs * images / PEAK_OPS[precision if c.kind == "conv" else "bf16"]
               for c in work)
