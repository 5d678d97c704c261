"""C2f's concat -> 1x1 conv against summed per-chunk 1x1 convs.

The port's counterpart of cerberusdet_tpu/tools/bench_c2f_split.py. A C2f
block ends in concat(2 + n chunks) -> cv2, a 1x1 conv (the reference's
common.py:174-197). The 1x1 conv distributes over the concat: cv2's weights
sliced per input chunk and the partial convs summed remove the concat. The
trade: each partial conv has fewer input channels, and the concat's copy
goes. This tool measures both on the all-heads 2-task v8x forward at 640 px,
batch 32, with the headline's method (utils/profiling.py:HonestLoop: a
captured forward replayed as dependent iterations between CUDA events, best
of 3, and the conv-node guard, given the split's own count of convs):

  * bf16 (default): the split's partial convs on cuDNN, summed in bf16, then
    bias and SiLU; checked against the concat route in float32 at 128 px
    (rtol / atol 1e-4, TF32 off);
  * --int8: the model quantized "all" and propagated, as the JAX tool passes
    model=; each chunk is quantized with cv2's s_x as quant_cat_s8 writes it
    and packed (quant_pack_s8), runs through conv_s8 in its int32 output mode
    against its slice of cv2's weights, the int32 partials are summed and
    ops/conv_int8_cuda.py:conv_epilogue finishes the sum (dequantize, bias,
    SiLU, and where the block is annotated, mode 4's requantize). Integer sums
    are associative: the result equals the concat route bit for bit, checked
    at 128 px.

Prints one line a variant and then ONE JSON object {variant: {"ms_per_batch",
"img_per_s"}, "card": the card's name and power limit}.

Usage: python -m cerberusdet_tpu_torch.tools.bench_c2f_split [--int8] [--batch 32]
       [--iters 20] [--device cpu --cfg configs/models/yolov8n_2task.yaml --imgsz 64]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.bench import INT8_KERNELS, forward_fn, make_input, time_forward
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.nn.layers import C2f
from cerberusdet_tpu_torch.nn.module import silu
from cerberusdet_tpu_torch.ops import conv_int8_cuda
from cerberusdet_tpu_torch.ops.conv_int8_cuda import (
    conv_epilogue,
    conv_s8,
    pack_weight,
    quant_pack_s8,
    unpack_weight,
)
from cerberusdet_tpu_torch.quant import (
    calibrate_amax,
    fused_conv_weights,
    quantize_params,
    select_all,
)
from cerberusdet_tpu_torch.utils.profiling import device_label, honest_time, model_convs

def chunk_weights(block: C2f) -> List[torch.Tensor]:
    """cv2's weights sliced per input chunk (cv1's two halves, then each
    bottleneck's output, c channels each): (Co, c, 1, 1) float slices of a
    fused cv2, or (Co, 1, 1, c16) int8 ones packed as pack_weight lays out."""
    cv2 = block.cv2
    if cv2.k != (1, 1) or cv2.s != (1, 1) or cv2.g != 1:
        raise ValueError("the split takes a 1x1 stride-1 cv2")
    widths = [block.c] * (2 + len(block.m))
    if cv2.int8:
        w = unpack_weight(cv2.w_q, sum(widths))
    elif not hasattr(cv2, "b") or hasattr(cv2, "bn"):
        raise ValueError("the split takes a fused cv2")
    out, off = [], 0
    for ci in widths:
        if cv2.int8:
            out.append(pack_weight(w[:, :, off:off + ci, :].contiguous()))
        else:
            out.append(cv2.w[:, off:off + ci].contiguous())
        off += ci
    return out


def c2f_sumsplit(block: C2f, x: torch.Tensor, weights: List[torch.Tensor]) -> torch.Tensor:
    """C2f's forward with cv2 as summed per-chunk convs (the JAX tool's
    c2f_sumsplit_call and c2f_sumsplit_int8_call)."""
    cv2 = block.cv2
    q = cv2.s_x if cv2.int8 else None
    y = block.cv1(x)
    ys = [y[:, : block.c], y[:, block.c:]]
    for i, b in enumerate(block.m):
        ys.append(b(ys[-1], q_out=q if i == len(block.m) - 1 else None))
    if q is None:
        acc = None
        for t, w in zip(ys, weights):
            part = F.conv2d(t, w.to(t.dtype), None, cv2.s, cv2.p)
            acc = part if acc is None else acc + part
        y = acc + cv2.b.to(acc.dtype)[:, None, None]
        return (silu(y) if cv2.act else y).to(x.dtype)
    acc = None
    for t, w in zip(ys, weights):  # int8 chunks as they are, float ones quantized
        part = conv_s8(quant_pack_s8(t, q, w.shape[3]), w, q, cv2.s_w, cv2.b, 1, 0,
                       out_dtype=torch.int32)
        acc = part if acc is None else acc + part
    out_dtype = cv2.compute_like.dtype
    q_dtype = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    q_out = block.act_quant("q_out")
    if q_out is not None:
        return conv_epilogue(acc, q, cv2.s_w, cv2.b, cv2.act, torch.int8, q_out, q_dtype)
    kernel_out = out_dtype if out_dtype == torch.bfloat16 else torch.float32
    return conv_epilogue(acc, q, cv2.s_w, cv2.b, cv2.act, kernel_out).to(out_dtype)


@contextlib.contextmanager
def split_c2f(model):
    """Inside the block every C2f of `model` runs c2f_sumsplit."""
    weights: Dict[C2f, List[torch.Tensor]] = {
        m: chunk_weights(m) for m in model.modules() if isinstance(m, C2f)}
    orig = C2f.forward

    def forward(self, x):
        return c2f_sumsplit(self, x, weights[self])

    C2f.forward = forward
    try:
        yield
    finally:
        C2f.forward = orig


def split_convs(model) -> Tuple[int, int]:
    """model_convs of the split forward: each C2f's cv2 runs as 2 + n
    convs, conv_s8 launches where cv2 is int8."""
    n_convs, n_int8 = model_convs(model)
    for m in model.modules():
        if isinstance(m, C2f):
            n_convs += 1 + len(m.m)
            n_int8 += (1 + len(m.m)) * m.cv2.int8
    return n_convs, n_int8


def build(cfg: str, ncs, device, int8: bool, imgsz: int = 640) -> CerberusModel:
    """The all-heads model: init(0), fused, bf16; with int8 quantized "all"
    from its float32 fused weights, activation scales calibrated in bf16 on
    make_input's batch of 4 at imgsz (the timed batch's first 4 images, as
    the JAX tool calibrates), and propagated."""
    model = CerberusModel(cfg, [f"t{i}" for i in range(len(ncs))], ncs,
                          device=device).init(0).fuse().eval()
    weights = fused_conv_weights(model) if int8 else None
    model.to(torch.bfloat16)
    if int8:
        amax = calibrate_amax(model, [make_input(4, imgsz, device)])
        quantize_params(model, amax, select=select_all, weights=weights, propagate=True)
    return model


@torch.no_grad()
def check_equal(model, int8: bool, imgsz: int = 128) -> float:
    """The split against the concat route on a seeded (1, imgsz, imgsz, 3)
    batch: every C2f block's output and every task's predictions. int8 bit
    for bit (returns 0); otherwise a float32 copy of the model, TF32 off,
    within rtol 1e-4 and atol 1e-4 of each tensor's largest magnitude (a
    seeded model's activations shrink with depth, to ~1e-7 at the Detect
    towers, so the predictions alone would hide a difference). Returns the
    largest difference relative to its tensor's largest magnitude."""
    gen = torch.Generator().manual_seed(2)
    dev = next(iter(model.state_dict().values())).device
    x = torch.rand((1, imgsz, imgsz, 3), generator=gen).to(dev)
    m = model if int8 else copy.deepcopy(model).float()
    blocks = [b for b in m.modules() if isinstance(b, C2f)]
    outs: List[List[torch.Tensor]] = []
    hooks = [b.register_forward_hook(lambda mod, a, y: outs[-1].append(y)) for b in blocks]
    fwd = forward_fn(m) if int8 else (lambda img: {
        t: p for t, (p, _) in m(img.permute(0, 3, 1, 2)).items()})
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            torch.backends.cuda.matmul.allow_tf32 = False
            outs.append([])
            base = fwd(x)
            outs.append([])
            with split_c2f(m):
                split = fwd(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for h in hooks:
            h.remove()
    pairs = list(zip(outs[1], outs[0])) + [(split[t], base[t]) for t in base]
    if len(outs[0]) != len(blocks) or len(outs[1]) != len(blocks):
        raise AssertionError("the C2f blocks did not run once each in both routes")
    worst = 0.0
    for i, (a, b) in enumerate(pairs):
        what = f"C2f output {i}" if i < len(blocks) else "the predictions"
        if int8:
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: the int8 split differs from the concat route")
            continue
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * scale, msg=what)
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def conv_s8_launches(model, img) -> int:
    """conv_s8 launches of one eager forward of img (taken back after)."""
    counter = conv_int8_cuda.conv_s8
    before = counter.launches
    with torch.no_grad():
        forward_fn(model)(img)
    n = counter.launches - before
    counter.launches = before
    return n


@torch.no_grad()
def time_split(model, img, iters: int) -> Dict:
    """honest_time of the split forward, guarded by split_convs."""
    n_convs, n_int8 = split_convs(model)
    with split_c2f(model):
        r = honest_time(forward_fn(model), img, iters, n_convs, n_int8, INT8_KERNELS,
                        "c2f split")
    return {**r, "convs": n_convs, "int8_convs": n_int8}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--int8", action="store_true",
                    help="measure the rewrite on the int8 'all' graph")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cfg", default="configs/models/yolov8x_2task.yaml")
    ap.add_argument("--nc", default="20,19", help="per-task class counts")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    card = device_label(device)
    model = build(args.cfg, [int(x) for x in args.nc.split(",")], device, args.int8,
                  args.imgsz)
    err = check_equal(model, args.int8)
    print("bitwise equality OK" if args.int8 else f"numeric equality OK (max |diff| {err:.3g})",
          flush=True)
    img = make_input(args.batch, args.imgsz, device)
    tag = "_int8" if args.int8 else ""
    results = {}
    for name, run in ((f"baseline_concat{tag}", time_forward),
                      (f"c2f_sumsplit{tag}", time_split)):
        r = run(model, img, args.iters)
        ms = r["ms"] if r["ms"] is not None else r["host_ms"]
        results[name] = {"ms_per_batch": round(ms, 2), "img_per_s": round(args.batch / ms * 1e3, 1)}
        print(name, results[name], f"convs {r['convs']}, int8 convs {r['int8_convs']}, "
              f"conv nodes {r['conv_nodes']}  [{card}]", flush=True)
    results["card"] = card
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
