"""Time the int8 conv kernel's block tiles at the flagship's conv shapes.

Run from the repository root on a machine with the card:

    python3 -m cerberusdet_tpu_torch.tools.bench_conv_int8 [--batch 1 8]

It builds 2-task CerberusDet-v8x at 640 px with int8="all" (seeded
random weights, noise calibration), records the input of every quantized
Conv of one forward per batch size, and times `conv_s8` (bf16 out, SiLU, as
the path runs it) at every distinct shape with each block tile the kernel
has, by the profiler's CUDA trace (the mean of 10 launches). Prints one line
per shape and tile, then the forward's conv time summed over its 143 convs
for each fixed tile, for the wrapper's choice (`conv_tile`) and for the best
tile of each shape, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from cerberusdet_tpu_torch.infer import CerberusDetInference
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.ops import conv_int8_cuda
from cerberusdet_tpu_torch.ops.conv_int8_cuda import TILES
from cerberusdet_tpu_torch.quant import conv_layers

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP = os.path.join(ROOT, "configs", "models", "yolov8x_2task.yaml")
INT8_OPS_PER_S = 1979e12  # H100 SXM, dense int8 tensor cores


def kernel_ms(fn, iters: int = 10) -> float:
    """Mean device time of the conv kernel per fn() call, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if "conv_s8_kernel" in e.key]
    return sum(e.device_time_total for e in hits) / 1e3 / max(sum(e.count for e in hits), 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_conv_int8: no CUDA device")
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    names = {"voc": [f"v{i}" for i in range(20)], "animals": [f"a{i}" for i in range(19)]}
    model = CerberusModel(FLAGSHIP, ["voc", "animals"], [20, 19], device=dev).init(seed=0)
    inf = CerberusDetInference(model=model, names=names, img_size=640, dtype=torch.bfloat16,
                               device=dev, int8="all")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for bs in args.batch:
        shapes = {}

        def capture(mod, a):
            x = a[0]
            key = (mod.c1, mod.c2, mod.k[0], mod.s[0], x.shape[2], x.shape[3])
            n, _ = shapes.get(key, (0, None))
            shapes[key] = (n + 1, (mod, x))

        hooks = [m.register_forward_pre_hook(capture) for _, m in conv_layers(inf.model)]
        x = torch.rand((bs, 3, 640, 640), generator=torch.Generator().manual_seed(bs)).to(
            dev, torch.bfloat16)
        inf.model(x)
        for h in hooks:
            h.remove()
        total = {t: 0.0 for t in TILES}
        chosen = best = macs = 0.0
        for key in sorted(shapes):
            n, (mod, xin) = shapes[key]
            ci, co, k, s = key[:4]
            xq = conv_int8_cuda.quant_pack_s8(xin, mod.s_x, mod.w_q.shape[3])
            call = (xq, mod.w_q, mod.s_x, mod.s_w, mod.b, s, k // 2, True, torch.bfloat16)
            m = xq.shape[0] * ((xq.shape[1] + 2 * (k // 2) - k) // s + 1) \
                * ((xq.shape[2] + 2 * (k // 2) - k) // s + 1)
            times = {}
            for tile in TILES:
                times[tile] = kernel_ms(lambda: conv_int8_cuda.conv_s8(*call, tile=tile))
                total[tile] += n * times[tile]
            pick = conv_int8_cuda.conv_tile(m, co, sms)
            chosen += n * times[pick]
            best += n * min(times.values())
            mac = m * co * ci * k * k
            macs += n * mac
            print(f"batch {bs} {k}x{k} s{s} {ci}->{co} at {key[4]}x{key[5]} (x{n}), M {m}, bound "
                  f"{2 * mac / INT8_OPS_PER_S * 1e3:.4f} ms: "
                  + ", ".join(f"{t[0]}x{t[1]} {v:.4f}" for t, v in times.items())
                  + f" ms; conv_tile picks {pick[0]}x{pick[1]}", flush=True)
        print(f"batch {bs} forward, {macs / 1e12:.4f} TMAC (bound "
              f"{2 * macs / INT8_OPS_PER_S * 1e3:.3f} ms), conv_s8 summed: "
              + ", ".join(f"all {t[0]}x{t[1]} {v:.3f}" for t, v in total.items())
              + f", conv_tile's choice {chosen:.3f}, best a shape {best:.3f} ms  [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
