"""Time the int8 serving kernels at the flagship's conv shapes.

Run from the repository root on a machine with the card:

    python3 -m cerberusdet_tpu_torch.tools.bench_conv_int8 [--batch 1 8] [--kernels conv pack]

It builds 2-task CerberusDet-v8x at 640 px with int8="all" (seeded
random weights, noise calibration) and records the input of every quantized
Conv of one forward per batch size. Kernel times come from the profiler's
CUDA trace (the mean of 10 launches).

- conv: `conv_s8` (bf16 out, SiLU, as the path runs it) at every distinct
  shape with each block tile the kernel has; one line per shape and tile,
  then the forward's conv time summed over its 143 convs for each fixed
  tile, for the wrapper's choice (`conv_tile`) and for the best tile of each
  shape.
- pack: `quant_pack_s8` at every distinct input (shape, layout and dtype as
  the forward hands it over); one line per input with its launches a
  forward, bytes (the input read once, the NHWC int8 output written once),
  GB/s and the share of its bytes bound at 3.35 TB/s, then the sums over
  the forward.

The last line gives the card's name and power limit.
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def kernel_ms(fn, name: str, iters: int = 10) -> float:
    """Mean device time of the kernel whose name holds `name` per fn() call,
    from the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    return sum(e.device_time_total for e in hits) / 1e3 / max(sum(e.count for e in hits), 1)


def bench_pack(bs: int, inputs, card: str) -> None:
    """quant_pack_s8 at each distinct input of a forward: {key: (launches,
    (x, s_x, ci16))}."""
    total_ms = total_bound = 0.0
    for key in sorted(inputs, key=str):
        n, (x, s_x, ci16) = inputs[key]
        ms = kernel_ms(lambda: conv_int8_cuda.quant_pack_s8(x, s_x, ci16), "quant_pack")
        nbytes = x.numel() * x.element_size() + x.numel() // x.shape[1] * ci16
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        total_ms += n * ms
        total_bound += n * bound
        layout = "NCHW planes" if (x.stride(3) if x.shape[3] > 1 else x.stride(2)) == 1 \
            else "channels-last"
        print(f"batch {bs} quant_pack_s8 {tuple(x.shape)} {str(x.dtype).split('.')[-1]} "
              f"{layout}{'' if x.is_contiguous() else ' view'} -> Ci16 {ci16} (x{n}): "
              f"{ms:.4f} ms, {nbytes / 1e6:.3f} MB, {nbytes / ms / 1e6:.1f} GB/s, bound "
              f"{bound:.4f} ms ({100 * bound / ms:.1f}%)", flush=True)
    print(f"batch {bs} forward, quant_pack_s8 summed over its launches: {total_ms:.3f} ms, "
          f"bound {total_bound:.3f} ms ({100 * total_bound / total_ms:.1f}%)  [{card}]",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--kernels", nargs="+", choices=("conv", "pack"), default=["conv", "pack"])
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
        shapes, packs = {}, {}

        def capture(mod, a):
            x = a[0]
            key = (mod.c1, mod.c2, mod.k[0], mod.s[0], x.shape[2], x.shape[3])
            n, _ = shapes.get(key, (0, None))
            shapes[key] = (n + 1, (mod, x))
            key = (tuple(x.shape), x.stride(), x.dtype, mod.w_q.shape[3])
            n, _ = packs.get(key, (0, None))
            packs[key] = (n + 1, (x, mod.s_x, mod.w_q.shape[3]))

        hooks = [m.register_forward_pre_hook(capture) for _, m in conv_layers(inf.model)]
        # an NHWC batch seen as NCHW, as predict hands the model its input
        x = torch.rand((bs, 640, 640, 3), generator=torch.Generator().manual_seed(bs)).to(
            dev, torch.bfloat16).permute(0, 3, 1, 2)
        inf.model(x)
        for h in hooks:
            h.remove()
        if "pack" in args.kernels:
            bench_pack(bs, packs, card)
        if "conv" not in args.kernels:
            continue
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
                times[tile] = kernel_ms(lambda: conv_int8_cuda.conv_s8(*call, tile=tile),
                                        "conv_s8_kernel")
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
