"""End-to-end int8 PTQ inference measurement.

The port's counterpart of cerberusdet_tpu/tools/bench_int8.py: the full
2-task v8x forward at 640 px, batch 32, in three variants — bf16, int8
"deep" (the Convs with at least --min-cin input channels quantized) and int8
"all" — each with the headline's method (cerberusdet_tpu_torch/bench.py:
a captured forward replayed as dependent iterations between CUDA events,
best of 3, and the conv-node guard). Activation scales calibrate on the
first 4 images of the timed batch, as the JAX tool's do. Prints one line a
variant, then ONE JSON object {variant: {"ms_per_batch", "img_per_s",
"speedup_vs_bf16"}}.

Usage: python -m cerberusdet_tpu_torch.tools.bench_int8 [--iters 20] [--batch 32]
       [--only bf16|deep|all] [--device cpu --imgsz 64 --cfg ...]
"""

from __future__ import annotations

import argparse
import copy
import json

import torch

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.bench import make_input, time_forward
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.quant import (
    calibrate_amax,
    fused_conv_weights,
    quantize_params,
    select_all,
    select_deep,
)
from cerberusdet_tpu_torch.utils.profiling import device_label


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--min-cin", type=int, default=256)
    ap.add_argument("--only", default=None, choices=["bf16", "deep", "all"],
                    help="run a single variant")
    ap.add_argument("--cfg", default="configs/models/yolov8x_2task.yaml")
    ap.add_argument("--nc", default="20,19", help="per-task class counts")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ncs = [int(x) for x in args.nc.split(",")]
    img = make_input(args.batch, args.imgsz, device)
    keys = {"bf16": "bf16", "deep": f"int8_deep(cin>={args.min_cin})", "all": "int8_all"}
    chosen = [args.only] if args.only else list(keys)
    with torch.no_grad():
        fused = CerberusModel(args.cfg, [f"t{i}" for i in range(len(ncs))], ncs,
                              device=device).init(0).fuse().eval()
        weights = fused_conv_weights(fused)  # float32: what the int8 weights come from
        fused.to(torch.bfloat16)
        # in bf16, as the JAX tool calibrates (calibrate_amax's default there)
        amax = calibrate_amax(fused, [img[:4]])
        results = {}
        for v in chosen:
            model = copy.deepcopy(fused)
            if v != "bf16":
                quantize_params(model, amax, weights=weights,
                                select=select_all if v == "all" else select_deep(args.min_cin))
            r = time_forward(model, img, args.iters)
            del model
            ms = r["ms"] if r["ms"] is not None else r["host_ms"]
            results[keys[v]] = {"ms_per_batch": round(ms, 2),
                                "img_per_s": round(args.batch / ms * 1e3, 1)}
            print(keys[v], results[keys[v]], f"int8 convs {r['int8_convs']}, conv nodes "
                  f"{r['conv_nodes']}  [{device_label(device)}]", flush=True)
    base = results.get("bf16", {}).get("img_per_s")
    if base:
        for r in results.values():
            r["speedup_vs_bf16"] = round(r["img_per_s"] / base, 3)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
