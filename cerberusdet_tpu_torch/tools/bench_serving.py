"""Staged measurement of the serving program: forward -> + per-task NMS ->
full (+ global remap + cross-task suppression).

The port's counterpart of cerberusdet_tpu/tools/bench_serving.py. The full
stage is CerberusDetInference.predict_device, the device part that
`predict` captures as one CUDA graph per key; the stage deltas attribute the
post-forward cost that cli/detect.py and cli/serve.py pay on every batch.
Each stage is captured and timed with the headline's method
(utils/profiling.py:HonestLoop: dependent replays between CUDA events, best
of 3, every output consumed, the conv-node guard). The model is the seeded
flagship, int8 "all" by default, calibrated on noise at 64 px as the JAX
tool's CerberusDetInference(img_size=64) is; the timed batch is a seeded
uniform (32, 640, 640, 3).

Usage:
  python -m cerberusdet_tpu_torch.tools.bench_serving [--int8 all] [--iters 10]
  python -m cerberusdet_tpu_torch.tools.bench_serving --trace DIR
Prints one line a stage, then ONE JSON object {stage: {"ms_per_batch",
"img_per_s", "delta_ms"}}; --trace writes a torch.profiler trace of the
full program's replays to DIR instead (tools/summarize_trace.py reads it).
"""

from __future__ import annotations

import argparse
import json

import torch

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.bench import make_input
from cerberusdet_tpu_torch.infer.inference import SERVING_KERNELS, CerberusDetInference
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.ops.nms import non_max_suppression
from cerberusdet_tpu_torch.utils.profiling import (
    HonestLoop,
    device_label,
    honest_time,
    model_convs,
    trace,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--cfg", default="configs/models/yolov8x_2task.yaml")
    ap.add_argument("--nc", default="20,19")
    ap.add_argument("--int8", default="all", choices=["off", "deep", "all"])
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--iou", type=float, default=0.45)
    ap.add_argument("--iou-bt", type=float, default=0.8)
    ap.add_argument("--max-det", type=int, default=300)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", default="",
                    help="write a torch.profiler trace of the FULL program to this dir "
                         "instead of the staged timing")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ncs = [int(x) for x in args.nc.split(",")]
    tasks = [f"t{i}" for i in range(len(ncs))]
    model = CerberusModel(args.cfg, tasks, ncs, device=device).init(0)
    names = {t: [f"c{i}" for i in range(nc)] for t, nc in zip(tasks, ncs)}
    inst = CerberusDetInference(model=model, names=names, conf_thres=args.conf,
                                iou_thres=args.iou, iou_thres_between_tasks=args.iou_bt,
                                img_size=64, max_det=args.max_det, int8=args.int8,
                                device=device)
    img = make_input(args.batch, args.imgsz, device)
    n_convs, n_int8 = model_convs(inst.model)

    def full(x):
        return inst.predict_device(x, args.conf, args.iou, args.iou_bt, False, args.max_det)

    def forward_only(x):
        out = inst.model(x.permute(0, 3, 1, 2).to(inst.dtype))
        return {t: pred for t, (pred, _f) in out.items()}

    def with_nms(x):
        out = inst.model(x.permute(0, 3, 1, 2).to(inst.dtype))
        return [non_max_suppression(out[t][0], nc=nc, conf_thres=args.conf,
                                    iou_thres=args.iou, agnostic=False,
                                    max_det=args.max_det)[0]
                for t, nc in zip(tasks, ncs)]

    with torch.no_grad():
        if args.trace:
            with HonestLoop(full, img, counted=SERVING_KERNELS) as loop:
                _, path = trace(args.trace, loop.step, iters=max(3, args.iters // 3))
            print(f"trace written to {path}")
            return str(path)

        stages = {"forward": forward_only, "forward+nms": with_nms, "full": full}
        results, prev = {}, None
        for name, fn in stages.items():
            r = honest_time(fn, img, args.iters, n_convs, n_int8, SERVING_KERNELS,
                            "bench_serving")
            host_ms = r["host_ms"]
            ms = host_ms if r["ms"] is None else r["ms"]
            results[name] = {"ms_per_batch": round(ms, 2),
                             "img_per_s": round(args.batch / ms * 1e3, 1)}
            if prev is not None:
                results[name]["delta_ms"] = round(ms - results[prev]["ms_per_batch"], 2)
            prev = name
            print(name, results[name], f"host {host_ms:.3f} ms  [{device_label(device)}]",
                  flush=True)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
