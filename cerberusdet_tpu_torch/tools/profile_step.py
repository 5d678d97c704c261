"""Trace the multi-task train step (or the inference forward) with torch.profiler.

The port's counterpart of cerberusdet_tpu/tools/profile_step.py. One
untraced call first (the kernels' build, cuDNN's choices, the allocator),
then --iters steps or forwards under the profiler, written as a Chrome
trace, <out>/<host>_<pid>.pt.trace.json.gz (utils/profiling.py:trace):

    python -m cerberusdet_tpu_torch.tools.profile_step --out DIR \
        [--mode train|infer] [--cfg configs/models/yolov8x_2task.yaml]
        [--imgsz 640] [--batch 8] [--iters 5] [--max-labels 60] [--bf16]
        [--int8 off|deep|all]
    python -m cerberusdet_tpu_torch.tools.summarize_trace DIR --iters 5

infer mode runs the fused seeded model in bf16, int8 calibrated on a
seeded uniform batch (timing-faithful, accuracy-irrelevant) and propagated
(quant/ptq.py:propagate_act_quant, as the JAX tool), eagerly: the
trace shows each kernel of the forward by name. train mode runs
MultiTaskTrainer.step (float32, or bf16 compute with --bf16) on seeded
batches with every gt row valid: on the card the untraced call captures the
step's CUDA graph and the traced calls replay it, as the JAX tool traces its
jitted step (the trace holds the kernels of each replay by name); on the
CPU the step runs eagerly.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="trace output directory")
    p.add_argument("--mode", default="train", choices=["train", "infer"])
    p.add_argument("--cfg", default="configs/models/yolov8x_2task.yaml")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--max-labels", type=int, default=60)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 train step (infer mode is always bf16)")
    p.add_argument("--int8", default="off", choices=["off", "deep", "all"],
                   help="infer mode only: trace the int8-PTQ forward")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from cerberusdet_tpu_torch import resolve_device
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.utils.profiling import trace

    device = resolve_device(args.device)
    tasks, ncs = ["a", "b"], [20, 19]
    model = CerberusModel(args.cfg, tasks, ncs, device=device).init(0)

    if args.mode == "infer":
        from cerberusdet_tpu_torch.quant import (
            calibrate_amax,
            fused_conv_weights,
            quantize_params,
            select_all,
            select_deep,
        )

        with torch.no_grad():
            model.fuse().eval()
            weights = fused_conv_weights(model)  # float32, before the cast
            model.to(torch.bfloat16)
            if args.int8 != "off":
                cal = [np.random.default_rng(0).uniform(
                    0, 1, (2, args.imgsz, args.imgsz, 3)).astype(np.float32)]
                amax = calibrate_amax(model, cal)
                quantize_params(model, amax, weights=weights, propagate=True,
                                select=select_all if args.int8 == "all" else select_deep())
        img = torch.zeros((args.batch, args.imgsz, args.imgsz, 3), device=device)

        @torch.no_grad()
        def fn():
            out = model(img.permute(0, 3, 1, 2).to(torch.bfloat16))
            return {t: pred for t, (pred, _f) in out.items()}
    else:
        from cerberusdet_tpu_torch.train.loss import DetectionLoss
        from cerberusdet_tpu_torch.train.step import MultiTaskTrainer, init_train_state

        losses = {t: DetectionLoss(nc=nc, strides=model.strides) for t, nc in zip(tasks, ncs)}
        trainer = MultiTaskTrainer(
            model, losses, compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
            device=device)
        state = init_train_state(model)

        def batch(nc, seed):
            r = np.random.default_rng(seed)
            b, m = args.batch, args.max_labels
            return {k: torch.as_tensor(v, device=device) for k, v in {
                "img": r.uniform(0, 1, (b, args.imgsz, args.imgsz, 3)).astype(np.float32),
                "cls": r.integers(0, nc, (b, m)).astype(np.int32),
                "bboxes": r.uniform(0.2, 0.6, (b, m, 4)).astype(np.float32),
                "mask": np.ones((b, m), bool),
                "prob": np.ones((b, m), np.float32),
            }.items()}

        batches = {t: batch(nc, i + 1) for i, (t, nc) in enumerate(zip(tasks, ncs))}
        lrs = np.full((3,), 0.01, np.float32)

        def fn():
            return trainer.step(state, batches, lrs, 0.937)[1]

    _, path = trace(args.out, fn, iters=args.iters)
    print(f"trace written to {path}")
    return str(path)


if __name__ == "__main__":
    main()
