"""Standalone evaluation entry point of the port, with the `--task speed`
benchmark mode:

    python -m cerberusdet_tpu_torch.cli.val --weights w.ckpt.npz --data data.yaml

Counterpart of the JAX package's val.py (the reference's
cerberusdet/val.py:436-495), with its flags and defaults, except that
--platform / --compile-cache give way to --device (the card, "cuda", by
default; "cpu" runs on the CPU). The reference protocol: rect batches with
pad 0.5, conf 0.001, IoU 0.6, multi-label NMS, max_det 300, the model fused.
Float32 (the default) is float32 arithmetic on the card: cuDNN's TF32 is
switched off for the run; --bf16 computes in bfloat16. Reference .pt weights
need --cfg (the model yaml; the task ids and class counts come from --data):

    python -m cerberusdet_tpu_torch.cli.val --weights w.pt --cfg model.yaml --data data.yaml

The run directory (--project / --name) receives the first batches' label
and prediction mosaics and each task's PR curve and confusion matrix
(utils/plots.py; the figures where matplotlib is installed); --mlflow-url
uploads each task's metrics and per-class AP50 (utils/mlflow_logging.py).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from cerberusdet_tpu_torch import resolve_device


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True,
                   help="a .ckpt.npz written by either package, or a reference .pt (with --cfg)")
    p.add_argument("--data", required=True)
    p.add_argument("--cfg", default="", help="model yaml (overrides the checkpoint's)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--imgsz", "--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--task", default="val", choices=["train", "val", "test", "speed"])
    p.add_argument("--no-rect", action="store_true",
                   help="disable rect (aspect-grouped) batching; the reference "
                        "evaluates with rect=True pad=0.5 (val.py:231-246)")
    p.add_argument("--bf16", "--half", action="store_true", dest="bf16",
                   help="compute in bfloat16 (reference --half)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--single-cls", action="store_true",
                   help="treat as single-class dataset (val.py:285,318,339)")
    p.add_argument("--labels-from-xml", action="store_true")
    p.add_argument("--use-multi-labels", action="store_true")
    p.add_argument("--use-soft-labels", action="store_true")
    p.add_argument("--workers", type=int, default=None,
                   help="dataloader decode threads (reference --workers)")
    p.add_argument("--project", default="runs/val")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--mlflow-url", default="",
                   help="MLflow tracking server for the metrics (a no-op without mlflow)")
    p.add_argument("--experiment-name", default="cerberusdet")
    p.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    p.add_argument("--int8", default="off", choices=["off", "deep", "all"],
                   help="post-training int8 quantization of the fused convs "
                        "(deep: c_in>=256 only); activation scales are "
                        "calibrated on the first val batches (quant/ptq.py)")
    return p.parse_args(argv)


def load_model_for_eval(weights: str, cfg: str, device, data_dict=None):
    """The port's CerberusModel from a .ckpt.npz (its `ema` when it holds
    one) or from a reference .pt (which needs `cfg`, and `data_dict` for the
    task ids and class counts), fused like the reference's
    attempt_load(.fuse()), in eval mode, in float32 on `device`
    (manager/attempt_load.py:load_single)."""
    from cerberusdet_tpu_torch.manager.attempt_load import load_single

    task_ids, nc = None, None
    if weights.endswith(".pt"):
        if not cfg:
            raise SystemExit("--cfg required with .pt weights")
        task_ids, nc = data_dict["task_ids"], data_dict["nc"]
    return load_single(weights, cfg or None, task_ids, nc, fuse=True, device=device)[0].eval()


@torch.no_grad()
def speed_benchmark(model, imgsz: int, batch: int, dtype, iters: int = 20):
    """All-task forward timing (val.py:219,297-308 semantics): host clock
    around `iters` forwards of zeros that end in a synchronise, after one
    warm-up forward."""
    device = next(model.parameters()).device
    x = torch.zeros((batch, 3, imgsz, imgsz), dtype=dtype, device=device)
    model.eval()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    model(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        model(x)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return {"ms_per_image": dt / batch * 1e3, "images_per_sec": batch / dt}


def quantize_for_eval(model, data_dict, opt, dtype, weights, n_calib_batches: int = 2):
    """PTQ of the fused model in place, with activation scales calibrated in
    `dtype` on the first val batches of task 0 (square batches of at most 8,
    quant/ptq.py) and weights quantized from `weights`, the fused float32
    weights taken before the cast (quant/ptq.py:fused_conv_weights), then
    annotated so that int8 crosses the blocks (propagate_act_quant, as the
    JAX package's val.py passes model=)."""
    from cerberusdet_tpu_torch.data.loaders import create_dataloader
    from cerberusdet_tpu_torch.quant import calibrate_amax, quantize_params, select_all
    from cerberusdet_tpu_torch.quant.ptq import select_deep

    _, loader = create_dataloader(
        data_dict["val"][0], imgsz=opt.imgsz, batch_size=min(opt.batch_size, 8),
        augment=False, classnames=data_dict["names"][0],
        task="int8_calib", num_threads=opt.workers, host_sharded=False)
    batches = []
    for batch in loader:
        batches.append(batch["img"].astype("float32") / 255.0)
        if len(batches) >= n_calib_batches:
            break
    amax = calibrate_amax(model, batches, dtype=dtype)
    select = select_all if opt.int8 == "all" else select_deep()
    return quantize_params(model, amax, select=select, weights=weights, propagate=True)


def main(argv=None):
    from cerberusdet_tpu_torch.data.loaders import create_dataloader
    from cerberusdet_tpu_torch.evaluation.val import eval_flags, run_task, save_val_plots
    from cerberusdet_tpu_torch.manager.run_manager import increment_path, parse_data_config
    from cerberusdet_tpu_torch.quant.ptq import fused_conv_weights

    opt = parse_opt(argv)
    device = resolve_device(opt.device)
    data_dict = parse_data_config(opt.data, check=True)
    model = load_model_for_eval(opt.weights, opt.cfg, device, data_dict)
    save_dir = increment_path(Path(opt.project) / opt.name, opt.exist_ok)
    save_dir.mkdir(parents=True, exist_ok=True)

    dtype = torch.bfloat16 if opt.bf16 else torch.float32
    fused = fused_conv_weights(model) if opt.int8 != "off" else None
    model.to(dtype)
    with eval_flags():
        if opt.int8 != "off":
            quantize_for_eval(model, data_dict, opt, dtype, fused)
            del fused
        if opt.task == "speed":
            out = speed_benchmark(model, opt.imgsz, opt.batch_size, dtype)
            print(json.dumps(out))
            return out

        results = {}
        for ti, task in enumerate(data_dict["task_ids"]):
            # the requested split, falling back to val when the key is missing
            # or a null placeholder like `test:` (reference val.py:226)
            split = opt.task if opt.task in ("train", "val", "test") else "val"
            paths = data_dict.get(split) or data_dict["val"]
            path = paths[ti] if paths[ti] is not None else data_dict["val"][ti]
            # the reference's standalone-val protocol: rect=True, pad=0.5
            # (cerberusdet/val.py:231-246), one letterbox shape per batch
            _, loader = create_dataloader(
                path, imgsz=opt.imgsz, batch_size=opt.batch_size, augment=False,
                rect=not opt.no_rect, pad=0.5,
                classnames=data_dict["names"][ti], task=f"{task}_val",
                use_xml=opt.labels_from_xml, multi_label=opt.use_multi_labels,
                soft_label=opt.use_soft_labels, single_cls=opt.single_cls,
                num_threads=opt.workers)
            out = run_task(
                model, task, loader, nc=data_dict["nc"][ti], names=data_dict["names"][ti],
                conf_thres=opt.conf_thres, iou_thres=opt.iou_thres, max_det=opt.max_det,
                verbose=True, single_cls=opt.single_cls,
                use_multi_labels=opt.use_multi_labels, plots=True, plots_dir=save_dir)
            results[task] = out
            mp, mr, map50, mAP = out["results"][:4]
            print(f"{task}: P={mp:.4f} R={mr:.4f} mAP50={map50:.4f} mAP={mAP:.4f}")
            names = ["item"] if opt.single_cls else list(data_dict["names"][ti])
            save_val_plots(out, names, save_dir, task)
    if opt.mlflow_url:
        log_to_mlflow(results, data_dict, opt)
    return results


def log_to_mlflow(results, data_dict, opt) -> None:
    """The metric upload (reference val.py:384-418): per task P, R, mAP50,
    mAP and fitness, and each class's AP50, in one run named val_<name>."""
    from cerberusdet_tpu_torch.utils.mlflow_logging import MLFlowLogger

    logger = MLFlowLogger(opt.experiment_name, f"val_{opt.name}", tracking_uri=opt.mlflow_url)
    for task, out in results.items():
        mp, mr, map50, mAP = out["results"][:4]
        metrics = {
            f"val/{task}/precision": mp, f"val/{task}/recall": mr,
            f"val/{task}/mAP_0.5": map50, f"val/{task}/mAP_0.5_0.95": mAP,
            f"val/{task}/fitness": out["fitness"],
        }
        m = out["metrics"]
        # under --single-cls the metrics are over one merged class
        names = (["item"] if opt.single_cls
                 else data_dict["names"][data_dict["task_ids"].index(task)])
        for i, c in enumerate(m.ap_class_index):
            metrics[f"val/{task}/ap50_{names[int(c)]}".replace(" ", "_")] = float(
                m.class_result(i)[2])
        logger.log_metrics(metrics)
    logger.finish()


if __name__ == "__main__":
    main()
