"""Folder and image inference entry point of the port, with annotated outputs:

    python -m cerberusdet_tpu_torch.cli.detect --weights w.ckpt.npz --source images/

Counterpart of the JAX package's detect.py (the reference's
cerberusdet/detect.py:117-273): iterate a source file or directory, run every
image through the all-task forward, per-task NMS and cross-task suppression,
draw merged labels, save the annotated images and optional crops. Its flags
and defaults, except that --platform gives way to --device (the card, "cuda",
by default; "cpu" runs on the CPU) and --compile-cache goes (the port
compiles no program ahead; each key's CUDA graph is captured at its first
request). Each image is one batch-1 request at --imgsz square, so one
captured program serves the whole folder. Reference .pt weights need --cfg
and --data.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import cv2
import numpy as np


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True)
    p.add_argument("--cfg", default="")
    p.add_argument("--data", default="", help="data yaml (needed for .pt weights)")
    p.add_argument("--source", required=True, help="image file or directory")
    p.add_argument("--imgsz", "--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--iou-thres-between-tasks", type=float, default=0.8)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--agnostic-nms", action="store_true")
    p.add_argument("--int8", default="off", choices=["off", "deep", "all"],
                   help="int8 PTQ inference (quant/ptq.py); activation "
                        "scales calibrated on the first source images")
    p.add_argument("--save-crop", action="store_true")
    p.add_argument("--nosave", action="store_true",
                   help="do not save annotated images")
    p.add_argument("--view-img", action="store_true",
                   help="show results (needs a display; warns and skips on "
                        "headless hosts)")
    p.add_argument("--hide-labels", action="store_true")
    p.add_argument("--hide-conf", action="store_true")
    p.add_argument("--hide-task", action="store_true")
    p.add_argument("--line-thickness", type=int, default=0,
                   help="box thickness in px; 0 = auto from image size "
                        "(detect.py:253)")
    p.add_argument("--project", default="runs/detect")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--bf16", "--half", action="store_true", dest="bf16",
                   help="compute in bfloat16 (reference --half)")
    p.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    return p.parse_args(argv)


def iter_images(source):
    """Yield (path, BGR image) for a file or directory (dataset_images.py)."""
    exts = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
    src = Path(source)
    files = sorted(src.glob("**/*")) if src.is_dir() else [src]
    for f in files:
        if f.suffix.lower() in exts:
            im = cv2.imread(str(f))
            if im is not None:
                yield f, im


def _calib_batches(opt, n: int = 8):
    """int8 activation-scale calibration on the first `n` source images,
    letterboxed by the host path (the best scales available to a folder
    run)."""
    if opt.int8 == "off":
        return None
    from cerberusdet_tpu_torch.infer import CerberusPreprocessor

    pre = CerberusPreprocessor(img_size=opt.imgsz, stride=32, prefer_device=False,
                               device=opt.device)
    imgs = []
    for _f, im in iter_images(opt.source):
        imgs.append(im)
        if len(imgs) >= n:
            break
    if not imgs:
        return None
    batch, _shapes = pre.preprocess(imgs)
    return [np.asarray(batch)]


def main(argv=None):
    """Run the detection over --source; returns the run directory."""
    from cerberusdet_tpu_torch import resolve_device
    from cerberusdet_tpu_torch.infer import (
        CerberusDetInference,
        CerberusPreprocessor,
        CerberusVisualizer,
    )
    from cerberusdet_tpu_torch.manager.run_manager import increment_path

    opt = parse_opt(argv)
    device = resolve_device(opt.device)
    save_dir = increment_path(Path(opt.project) / opt.name, opt.exist_ok)
    save_dir.mkdir(parents=True, exist_ok=True)

    if opt.weights.endswith(".pt") and not (opt.cfg and opt.data):
        sys.exit(".pt weights carry no architecture metadata — pass both "
                 "--cfg (model yaml) and --data (data yaml)")
    common = dict(conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
                  iou_thres_between_tasks=opt.iou_thres_between_tasks, img_size=opt.imgsz,
                  half=opt.bf16, max_det=opt.max_det, int8=opt.int8,
                  calib_batches=_calib_batches(opt), device=device)
    if opt.weights.endswith(".pt"):
        from cerberusdet_tpu_torch.manager.pt_import import import_pt
        from cerberusdet_tpu_torch.manager.run_manager import parse_data_config
        from cerberusdet_tpu_torch.models.cerberus import CerberusModel

        data_dict = parse_data_config(opt.data)
        model = CerberusModel(opt.cfg, data_dict["task_ids"], data_dict["nc"], device=device)
        import_pt(model.init(0), opt.weights)
        names = dict(zip(data_dict["task_ids"], data_dict["names"]))
        inference = CerberusDetInference(model=model, names=names, **common)
    else:
        inference = CerberusDetInference(weights=opt.weights, **common)

    pre = CerberusPreprocessor(img_size=opt.imgsz, stride=inference.stride, device=device)
    vis = CerberusVisualizer(line_thickness=opt.line_thickness)

    view_img = opt.view_img
    if view_img:
        from cerberusdet_tpu_torch.utils.checks import check_imshow

        if not check_imshow():
            print("--view-img: no display available, skipping show")
            view_img = False

    save_img = not opt.nosave  # detect.py:141
    n = 0
    for path, im0 in iter_images(opt.source):
        batch, shapes = pre.preprocess([im0])
        dets = inference.predict(batch, original_shape=shapes,
                                 agnostic_nms=opt.agnostic_nms)[0]
        if save_img or view_img:
            annotated = vis.draw_detections(
                im0, dets, hide_labels=opt.hide_labels,
                hide_conf=opt.hide_conf, hide_task=opt.hide_task)
            if save_img:
                cv2.imwrite(str(save_dir / path.name), annotated)
            if view_img:
                cv2.imshow(str(path), annotated)
                cv2.waitKey(1)
        if opt.save_crop:
            crop_dir = save_dir / "crops"
            for j, d in enumerate(dets):
                x1, y1, x2, y2 = d["box"]
                crop = im0[max(y1, 0):y2, max(x1, 0):x2]
                if crop.size:
                    cdir = crop_dir / d["label_name"].replace(" ", "_")
                    cdir.mkdir(parents=True, exist_ok=True)
                    cv2.imwrite(str(cdir / f"{path.stem}_{j}.jpg"), crop)
        print(f"{path.name}: {len(dets)} detections")
        n += 1
    print(f"done: {n} images -> {save_dir}")
    return save_dir


if __name__ == "__main__":
    main()
