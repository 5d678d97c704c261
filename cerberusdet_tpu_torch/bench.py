"""Headline benchmark: batched 2-task CerberusDet-v8x inference at 640 px.

The port's counterpart of the repository's bench.py (the JAX package's
headline), with its metric names and flags:

    python -m cerberusdet_tpu_torch.bench                # int8 PTQ, batch 128
    python -m cerberusdet_tpu_torch.bench --bf16         # pure bf16
    python -m cerberusdet_tpu_torch.bench --batch 32 --cfg configs/models/yolov8x_2task_tpu.yaml

The last line printed is ONE JSON object {"metric", "value", "unit",
"vs_baseline"}: 2task_inference_throughput_640_int8ptq (or
2task_inference_throughput_640 with --bf16) in img/s, against the
reference's published 2-task speed, 7.2 ms an image on a V100 at batch 32
in fp16 (138.9 img/s). The line before it gives the card's name and power
limit, the ms a forward, the batch, the graph's conv nodes and the graph
pool's MiB.

Model: the seeded flagship (CerberusModel.init(0), tasks voc/animals, nc
20/19), BatchNorm folded. int8: every Conv quantized (select_all) from its
fused float32 weights, with activation scales calibrated in float64 on the
repository's calibration images (assets/calib/*.jpg, resized to the square
input as the JAX bench resizes them), so that the scales do not depend on
the device; they are held at rtol 0.05 against the port's own golden,
cerberusdet_tpu_torch/assets/amax_golden.json. The JAX golden
(assets/calib/amax_golden.json) comes from jax.random.PRNGKey(0), which the
port cannot draw; nothing here writes it. `--write-golden` records this
configuration's scales in the port's golden and exits. The model then runs
in bfloat16 (the int8 Convs keep their int8 weights and float32 scales).

Method (utils/profiling.py:HonestLoop): the all-heads forward on a seeded
uniform (B, 640, 640, 3) batch is captured once as a CUDA graph; each replay
feeds the next through its input (x += 0 * the float32 mean of every output
of every task); K replays are timed between CUDA events, best of 3 rounds,
with the host clock of the same rounds beside. Guard: the graph holds a conv
kernel node for every convolution of the all-heads forward, and exactly one
conv_s8 and one quant_pack_s8 node per int8 Conv. Runs on the card; with
`--device cpu` (tests, small sizes) the loop runs eagerly and the kernel
wrappers take their plain versions.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.ops.conv_int8_cuda import conv_s8, quant_pack_s8
from cerberusdet_tpu_torch.quant import (
    calibrate_amax,
    fused_conv_weights,
    quantize_params,
    select_all,
)
from cerberusdet_tpu_torch.utils.profiling import device_label, honest_time, model_convs

GOLDEN = Path(__file__).parent / "assets" / "amax_golden.json"
CALIB_DIR = Path(__file__).resolve().parent.parent / "assets" / "calib"
TASKS, NCS = ["voc", "animals"], [20, 19]
BASELINE_IMGS_PER_S = 1000.0 / 7.2  # reference: 7.2 ms/img, V100 b32 fp16
INT8_KERNELS = (quant_pack_s8, conv_s8)


def calib_batches(imgsz: int = 640):
    """The committed calibration images (assets/calib/*.jpg): cv2 read, BGR
    -> RGB, a plain resize to imgsz x imgsz (INTER_LINEAR), / 255, float32,
    stacked into one batch (the JAX bench.py's calib_batches)."""
    import cv2

    imgs = []
    for p in sorted(CALIB_DIR.glob("*.jpg")):
        im = cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB)
        im = cv2.resize(im, (imgsz, imgsz), interpolation=cv2.INTER_LINEAR)
        imgs.append(im.astype(np.float32) / 255.0)
    if not imgs:
        raise FileNotFoundError(f"no calibration images in {CALIB_DIR}")
    return [np.stack(imgs)]


def golden_key(cfg: str, imgsz: int) -> str:
    """The golden's key: the config's stem, with @imgsz when it is not 640."""
    stem = Path(cfg).stem
    return stem if imgsz == 640 else f"{stem}@{imgsz}"


def check_golden_amax(amax: Dict, key: str, write: bool, path: Optional[Path] = None) -> None:
    """Hold calibrated activation scales against the golden set at `path`
    (GOLDEN when None) under `key` (rtol 0.05, the same key set), as the JAX
    bench.py does; with `write`, or where the file or the key is missing,
    record them instead."""
    path = GOLDEN if path is None else path
    flat = {"/".join(map(str, k)): v for k, v in amax.items()}
    data = json.loads(path.read_text()) if path.exists() else {}
    if write or key not in data:
        data[key] = flat
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(data, indent=0, sort_keys=True))
        print(f"[bench] recorded {len(flat)} activation scales for {key} in {path}", flush=True)
        return
    gold = data[key]
    if set(gold) != set(flat):
        raise AssertionError(f"amax key set drifted vs golden {key}: "
                             f"{sorted(set(gold) ^ set(flat))}")
    bad = {k: (gold[k], flat[k]) for k in gold
           if abs(flat[k] - gold[k]) > 0.05 * max(abs(gold[k]), 1e-6)}
    if bad:
        raise AssertionError(f"calibrated amax drifted >5% vs committed golden {key}: {bad}")


@torch.no_grad()
def build(cfg: str, device, int8: bool, imgsz: int = 640, write_golden: bool = False,
          golden: Optional[Path] = None) -> CerberusModel:
    """The benchmark's model on `device`: seeded, fused in float64, for int8
    calibrated in float64 on the calibration images, checked against the
    golden and quantized from its fused float32 weights; then cast to
    bfloat16 (the int8 Convs' scales stay float32)."""
    model = CerberusModel(cfg, TASKS, NCS, device=device).init(0)
    model = model.to(torch.float64).fuse().eval()
    if int8:
        fused = fused_conv_weights(model)
        amax = calibrate_amax(model, calib_batches(imgsz))
        check_golden_amax(amax, golden_key(cfg, imgsz), write_golden, golden)
        quantize_params(model, amax, select=select_all, weights=fused)
    return model.to(torch.bfloat16)


def make_input(batch: int, imgsz: int, device) -> torch.Tensor:
    """The seeded uniform (B, imgsz, imgsz, 3) float32 batch in [0, 1),
    drawn on the CPU (the same on every device) and moved."""
    gen = torch.Generator().manual_seed(1)
    return torch.rand((batch, imgsz, imgsz, 3), generator=gen).to(device)


def forward_fn(model: CerberusModel):
    """The all-heads forward: NHWC float32 in, {task: predictions} out."""

    def forward(img: torch.Tensor):
        out = model(img.permute(0, 3, 1, 2).to(torch.bfloat16))
        return {t: pred for t, (pred, _f) in out.items()}

    return forward


@torch.no_grad()
def time_forward(model: CerberusModel, img: torch.Tensor, iters: int) -> Dict:
    """utils/profiling.py:honest_time over forward_fn(model) on img. Returns
    its {"ms" (device, None on the CPU), "host_ms", "conv_nodes",
    "pool_mib"} and the forward's "convs" and "int8_convs"."""
    n_convs, n_int8 = model_convs(model)
    r = honest_time(forward_fn(model), img, iters, n_convs, n_int8, INT8_KERNELS, "bench")
    return {**r, "convs": n_convs, "int8_convs": n_int8}


def parse_opt(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true", help="pure bf16 (no int8 PTQ) for comparison")
    ap.add_argument("--batch", type=int, default=128, help="serving batch size")
    ap.add_argument("--cfg", default="configs/models/yolov8x_2task.yaml",
                    help="model yaml (reference widths by default; yolov8x_2task_tpu.yaml is "
                         "the JAX package's lane-aligned variant)")
    ap.add_argument("--write-golden", action="store_true",
                    help="record this cfg's activation scales in the port's golden and exit")
    ap.add_argument("--iters", type=int, default=20, help="replays a timed round")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Optional[Dict]:
    """Run the benchmark; returns the printed JSON's fields and the
    measurement behind them (None after --write-golden)."""
    opt = parse_opt(argv)
    device = resolve_device(opt.device)
    model = build(opt.cfg, device, not opt.bf16, opt.imgsz, opt.write_golden)
    if opt.write_golden:
        return None
    r = time_forward(model, make_input(opt.batch, opt.imgsz, device), opt.iters)
    ms = r["ms"] if r["ms"] is not None else r["host_ms"]
    imgs_per_s = opt.batch / (ms / 1e3)
    metric = ("2task_inference_throughput_640" if opt.bf16
              else "2task_inference_throughput_640_int8ptq")
    nodes = r["conv_nodes"]
    graph = ("no graph on the CPU" if nodes is None else
             f"graph: {nodes['kernels']} kernel nodes, {nodes['convs']} conv nodes "
             f"({nodes['conv_s8']} conv_s8, {nodes['cudnn']} cuDNN), {nodes['quant_pack_s8']} "
             f"quant_pack_s8; pool {r['pool_mib']:.0f} MiB")
    dev_ms = "" if r["ms"] is None else f"{r['ms']:.3f} ms a forward (CUDA events), "
    print(f"[bench] {device_label(device)} | {Path(opt.cfg).stem} "
          f"{'bf16' if opt.bf16 else 'int8 all'} batch {opt.batch} at {opt.imgsz} px: "
          f"{dev_ms}host {r['host_ms']:.3f} ms, best of 3 rounds of {opt.iters}; "
          f"{r['convs']} convolutions ({r['int8_convs']} int8); {graph}", flush=True)
    result = {"metric": metric, "value": round(imgs_per_s, 1), "unit": "img/s/chip",
              "vs_baseline": round(imgs_per_s / BASELINE_IMGS_PER_S, 2)}
    print(json.dumps(result), flush=True)
    return {**result, **r, "batch": opt.batch}


if __name__ == "__main__":
    main()
