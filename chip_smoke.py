"""Drive the PyTorch/CUDA port (cerberusdet_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, each of which fails the run on anything wrong:
  1. build every kernel of the serving path from the sources in the checkout;
  2. hold each kernel against its plain PyTorch version on the card
     (identical NMS selections), and time both;
  3. serve the flagship program, 2-task CerberusDet-v8x (voc/animals,
     nc 20/19) at 640 px in bfloat16 with seeded random weights, through
     CerberusPreprocessor and CerberusDetInference.predict at batch 1 and 8:
     every NMS launch is counted, and the results equal those of the same
     batch with the plain NMS loop on the card;
  4. check the results against a reference on a small input: yolov8n_2task at
     64 px in float64 on the card against the port's CPU path.
Progress and timings go to earlier lines; the line before the last JSON
object lists the kernels, the next the card's name and power limit, and the
last line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits with an error before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "models", "yolov8x_2task.yaml")
SMALL = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["voc", "animals"], [20, 19]
CONF = 1e-4          # low enough that a random-init model detects in both tasks
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
# per live candidate and step the kernel does 2 min, 2 max, 5 sub, 2 clamp,
# 2 mul, 2 add, 1 div and 1 compare for the IoU test, plus 1 compare in the
# argmax scan
OPS_PER_LIVE = 18


def log(*a):
    print(*a, flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nms_work(boxes, scores, iou_thres: float, max_det: int):
    """Operations the kernel needs for these inputs: per image and step until
    its early end, a scan of the K live scores plus the IoU test of every
    live candidate. Returns (ops, steps per image)."""
    import torch

    from cerberusdet_tpu_torch.ops.boxes import box_iou

    ops, steps = 0, []
    for b in range(scores.shape[0]):
        live = scores[b].clone()
        n = 0
        for _ in range(max_det):
            n += 1
            ops += live.numel()  # the argmax scan
            j = int(live.argmax())
            if float(live[j]) == 0.0:
                break  # the kernel's early end
            ops += OPS_PER_LIVE * int((live != 0).sum())
            iou = box_iou(boxes[b, j][None], boxes[b])[0]
            live = torch.where(iou > iou_thres, 0.0, live)
            live[j] = 0.0
        steps.append(n)
    return ops, steps


def distinct_heads(model, seed: int) -> None:
    """Random box-tower biases from `seed`. With the prior bias (all bins
    1.0) a random-init model draws nearly the same box at every anchor in
    every task, and cross-task suppression then leaves one task only."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.task_ids:
            head = model.block(model.head_uid(t))
            for i in range(head.nl):
                b = getattr(head, f"box{i}")[2].b
                b.copy_(torch.randn(b.shape, generator=gen) * 3.0)


def same_results(a, b, score_rtol: float) -> None:
    assert len(a) == len(b), (len(a), len(b))
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb), (len(ra), len(rb))
        for x, y in zip(ra, rb):
            assert (x["task"], x["label"], x["label_name"]) == \
                (y["task"], y["label"], y["label_name"]), (x, y)
            assert abs(x["score"] - y["score"]) <= score_rtol * abs(y["score"]), (x, y)
            assert max(abs(u - v) for u, v in zip(x["box"], y["box"])) <= 1, (x, y)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from cerberusdet_tpu_torch.infer import CerberusDetInference, CerberusPreprocessor
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.ops import nms_cuda
    from cerberusdet_tpu_torch.ops.nms import (
        cross_task_suppress,
        non_max_suppression,
        select_candidates,
    )
    from cerberusdet_tpu_torch.testing import boundary_candidates, random_candidates

    torch.set_grad_enabled(False)  # serving only
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi_name_power()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  card: {card}")

    # ---- 1. build
    t0 = time.perf_counter()
    lib = nms_cuda.build(verbose=True)
    log(f"[build] {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.2f} s")

    # ---- 2. kernel against plain, on the card
    cases = [
        ("K8400 thr0.45 ties zero-tail class-offset",
         random_candidates(8, 8400, seed=1, zeros_from=6000, classes=20), 0.45),
        ("K8400 thr0.7 ties", random_candidates(8, 8400, seed=2), 0.7),
        ("K16384 thr0.45", random_candidates(8, 16384, seed=3, classes=3), 0.45),
        ("K16384 thr0.7 zero-tail", random_candidates(8, 16384, seed=4, zeros_from=9000), 0.7),
        ("boundary thr0.45", boundary_candidates(0.45, n=16)[:2], 0.45),
        ("boundary thr0.7", boundary_candidates(0.7, n=16)[:2], 0.7),
    ]
    max_err = 0
    for name, (boxes, scores), thr in cases:
        b = torch.from_numpy(boxes).to(dev)
        s = torch.from_numpy(scores).to(dev)
        md = min(300, s.shape[1])
        idx_k, val_k = nms_cuda.greedy_nms_cuda(b, s, thr, md)
        idx_p, val_p = nms_cuda.greedy_nms(b, s, thr, md)
        torch.cuda.synchronize()
        err = max(int((idx_k.long() - idx_p.long()).abs().max()),
                  int((val_k.long() - val_p.long()).abs().max()))
        max_err = max(max_err, err)
        log(f"[nms kernel vs plain] {name}: B={s.shape[0]} K={s.shape[1]} "
            f"valid={int(val_k.sum())} max|diff|={err}")
        if err:
            raise AssertionError(f"NMS kernel disagrees with the plain loop on {name}")

    # ---- 3. the main path at full width
    names = {t: [f"{t}_{i}" for i in range(n)] for t, n in zip(TASKS, NCS)}
    t0 = time.perf_counter()
    model = CerberusModel(FLAGSHIP, TASKS, NCS, device=dev).init(seed=0)
    distinct_heads(model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    inf = CerberusDetInference(model=model, names=names, conf_thres=CONF, img_size=640,
                               dtype=torch.bfloat16, device=dev)
    pre = CerberusPreprocessor(img_size=640, device=dev)
    log(f"[main] yolov8x_2task {n_params / 1e6:.2f} M params, bf16, built in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    frames = {bs: [list(rng.integers(0, 256, (bs, 480, 640, 3), dtype=np.uint8))
                   for _ in range(3)] for bs in (1, 8)}
    for bs in (1, 8):  # warmup: cuDNN algorithm choice, allocator
        batch, shapes = pre.preprocess(frames[bs][0])
        inf.predict(batch, original_shape=shapes)
    torch.cuda.synchronize()

    nms_cuda.greedy_nms_cuda.launches = 0
    served, per_bs = [], {}
    for bs in (1, 8):
        times = []
        for imgs in frames[bs]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            batch, shapes = pre.preprocess(imgs)
            out = inf.predict(batch, original_shape=shapes)
            times.append(time.perf_counter() - t)
            served.append((batch, shapes, out))
        per_bs[bs] = times
    launches = nms_cuda.greedy_nms_cuda.launches
    n_requests = sum(len(v) for v in frames.values())
    log(f"[main] {n_requests} requests, NMS kernel launches {launches} "
        f"(expected {len(TASKS) * n_requests})")
    if launches != len(TASKS) * n_requests:
        raise AssertionError("the main path did not launch the NMS kernel once per task "
                             "and request")
    for bs, times in per_bs.items():
        ms = 1e3 * float(np.median(times))
        log(f"[main] batch {bs}: {ms:.2f} ms/request (median of {len(times)}, "
            f"preprocess + predict, host clock), {bs / ms * 1e3:.1f} img/s  [{card}]")
    for batch, shapes, out in served:
        assert len(out) == batch.shape[0]
        for task in TASKS:
            n = sum(d["task"] == task for r in out for d in r)
            assert n > 0, f"no {task} detections"
        for r in out:
            for d in r:
                assert np.isfinite(d["score"]) and 0 < d["score"] <= 1
                assert all(np.isfinite(v) for v in d["box"])
    n_det = sum(len(r) for _, _, out in served for r in out)
    log(f"[main] {n_det} detections in {n_requests} requests, both tasks present")

    # the same batch with the plain NMS loop on the card: identical results
    batch, shapes, _ = served[-1]
    out = inf.predict(batch, original_shape=shapes)
    plain = inf.predict(batch, original_shape=shapes, use_kernel=False)
    same_results(out, plain, score_rtol=0.0)
    log("[main] batch 8 with the plain NMS loop on the card: identical results")

    # where the time goes: each stage alone, CUDA events around 5 calls
    # (a stage that is launch-bound shows its host time here)
    for bs in (1, 8):
        imgs = frames[bs][0]
        bt, _ = pre.preprocess(imgs)
        x = bt.permute(0, 3, 1, 2).to(torch.bfloat16)
        pre_ms = cuda_ms(lambda: pre.preprocess(imgs), iters=5)
        fwd_ms = cuda_ms(lambda: inf.model(x), iters=5)
        preds = inf.model(x)
        nms_ms = cuda_ms(lambda: [non_max_suppression(
            preds[t][0], nc=len(names[t]), conf_thres=CONF, iou_thres=0.45,
            max_det=300) for t in TASKS], iters=5)
        merged, task_idx, _ = inf.predict_device(bt, CONF, 0.45, 0.8, False, 300)
        ct_ms = cuda_ms(lambda: cross_task_suppress(merged, task_idx, 0.8, scan_rows=300),
                        iters=5)
        dev_ms = cuda_ms(lambda: inf.predict_device(bt, CONF, 0.45, 0.8, False, 300),
                         iters=5)
        log(f"[stages] batch {bs}: preprocess {pre_ms:.3f} ms, forward {fwd_ms:.3f} ms, "
            f"NMS x{len(TASKS)} {nms_ms:.3f} ms, cross-task {ct_ms:.3f} ms, "
            f"forward+NMS+cross-task {dev_ms:.3f} ms  [{card}]")

    # kernel at the main path's shapes: the candidates of the last batch-8 request
    task_ms = {}
    for task in TASKS:
        pred = inf.model(served[-1][0].permute(0, 3, 1, 2).to(torch.bfloat16))[task][0]
        _, conf, _, offset_boxes = select_candidates(
            pred, len(names[task]), CONF, False, None, nms_cuda.MAX_K, False)
        k_ms = cuda_ms(lambda: nms_cuda.greedy_nms_cuda(offset_boxes, conf, 0.45, 300),
                       iters=20)
        p_ms = cuda_ms(lambda: nms_cuda.greedy_nms(offset_boxes, conf, 0.45, 300), iters=3,
                       warmup=1)
        ops, steps = nms_work(offset_boxes, conf, 0.45, 300)
        task_ms[task] = (k_ms, p_ms, ops, steps, tuple(conf.shape))
        log(f"[nms at main-path shapes] {task}: B,K={tuple(conf.shape)} kernel {k_ms:.4f} ms"
            f", plain {p_ms:.3f} ms, steps per image {steps}  [{card}]")
    nms_cuda.greedy_nms_cuda.launches = launches  # the timing launches do not count

    k_ms, p_ms, ops, steps, (bsz, k) = task_ms[TASKS[0]]
    nbytes = bsz * k * (16 + 4) + bsz * 300 * (4 + 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    kernels = [{
        "name": "nms",
        "route": "cuda",
        "source": "cerberusdet_tpu_torch/csrc/nms.cu",
        "replaces": "cerberusdet_tpu/ops/nms_pallas.py:34",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no PyTorch call computes greedy NMS (no torchvision)
    }]

    # ---- 4. against a reference on a small input: card float64 vs CPU float64
    small = CerberusModel(SMALL, ["a", "b"], [3, 5], device="cpu").init(seed=2)
    distinct_heads(small, seed=3)
    small_names = {"a": ["c0", "c1", "c2"], "b": ["k0", "k1", "k2", "k3", "k4"]}
    state = {k: v.clone() for k, v in small.state_dict().items()}
    ref_model = CerberusModel(SMALL, ["a", "b"], [3, 5], device="cpu")
    ref_model.load_state_dict(state)
    small.to(dev)
    kw = dict(names=small_names, conf_thres=CONF, img_size=64, dtype=torch.float64)
    on_card = CerberusDetInference(model=small, device=dev, **kw)
    on_cpu = CerberusDetInference(model=ref_model, device="cpu", **kw)
    xs = np.random.default_rng(5).uniform(0, 1, (4, 64, 64, 3))
    shapes = [(96, 128), (64, 64), (50, 80), (128, 96)]
    a = on_card.predict(xs, original_shape=shapes)
    b = on_cpu.predict(xs, original_shape=shapes)
    # float32 decode on both; a sigmoid may round differently on the card by 1 ulp
    same_results(a, b, score_rtol=1e-6)
    assert all(sum(d["task"] == t for r in a for d in r) > 0 for t in ("a", "b"))
    log(f"[reference] yolov8n_2task 64 px float64: card == CPU on "
        f"{sum(map(len, a))} detections")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
