"""Drive the PyTorch/CUDA port (cerberusdet_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, each of which fails the run on anything wrong:
  1. build every kernel of the port from the sources in the checkout (one
     nvcc per source, all started together);
  2. hold each kernel against its plain PyTorch version on the card, and
     time both (the int8 kernels in 3b): the NMS kernel (identical
     selections; K 8400 and 16384, IoUs within an ulp of the threshold,
     negative scores, one image, duplicate boxes) and the three TAL
     assigner kernels, stage by stage (identical integer and bool outputs,
     scores within rtol 1e-5, atol 1e-6) on the scenes of the CPU tests
     (N 5 below k, N 333 and 8400, not multiples of 32, a row with fewer
     than k inside anchors, included) and on the flagship train shapes;
     tal_norm identical with the plain normalise on the same inputs, on
     those scenes and at nc 20, 19 and 1, on an all-background batch and
     where B * N is not a multiple of its 256-anchor block;
  3. serve the flagship program, 2-task CerberusDet-v8x (voc/animals,
     nc 20/19) at 640 px in bfloat16 with seeded random weights, through
     CerberusPreprocessor and CerberusDetInference.predict at batch 1 and 8.
     The first request of each key captures predict's CUDA graph; later
     requests replay it, and the NMS launches they count are the captured
     launches times the replays (checked against the profiler's trace of a
     replay, by kernel name). The results equal those of the same batches
     with the plain NMS loop run eagerly; each replay equals predict_device
     run eagerly, bit for bit, for the capturing request and for one with
     other frames; a new threshold captures a new key, and there is one
     capture per key. Eager and replayed requests are timed, with their
     device-busy shares and the graph pool's size. The preprocessor
     letterboxes 4 source shapes on the card (each replay identical with
     its eager run) and sends a fifth to the host;
  3b. serve the same model in int8 (int8="all", noise calibration): the
     conv kernel's SASS must hold int8 tensor-core instructions (cuobjdump);
     the two int8 kernels against their plain versions at every distinct
     quantized conv shape of a batch-8 request (quant_pack_s8 on the
     request's conv inputs in bf16, float32 and int8, and at edge cases:
     misaligned 15x20 planes, channel slices at odd offsets, channels-last
     views, HW 1; conv_s8 in raw int32 and the float32 / bf16 / int8
     epilogues, and at edge cases), all identical;
     3 + 3 replayed requests with one launch of each kernel per quantized
     Conv and request, identical results with the plain int8 path and NMS
     (also for a letterboxed batch-1 frame, whose maps go down to 15x20),
     replays identical with eager runs, agreement with bf16, and timings
     (torch._int_mm as the yardstick of a 1x1 conv; a plain copy of
     quant_pack_s8's largest input as the card's streaming rate);
  4. train the flagship: MultiTaskTrainer.step at 640 px, bf16 compute,
     per-task batch 8, 300 gt rows of which 40 are real, seeded batches and
     init; 2 warm-up and 5 timed steps with finite losses, every TAL kernel
     launched once per task and step, and one step from the same state with
     the plain assigner giving the same losses;
  5. check against a reference on a small input: yolov8n_2task at 64 px in
     float64 on the card against the port's CPU path, for predict and for
     one train step; the float64 replay equals an eager run, also after an
     in-place weight update, which it sees;
  6. validate the flagship through the val entry point (cli/val.py:main):
     a seeded 2-task val set of 96 JPEGs a task at mixed native sizes (three
     rect shapes a task at batch 32, pad 0.5, two of them 672 px on a side),
     the seeded model (BatchNorm statistics from 8 of the images) saved as a
     .ckpt.npz and labelled with its own bf16 detections at conf >= 0.25,
     then main in float32, --bf16 and --bf16 --int8 all (conf 0.001, IoU
     0.6, multi-label): bf16 re-finds every label (recall 1.0 at IoU 0.5),
     run_task with the NMS kernel and with the plain loop gives identical
     statistics, and so does the int8 model with conv_s8 / quant_pack_s8
     and with their plain versions; both int8 kernels equal their plain
     versions at every quantized conv shape of every rect batch; one NMS
     launch per batch and task, one conv_s8 and one quant_pack_s8 per
     quantized Conv and batch. Prints P, R, mAP50, mAP and the speed terms
     per task and precision, the NMS kernel at val traffic and conv_s8
     summed over one int8 batch;
  7. train the flagship through the train entry point (cli/train.py:main):
     the seeded model (BatchNorm statistics from 8 train images) as
     --weights, 48 train and 16 val seeded labelled JPEGs a task, the
     paper's hyps (mosaic 1.0, mixup 0.285), --bf16, per-task batch 8: run A
     for 2 epochs with the native JPEG decoder deleted before it (its first
     decode builds it), run R resuming A with its opt.yaml's epochs raised
     to 3, and a fresh 3-epoch run B (--nosave --noval) whose steps are
     synchronised, timed and, for 3 steps, profiled. The TAL kernels launch
     once per task and step (and per val batch and task where the val
     computes losses), the NMS kernel once per val batch and task; A's first
     step with the plain assigner gives the kernels' losses (rtol 1e-5); B's
     steps get A's and R's batches (sha1 of img and bboxes); R starts from
     the saved params exactly; A's final val on last.ckpt.npz equals
     cli/val.py's main on the same file; the TAL and NMS kernels equal their
     plain versions on the first inputs the path gave them. Prints the step
     time, the host's wait for data, the device-busy share, host
     augmentation per image, the decoder, val and save times, peak memory
     and main's wall;
  8. drive the serving entry points (cli/detect.py, cli/serve.py): the
     seeded flagship (BatchNorm statistics from 8 source images) as a
     .ckpt.npz and 24 seeded JPEGs at the val cell's five native sizes.
     detect.main with --bf16 --save-crop: one captured predict program
     (batch 1, 640x640, bf16), the NMS kernel launched once per task and
     image (and in the capture's eager run), each image's detections
     identical to predict on the same batch with use_kernel=False, each
     annotated file byte-identical to cv2.imwrite of the visualizer's
     drawing, one crop per detection with a non-empty box; then with --int8
     all (calibrated on the source images): conv_s8 and quant_pack_s8 once
     per quantized Conv and image, each image identical to the plain int8
     path, both kernels identical to their plain versions at every conv
     shape of a forward; then from the .pt that tools/export_to_pt writes of
     the checkpoint (--cfg, --data): the .ckpt.npz run's detections, image
     by image, and the import timed. cli.serve.build at --max-batch 8,
     --max-wait-ms 5 on 127.0.0.1 port 0, in bf16 and in int8 "all":
     /healthz; the warm-up captures the one predict program and no request
     captures another; 8 sequential requests at mixed native sizes (6
     letterboxed on the card, 2 past the 4 device shapes on the host), each
     response equal to _to_jsonable of predict on the frame's batch
     zero-padded to 8 with use_kernel=False; twice a flood of 64 requests of
     the four 480x640 frames (the detect folder's four busiest images,
     resized) from 16 client threads, each 200 and equal to the sequential
     response of its frame, the first cold, the second after every batch
     size's letterbox graph is captured and under the profiler; NMS (and
     the int8 kernels) launched once per task (quantized Conv) and served
     batch. Prints detect ms an image, the .pt import time, requests/s,
     client latency p50 / p99, batch fill, the card's busy share under the
     warm flood, the preprocessor's captures and the graph pools' size;
  9. drive the measurement entry points at headline traffic with 3 replays
     a timed round: cerberusdet_tpu_torch.bench's main in int8 and bf16 at
     batch 128 and 32 (the seeded flagship, int8 calibrated in float64 on
     assets/calib and held against the port's golden; the forward captured
     and replayed as dependent iterations), tools.bench_serving's main in
     int8 at batch 32 and tools.bench_train_step's main. Each captured loop
     launches each kernel as many times as its replays and its capture's
     eager run need; the int8 graphs hold exactly one conv_s8 and one
     quant_pack_s8 node per int8 Conv (143), every graph a conv node per
     convolution; one replay equals the eager forward bit for bit, and the
     batch-128 int8 forward equals the four batch-32 forwards of its slices;
     conv_s8 and quant_pack_s8 equal their plain versions at every distinct
     shape of the batch-32 and batch-128 forwards (their summed times and
     shares of the bound printed); the serving stages with NMS launch it
     once per task and replay; the train-step routes' first losses agree
     within 1e-5 and the kernels' route launches each TAL kernel once per
     task and step.
Progress and timings go to earlier lines; the line before the last JSON
object lists the kernels, the next the card's name and power limit, and the
last line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits with an error before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import copy
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "models", "yolov8x_2task.yaml")
SMALL = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["voc", "animals"], [20, 19]
CONF = 1e-4          # low enough that a random-init model detects in both tasks
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12    # H100 SXM, dense int8 tensor cores
# per live candidate and step the kernel does 2 min, 2 max, 5 sub, 2 clamp,
# 2 mul, 2 add, 1 div and 1 compare for the IoU test, plus 1 compare in the
# argmax scan
OPS_PER_LIVE = 18
# TAL (csrc/tal.cu), per (gt, anchor) pair: the clipped CIoU is 52 float
# operations (27 add/sub, 11 mul, 3 div, 11 min/max), the align metric 7
# (a sqrt and 6 mul), the in-gt test 8 (4 sub, 3 min, 1 compare), and the
# top-k at least 1 compare
OPS_CIOU, OPS_ALIGN, OPS_INSIDE = 52, 7, 8
TRAIN_BATCH, TRAIN_LABELS, TRAIN_REAL = 8, 300, 40
WARMUP_STEPS, TIMED_STEPS = 2, 5


def log(*a):
    print(*a, flush=True)


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


def kernel_ms(fn, iters: int, name: str):
    """(device ms, source) of the kernel whose name contains `name`, per
    call of fn(), which launches it once: the kernel's own time on the card
    from the profiler's CUDA trace, the mean over the launches it recorded. Where the trace shows no such kernel, the mean time of a
    call by CUDA events (which counts the host's launch cost when that is
    the longer), and source says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    us = sum(e.device_time_total for e in hits)
    count = sum(e.count for e in hits)
    if count and us > 0:  # fn launches the kernel once: the mean of the launches seen
        return us / 1e3 / count, ("profiler" if count == iters else
                                  f"profiler, {count} of {iters} launches seen")
    return cuda_ms(fn, iters), "events (the profiler saw no kernel)"


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


def tal_stages(inp, nc: int, use_kernel: bool):
    """The assignment in the kernels' three stages, by the kernels or by the
    plain version. Returns (positives (B, M, N) bool, (target_gt_idx,
    fg_mask, target_labels, target_bboxes, pos (B, M, 2)), target_scores)."""
    import torch

    from cerberusdet_tpu_torch.ops import tal_cuda

    if use_kernel:
        sel = tal_cuda.select_kernel(inp, min(10, inp["scores"].shape[1]), 6)
        tgt, fg, labels, boxes, align, pos = tal_cuda.assign_kernel(inp, sel, 6)
        scores = tal_cuda.norm_kernel(tgt, fg, labels, align, pos, nc, 1e-9)
        return tal_cuda.selection_mask(sel, inp["scores"].shape[1]), \
            (tgt, fg, labels, boxes, pos), scores
    plain = tal_cuda.TaskAlignedAssigner(10, nc)
    labels = inp["labels"].clamp(0, nc - 1)
    mask_pos, ov, align = plain.select_topk(inp["scores"], inp["pd_bboxes"], inp["anchors"],
                                            labels, inp["gt_bboxes"], inp["mask_gt"])
    tgt, fg, resolved, pos_align, pos_ov = plain.resolve(mask_pos, ov, align)
    t_labels = labels.gather(1, tgt)
    t_boxes = inp["gt_bboxes"].gather(1, tgt[..., None].expand(*tgt.shape, 4))
    scores = plain.normalise(t_labels, fg, resolved, align, pos_align, pos_ov, torch.float32)
    return mask_pos > 0, (tgt, fg, t_labels, t_boxes, torch.stack([pos_align, pos_ov], -1)), \
        scores


def norm_compare(tgt, fg, labels, align, pos, nc: int) -> float:
    """tal_norm against the plain normalise on the same per-anchor inputs
    (tal_assign's outputs; the plain version takes the resolved mask and
    the align metric scattered to (B, M, N) at each anchor's gt). Returns
    the largest |kernel - plain| (0); raises on any difference."""
    import torch

    from cerberusdet_tpu_torch.ops import tal_cuda

    b, n = tgt.shape
    m = pos.shape[1]
    got = tal_cuda.norm_kernel(tgt, fg, labels, align, pos, nc, 1e-9)
    zeros = torch.zeros((b, m, n), device=tgt.device)
    mask_pos = zeros.scatter(1, tgt[:, None], fg[:, None].float())
    align3 = zeros.scatter(1, tgt[:, None], align[:, None])
    want = tal_cuda.TaskAlignedAssigner(10, nc).normalise(
        labels, fg, mask_pos, align3, pos[..., 0], pos[..., 1], torch.float32)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        log(f"[tal_norm vs plain] B,N,nc={tuple(got.shape)}: {int((got != want).sum())} of "
            f"{got.numel()} values differ")
        raise AssertionError("tal_norm disagrees with the plain normalise")
    return float((got - want).abs().max())


def tal_compare(inp, nc: int):
    """Each TAL kernel against its plain stage on the same inputs (tal_norm
    on tal_assign's outputs, identical; the scores of the whole assignment
    within rtol 1e-5, atol 1e-6). Returns (max |diff| per kernel, the plain
    stage-1 positives)."""
    import torch

    from cerberusdet_tpu_torch.ops import tal_cuda

    pk, ak, sk = tal_stages(inp, nc, use_kernel=True)
    pp, ap, sp = tal_stages(inp, nc, use_kernel=False)
    torch.cuda.synchronize()
    sel = tal_cuda.select_kernel(inp, min(10, inp["scores"].shape[1]), 6)
    tgt, fg, labels, _, align, pos = tal_cuda.assign_kernel(inp, sel, 6)
    err = {"tal_select": int((pk != pp).sum()),
           "tal_assign": max(float((x.double() - y.double()).abs().max()) for x, y in zip(ak, ap)),
           "tal_norm": norm_compare(tgt, fg, labels, align, pos, nc)}
    torch.testing.assert_close(sk, sp, rtol=1e-5, atol=1e-6)
    if err["tal_select"] or err["tal_assign"]:
        raise AssertionError(f"TAL kernels disagree with the plain stages: {err}")
    return err, pp


# the symbols of the serving kernels, by wrapper (ops/nms_cuda.py, ops/conv_int8_cuda.py)
KERNEL_SYMBOLS = {"greedy_nms_cuda": "nms_kernel", "quant_pack_s8": "quant_pack",
                  "conv_s8": "conv_s8_kernel"}


def replay_matches_eager(inf, batch, args) -> None:
    """A request through predict (its key's graph, captured on first use)
    against predict_device run eagerly on the same batch: the packed
    outputs (merged, task_idx, keep) must be identical, bit for bit."""
    import torch

    from cerberusdet_tpu_torch.infer.inference import pack_outputs

    conf, iou, iou_bt, agnostic, max_det = args
    inf.predict(batch, conf_thres=conf, iou_thres=iou, iou_thres_between_tasks=iou_bt,
                agnostic_nms=agnostic, max_det=max_det)
    xb = torch.as_tensor(batch)
    replayed = inf.programs[inf.program_key(xb, *args)].run(xb).clone()
    eager = pack_outputs(*inf.predict_device(xb.to(inf.device), *args))
    if not torch.equal(replayed, eager):
        raise AssertionError(f"a replayed request differs from predict_device run eagerly "
                             f"(batch {tuple(xb.shape)}, {xb.dtype}, args {args})")


def graph_timings(inf, bt, args, card: str, label: str):
    """Eager against replayed on the device batch `bt`, whose program is
    captured: the device request (predict_device and one copy of its packed
    outputs to the host, against a replay and the same copy) by host clock,
    median of 5 after 2 warm-ups; the device part alone by CUDA events over
    5 calls; each one's device-busy share, the profiler's device time of
    one request over the host-clock median (the tracing lengthens the
    profiled call itself, whose time is printed beside). The launches the
    capture recorded must equal the graph's own kernel nodes, by name: what
    every replay runs. The profiler's trace of one replay, by name, may show
    fewer (CUPTI drops records when a graph's thousands of launches outrun
    it; kernel_ms sees the same with eager launches) but never more, and
    the line says how many it showed."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cerberusdet_tpu_torch.infer.inference import pack_outputs
    from cerberusdet_tpu_torch.utils.profiling import graph_kernel_names

    prog = inf.programs[inf.program_key(bt, *args)]
    fns = {"eager": lambda: pack_outputs(*inf.predict_device(bt, *args)).cpu(),
           "replayed": lambda: prog.run(bt).cpu()}
    host, busy, wall, traces = {}, {}, {}, {}
    for name, fn in fns.items():
        for _ in range(2):
            fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        host[name] = 1e3 * float(np.median(times))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            wall[name] = 1e3 * (time.perf_counter() - t)
        traces[name] = prof.key_averages()
        busy[name] = sum(e.device_time_total for e in traces[name]) / 1e3
    dev_eager = cuda_ms(lambda: inf.predict_device(bt, *args), iters=5)
    dev_replay = cuda_ms(prog.graph.replay, iters=5)
    recorded = {w.__name__: n for w, n in zip(prog.counted, prog.launches) if n}
    nodes = graph_kernel_names(prog.graph)
    in_graph = {w: sum(KERNEL_SYMBOLS[w] in k for k in nodes) for w in recorded}
    if in_graph != recorded:
        raise AssertionError(f"{label}: the graph holds {in_graph} kernel nodes, the capture "
                             f"recorded {recorded}")
    seen = {w: sum(e.count for e in traces["replayed"] if KERNEL_SYMBOLS[w] in e.key)
            for w in recorded}
    if any(seen[w] > n for w, n in recorded.items()):
        raise AssertionError(f"{label}: one replay's trace shows {seen}, more than the graph's "
                             f"{recorded}")
    how = (f"the graph's {len(nodes)} kernel nodes hold the captured launches {recorded}; "
           f"the trace of one replay shows {seen}"
           + ("" if seen == recorded else " (the trace dropped records)"))
    share = {k: busy[k] / host[k] for k in host}
    log(f"[graphs] {label} batch {bt.shape[0]}: device request (predict_device + one copy to "
        f"the host) eager {host['eager']:.3f} ms, replayed {host['replayed']:.3f} ms (host "
        f"clock, median of 5), {host['eager'] / host['replayed']:.2f}x; device part alone eager "
        f"{dev_eager:.3f} ms, replayed {dev_replay:.3f} ms (CUDA events, 5 calls); device busy "
        f"eager {busy['eager']:.3f} ms = {100 * share['eager']:.1f}%, replayed "
        f"{busy['replayed']:.3f} ms = {100 * share['replayed']:.1f}% (the profiler's device "
        f"time of one request over the host-clock median; the profiled call itself took "
        f"{wall['eager']:.3f} / {wall['replayed']:.3f} ms); {how}  [{card}]")


def first_requests(inf, pre, frames, label: str, card: str):
    """The first request of each batch size (1 and 8) with the default
    arguments: it runs predict_device eagerly, captures it and replays.
    Logs each one's host time and the graph pool's size after it."""
    import torch

    from cerberusdet_tpu_torch.utils.profiling import pool_mib

    for bs in (1, 8):
        batch, shapes = pre.preprocess(frames[bs][0])
        torch.cuda.synchronize()
        t = time.perf_counter()
        inf.predict(batch, original_shape=shapes)
        took = time.perf_counter() - t
        log(f"[graphs] {label} batch {bs}: first request of the key (eager run + capture + "
            f"replay) {took:.3f} s; graph pool {pool_mib(inf._pool):.1f} MiB after it  [{card}]")


def tal_work(inp, positives, nc: int):
    """(operations, bytes) per TAL kernel that these inputs need: tal_select
    the pairs of each valid gt row; tal_assign one CIoU and align per anchor
    with a positive, all M rows for an anchor with several; tal_norm 3
    operations per fg anchor. Bytes: each input read once, each output
    written once."""
    b, n, _ = inp["scores"].shape
    m = inp["labels"].shape[1]
    valid = int(inp["mask_gt"].sum())
    count = positives.sum(1)
    fg, multi = int((count > 0).sum()), int((count > 1).sum())
    gt_bytes = b * m * (8 + 16 + 4 + 1)
    anchor_bytes = b * n * (16 + 4)
    sel_bytes = b * m * 10 * 4
    out_bytes = b * n * (8 + 1 + 8 + 16 + 4)
    return {
        "tal_select": (valid * n * (OPS_CIOU + OPS_ALIGN + OPS_INSIDE + 1),
                       b * n * nc * 4 + anchor_bytes + n * 8 + gt_bytes + sel_bytes),
        "tal_assign": ((fg - multi) * (OPS_CIOU + OPS_ALIGN) + multi * (m * OPS_CIOU + OPS_ALIGN),
                       anchor_bytes + gt_bytes + sel_bytes + fg * 4 + out_bytes + b * m * 8),
        "tal_norm": (3 * fg, b * n * 21 + b * m * 8 + b * n * nc * 4),
    }


TAL_KERNELS = ("tal_select", "tal_assign", "tal_norm")


def tal_entries(args, nc: int, launches, label: str, card: str, extra=None):
    """Each TAL kernel on the assignment inputs `args` (the first a path gave
    loss.task_aligned_assign, with nc classes) against its plain stage, its
    time on the card (profiler), the plain stage's (CUDA events) and its
    bound: kernels-line entries "<kernel> (<label>, ...)". launches:
    {kernel: count on the path}; extra: {kernel: {key: value}} added to an
    entry."""
    import torch

    from cerberusdet_tpu_torch.ops import tal_cuda

    inp = tal_cuda.kernel_inputs(*args, nc)
    err, pos = tal_compare(inp, nc)
    k = min(10, inp["scores"].shape[1])
    sel = tal_cuda.select_kernel(inp, k, 6)
    tgt, fg, lab, _, al, po = tal_cuda.assign_kernel(inp, sel, 6)
    plain = tal_cuda.TaskAlignedAssigner(k, nc)
    labels = inp["labels"].clamp(0, nc - 1)
    planes = plain.select_topk(inp["scores"], inp["pd_bboxes"], inp["anchors"], labels,
                               inp["gt_bboxes"], inp["mask_gt"])
    tgt_p, fg_p, mp_p, pa_p, po_p = plain.resolve(*planes)
    t_lab = labels.gather(1, tgt_p)
    launch = {
        "tal_select": lambda: tal_cuda.select_kernel(inp, k, 6),
        "tal_assign": lambda: tal_cuda.assign_kernel(inp, sel, 6),
        "tal_norm": lambda: tal_cuda.norm_kernel(tgt, fg, lab, al, po, nc, 1e-9),
    }
    plain_stage = {
        "tal_select": lambda: plain.select_topk(inp["scores"], inp["pd_bboxes"],
                                                inp["anchors"], labels, inp["gt_bboxes"],
                                                inp["mask_gt"]),
        "tal_assign": lambda: plain.resolve(*planes),
        "tal_norm": lambda: plain.normalise(t_lab, fg_p, mp_p, planes[2], pa_p, po_p,
                                            torch.float32),
    }
    work = tal_work(inp, pos, nc)
    shape, valid = tuple(pos.shape), int(inp["mask_gt"].sum())
    entries = []
    for name in TAL_KERNELS:
        k_ms, how = kernel_ms(launch[name], 20, name + "_kernel")
        p_ms = cuda_ms(plain_stage[name], iters=3)
        ops, nbytes = work[name]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        log(f"[tal at {label}] {name}: B,M,N={shape} ({valid} valid gt rows), kernel "
            f"{k_ms:.4f} ms ({how}), plain {p_ms:.3f} ms, max|diff| {err[name]}  [{card}]")
        entries.append({
            "name": f"{name} ({label}, B,M,N {shape}, {valid} valid gt rows)",
            "route": "cuda",
            "source": "cerberusdet_tpu_torch/csrc/tal.cu",
            "replaces": ("cerberusdet_tpu/ops/tal_pallas.py:146" if name == "tal_norm"
                         else "cerberusdet_tpu/ops/tal_pallas.py:99"),
            "launches": launches[name],
            **(extra or {}).get(name, {}),
            "max_abs_err": err[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,  # no PyTorch call computes a task-aligned assignment
        })
    return entries


def nms_kernel_entry(boxes, scores, iou: float, max_det: int, label: str, launches: int,
                     card: str, extra=None):
    """The NMS kernel on one batch of candidates (offset boxes, scores) against
    the plain loop (identical picks), its time on the card (profiler), the
    plain loop's (CUDA events) and its bound: a kernels-line entry."""
    from cerberusdet_tpu_torch.ops import nms_cuda

    idx_k, val_k = nms_cuda.greedy_nms_cuda(boxes, scores, iou, max_det)
    idx_p, val_p = nms_cuda.greedy_nms(boxes, scores, iou, max_det)
    err = max(int((idx_k.long() - idx_p.long()).abs().max()),
              int((val_k.long() - val_p.long()).abs().max()))
    if err:
        raise AssertionError(f"the NMS kernel disagrees with the plain loop ({label})")
    k_ms, how = kernel_ms(lambda: nms_cuda.greedy_nms_cuda(boxes, scores, iou, max_det), 20,
                          "nms_kernel")
    p_ms = cuda_ms(lambda: nms_cuda.greedy_nms(boxes, scores, iou, max_det), iters=3,
                   warmup=1)
    ops, steps = nms_work(boxes, scores, iou, max_det)
    bsz, kk = scores.shape
    bytes_ms = (bsz * kk * 20 + bsz * max_det * 5) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    positives = (scores > 0).sum(1).tolist()
    log(f"[nms at {label}] B,K={tuple(scores.shape)}, positives an image {positives}, steps "
        f"{steps}: kernel {k_ms:.4f} ms ({how}), plain {p_ms:.3f} ms, picks identical  "
        f"[{card}]")
    return {
        "name": f"nms ({label}, B,K {tuple(scores.shape)})",
        "route": "cuda",
        "source": "cerberusdet_tpu_torch/csrc/nms.cu",
        "replaces": "cerberusdet_tpu/ops/nms_pallas.py:34",
        "launches": launches,
        **(extra or {}),
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # PyTorch has no NMS call
    }


def snapshot(state):
    """Copies of everything a train step changes in `state`."""
    return (copy.deepcopy(state.model.state_dict()), copy.deepcopy(state.ema.state_dict()),
            copy.deepcopy(state.opt_state), state.n_updates)


def restore(state, snap) -> None:
    model_sd, ema_sd, opt, n = snap
    state.model.load_state_dict(model_sd)
    state.ema.load_state_dict(ema_sd)
    state.opt_state = copy.deepcopy(opt)
    state.n_updates = n


def close_updates(ours, ref, init, frac: float, what: str) -> float:
    """Each tensor of state_dict `ours` within frac of the largest change
    ref - init; returns the worst ratio."""
    worst = 0.0
    for k, r in ref.items():
        change = float((r - init[k]).abs().max())
        diff = float((ours[k].cpu() - r).abs().max())
        ratio = diff / max(change, 1e-30)
        worst = max(worst, ratio if change > 0 else (0.0 if diff == 0 else float("inf")))
        if diff > frac * change + 1e-12:
            raise AssertionError(f"{what}: {k} differs by {diff}, {ratio:.3g} of its change")
    return worst


def matched_detections(a, b, iou_min: float = 0.5) -> int:
    """Detections of result lists `a` that match one of `b` on the same
    image: same task and label, box IoU >= iou_min, each of b used once."""
    n = 0
    for ra, rb in zip(a, b):
        free = list(rb)
        for x in ra:
            for y in free:
                if (x["task"], x["label"]) != (y["task"], y["label"]):
                    continue
                ix = max(0, min(x["box"][2], y["box"][2]) - max(x["box"][0], y["box"][0]))
                iy = max(0, min(x["box"][3], y["box"][3]) - max(x["box"][1], y["box"][1]))
                area = [(d["box"][2] - d["box"][0]) * (d["box"][3] - d["box"][1])
                        for d in (x, y)]
                inter = ix * iy
                if inter / max(area[0] + area[1] - inter, 1e-9) >= iou_min:
                    free.remove(y)
                    n += 1
                    break
    return n


def conv_s8_compare(xq, w_q, s_x, s_w, bias, stride: int, act: bool, tile=None):
    """conv_s8 (with the block tile `tile`, None for the wrapper's choice)
    against conv_s8_plain on the same inputs in each of its four output
    types. Returns the largest |kernel - plain| over them; raises,
    after printing the count of differing elements and the largest ulp or
    step, on any difference."""
    import torch

    from cerberusdet_tpu_torch.ops.conv_int8_cuda import conv_s8, conv_s8_plain

    pad = w_q.shape[1] // 2
    plain32 = conv_s8_plain(xq, w_q, s_x, s_w, bias, stride, pad, act, torch.float32)
    q_scale = max(float(plain32.abs().max()), 1e-6) / 127.0
    worst = 0.0
    for dtype in (torch.int32, torch.float32, torch.bfloat16, torch.int8):
        args = (xq, w_q, s_x, s_w, bias, stride, pad, act, dtype, q_scale)
        got, ref = conv_s8(*args, tile=tile), conv_s8_plain(*args)
        torch.cuda.synchronize()
        diff = (got.double() - ref.double()).abs()
        worst = max(worst, float(diff.max()))
        n_diff = int((got != ref).sum())
        if n_diff:
            if dtype.is_floating_point:
                ulp = diff / (torch.finfo(dtype).eps * ref.double().abs().clamp(min=1e-30))
                how = f"largest {float(ulp.max()):.3g} ulp"
            else:
                how = f"largest {float(diff.max()):.0f} steps"
            log(f"[conv_s8 vs plain] {dtype}, tile {tile}: {n_diff} of {got.numel()} elements differ, {how}")
            raise AssertionError(f"conv_s8 disagrees with its plain version in {dtype}")
    return worst


def quant_pack_compare(x, s_x, ci16: int) -> int:
    """quant_pack_s8 against quant_pack_s8_plain on the same activations;
    returns the largest |kernel - plain| (0) or raises."""
    import torch

    from cerberusdet_tpu_torch.ops.conv_int8_cuda import quant_pack_s8, quant_pack_s8_plain

    got, ref = quant_pack_s8(x, s_x, ci16), quant_pack_s8_plain(x, s_x, ci16)
    torch.cuda.synchronize()
    n_diff = int((got != ref).sum())
    if n_diff:
        log(f"[quant_pack_s8 vs plain] {x.dtype} {tuple(x.shape)}: {n_diff} of {got.numel()} "
            f"codes differ")
        raise AssertionError("quant_pack_s8 disagrees with its plain version")
    return int((got.int() - ref.int()).abs().max())


def tensor_core_instructions(lib, kernel: str):
    """(count, how): the int8 tensor-core instructions (IMMA for mma.sync,
    IGMMA for wgmma) in the SASS of the functions of the built library `lib`
    whose names contain `kernel`, by cuobjdump; count None where the toolkit
    has no cuobjdump, and how says so."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None, "no cuobjdump in the toolkit: not checked"
    sass = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and ("IMMA" in line or "IGMMA" in line):
            count += 1
    return count, tool


# quant_pack_s8's edge cases: (name, storage shape, the view the kernel takes)
PACK_EDGE_CASES = [
    ("letterboxed batch 1, 15x20 (bf16 and int8 planes not 16-byte aligned)", (1, 640, 15, 20),
     lambda t: t),
    ("misaligned planes at batch 8, Ci 400, 15x20", (8, 400, 15, 20), lambda t: t),
    ("channel slice at odd offset, 15x20", (2, 161, 15, 20), lambda t: t[:, 1:81]),
    ("channel slice at odd offset, 40x40 (aligned planes)", (8, 321, 40, 40),
     lambda t: t[:, 3:163]),
    ("channels-last, Ci 3, 480x640 at batch 1", (1, 480, 640, 3), lambda t: t.permute(0, 3, 1, 2)),
    ("channels-last, Ci 80, 20x20", (2, 20, 20, 80), lambda t: t.permute(0, 3, 1, 2)),
    ("HW 1, Ci 5", (3, 5, 1, 1), lambda t: t),
]


def serve_int8(inf_bf16, pre, frames, served_bf16, names, card: str, dev):
    """The int8 serving path at full width: check that the conv kernel runs on
    the int8 tensor cores, hold quant_pack_s8 and conv_s8 against their plain
    versions at every distinct quantized-conv shape of a batch-8 request (and
    conv_s8 at edge cases), serve 3 + 3 requests with launch counting,
    compare a request with the plain int8 path and with bf16, and time.
    Returns the kernels-line entries of conv_s8 (its heaviest 3x3 shape and
    its heaviest 1x1 shape) and quant_pack_s8."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from cerberusdet_tpu_torch.infer import CerberusDetInference, CerberusPreprocessor
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.nn.module import quantize_act
    from cerberusdet_tpu_torch.ops import conv_int8_cuda, nms_cuda
    from cerberusdet_tpu_torch.quant import conv_layers
    from cerberusdet_tpu_torch.utils.profiling import pool_mib

    conv_s8, quant_pack_s8 = conv_int8_cuda.conv_s8, conv_int8_cuda.quant_pack_s8
    n_imma, how = tensor_core_instructions(conv_int8_cuda.build(), "conv_s8_kernel")
    log(f"[conv_s8 SASS] int8 tensor-core instructions (IMMA / IGMMA) in conv_s8_kernel: "
        f"{n_imma if n_imma is not None else 'not counted'} ({how})")
    if n_imma == 0:
        raise AssertionError("conv_s8_kernel holds no int8 tensor-core instruction")

    t0 = time.perf_counter()
    model = CerberusModel(FLAGSHIP, TASKS, NCS, device=dev).init(seed=0)
    distinct_heads(model, seed=1)
    inf = CerberusDetInference(model=model, names=names, conf_thres=CONF, img_size=640,
                               dtype=torch.bfloat16, device=dev, int8="all")
    convs = [m for _, m in conv_layers(inf.model)]
    n_q = len(inf.int8_convs)
    if n_q != len(convs):
        raise AssertionError(f"int8='all' quantized {n_q} of {len(convs)} Convs")
    log(f"[int8] yolov8x_2task, bf16 compute, int8='all': {n_q} quantized Convs, noise "
        f"calibration, built in {time.perf_counter() - t0:.2f} s")

    # every distinct quantized-conv shape, on the activations of a batch-8 request
    cases = {}

    def capture(mod, args):
        x = args[0]
        key = (mod.c1, mod.c2, mod.k[0], mod.s[0], x.shape[2], x.shape[3])
        if key not in cases:
            cases[key] = (mod, x)
        ho = (x.shape[2] + 2 * mod.p[0] - mod.k[0]) // mod.s[0] + 1
        wo = (x.shape[3] + 2 * mod.p[1] - mod.k[1]) // mod.s[1] + 1
        macs[0] += x.shape[0] * ho * wo * mod.c2 * mod.c1 * mod.k[0] * mod.k[1]
        pack_bytes[0] += x.numel() * x.element_size() + x.numel() // mod.c1 * mod.w_q.shape[3]

    macs, pack_bytes = [0], [0]
    hooks = [m.register_forward_pre_hook(capture) for m in inf.int8_convs]
    batch8, _ = pre.preprocess(frames[8][0])
    inf.predict_device(batch8, CONF, 0.45, 0.8, False, 300)  # eager: the hooks see one forward
    for h in hooks:
        h.remove()
    fwd_macs = macs[0]
    max_err, pack_err = 0.0, 0
    for key in sorted(cases):
        mod, x = cases[key]
        ci16 = mod.w_q.shape[3]
        for xt in (x, x.float(), quantize_act(x, mod.s_x)):
            pack_err = max(pack_err, quant_pack_compare(xt, mod.s_x, ci16))
        xq = conv_int8_cuda.quant_pack_s8_plain(x, mod.s_x, ci16)
        err = conv_s8_compare(xq, mod.w_q, mod.s_x, mod.s_w, mod.b, mod.s[0], True)
        max_err = max(max_err, err)
    log(f"[quant_pack_s8 vs plain] the inputs of the {len(cases)} distinct quantized convs of "
        f"a batch-8 request (Ci 3 included), in bf16, in float32 and already quantized to "
        f"int8 (packed unscaled): identical")
    s_x = torch.tensor(0.029, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    for name, shape, view in PACK_EDGE_CASES:
        base = torch.randn(shape, generator=gen, device=dev) * 2.5
        for xt in (base.to(torch.bfloat16), base, quantize_act(base, s_x)):
            x = view(xt)
            ci16 = conv_int8_cuda.padded_channels(x.shape[1])
            pack_err = max(pack_err, quant_pack_compare(x, s_x, ci16))
        log(f"[quant_pack_s8 vs plain] edge case {name}: x {tuple(view(base).shape)} strides "
            f"{view(base).stride()}, in bf16, float32 and int8: identical")
    log(f"[conv_s8 vs plain] {len(cases)} distinct (Ci, Co, k, s, H, W) of the flagship's "
        f"quantized convs at batch 8, on a request's activations, in int32 / float32 / "
        f"bf16 / int8: identical (max |diff| {max_err})")
    rng = np.random.default_rng(11)
    edge = []
    for name, ci, co, k, s, b, h, w in [("ragged 13x17, Co 80 against BN", 80, 80, 3, 1, 3, 13, 17),
                                        ("stride 2 on odd H, 1x1 tail", 160, 320, 3, 2, 2, 21, 9),
                                        ("Ci=3 s1", 3, 80, 3, 1, 2, 37, 29),
                                        ("Ci=5 1x1", 5, 24, 1, 1, 1, 7, 11),
                                        ("Ci=400 (16 | Ci, 32 does not)", 400, 80, 3, 1, 3, 9, 12),
                                        ("M below BM: batch 1 at 20x20", 320, 320, 3, 1, 1, 20, 20),
                                        ("stride 2 on odd H=41", 320, 320, 3, 2, 1, 41, 40)]:
        xq = torch.zeros((b, h, w, conv_int8_cuda.padded_channels(ci)), dtype=torch.int8)
        xq[..., :ci] = torch.from_numpy(rng.integers(-127, 128, (b, h, w, ci), dtype=np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (k, k, ci, co), dtype=np.int8))
        edge.append((name, xq.to(dev), wq, s))
    for name, ci, co, k in [("all +-127, 3x3 Ci=640", 640, 320, 3),
                            ("all +-127, 1x1 Ci=2560", 2560, 640, 1)]:
        xq = torch.full((2, 20, 20, ci), 127, dtype=torch.int8, device=dev)
        xq[1] = -127
        wq = torch.full((k, k, ci, co), 127, dtype=torch.int8)
        wq[..., co // 2:] = -127
        edge.append((name, xq, wq, 1))
    for name, xq, wq, s in edge:
        co = wq.shape[3]
        s_x = torch.tensor(1e-3, device=dev)
        s_w = torch.full((co,), 1e-4, device=dev)
        bias = torch.linspace(-2, 2, co, device=dev)
        for tile in (None,) + conv_int8_cuda.TILES:
            err = conv_s8_compare(xq, conv_int8_cuda.pack_weight(wq).to(dev), s_x, s_w, bias, s,
                                  True, tile)
            max_err = max(max_err, err)
        log(f"[conv_s8 vs plain] edge case {name}: x {tuple(xq.shape)}, {co} out, stride "
            f"{s}: identical with the chosen tile and with each of {conv_int8_cuda.TILES}")
    del edge

    # the main path: 3 requests at batch 1 and 3 at batch 8, after the first
    # request of each batch size has captured its program
    first_requests(inf, pre, frames, "int8", card)
    programs = dict(inf.programs)
    torch.cuda.synchronize()
    conv_s8.launches = 0
    quant_pack_s8.launches = 0
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
    launches = conv_s8.launches
    pack_launches = quant_pack_s8.launches
    nms_launches = nms_cuda.greedy_nms_cuda.launches
    n_requests = len(served)
    log(f"[int8] {n_requests} requests, quant_pack_s8 launches {pack_launches}, conv_s8 "
        f"launches {launches} (expected {n_q} quantized Convs x {n_requests} each), NMS "
        f"launches {nms_launches}")
    if launches != n_q * n_requests or pack_launches != n_q * n_requests \
            or nms_launches != len(TASKS) * n_requests:
        raise AssertionError("the int8 path did not launch quant_pack_s8 and conv_s8 once per "
                             "quantized Conv and request, or NMS once per task and request")
    if inf.programs != programs or sum(p.replays for p in programs.values()) != n_requests + 2:
        raise AssertionError("the int8 requests did not replay the graphs captured by the first "
                             "request of each batch size")
    for bs, times in per_bs.items():
        ms = 1e3 * float(np.median(times))
        log(f"[int8] batch {bs}: {ms:.2f} ms/request (median of {len(times)}, preprocess + "
            f"predict, host clock), {bs / ms * 1e3:.1f} img/s  [{card}]")
    for batch, shapes, out in served:
        assert len(out) == batch.shape[0]
        for task in TASKS:
            assert sum(d["task"] == task for r in out for d in r) > 0, f"int8: no {task}"
        for r in out:
            for d in r:
                assert np.isfinite(d["score"]) and 0 < d["score"] <= 1
                assert all(np.isfinite(v) for v in d["box"])
    n_det = sum(len(r) for _, _, out in served for r in out)
    n_bf16 = sum(len(r) for _, _, out in served_bf16 for r in out)
    n_match = sum(matched_detections(out, ref[2])
                  for (_, _, out), ref in zip(served, served_bf16))
    log(f"[int8] {n_det} detections in {n_requests} requests, both tasks present; against "
        f"bf16 on the same frames ({n_bf16} detections): {n_match} matched (same task and "
        f"label, IoU >= 0.5)")

    batch, shapes, _ = served[-1]
    out = inf.predict(batch, original_shape=shapes)
    plain = inf.predict(batch, original_shape=shapes, use_kernel=False)
    same_results(out, plain, score_rtol=0.0)
    log("[int8] batch 8 with the plain int8 convs and the plain NMS loop on the card: "
        "identical results")
    boxed, boxed_shapes = CerberusPreprocessor(img_size=640, auto=True, device=dev).preprocess(
        frames[1][0])
    out = inf.predict(boxed, original_shape=boxed_shapes)
    plain = inf.predict(boxed, original_shape=boxed_shapes, use_kernel=False)
    same_results(out, plain, score_rtol=0.0)
    log(f"[int8] a letterboxed batch-1 frame, input {tuple(boxed.shape[1:3])} (maps down to "
        f"{boxed.shape[1] // 32}x{boxed.shape[2] // 32}), with the plain int8 convs and NMS: "
        f"identical results ({sum(map(len, out))} detections)")

    args = (CONF, 0.45, 0.8, False, 300)
    for bs in (1, 8):
        for imgs in frames[bs][:2]:  # the capturing request, then other frames
            replay_matches_eager(inf, pre.preprocess(imgs)[0], args)
    keys = {inf.program_key(torch.zeros(shape), *args)
            for shape in [(1, 640, 640, 3), (8, 640, 640, 3), tuple(boxed.shape)]}
    if set(inf.programs) != keys or any(inf.programs[k] is not p for k, p in programs.items()):
        raise AssertionError(f"int8: {len(inf.programs)} programs for {len(keys)} keys")
    log(f"[graphs] int8: replayed == predict_device run eagerly, bit for bit, at batch 1 and "
        f"8, for the capturing request and one with other frames; {len(inf.programs)} "
        f"captures for {len(keys)} distinct keys (the letterboxed frame's included); graph "
        f"pool {pool_mib(inf._pool):.1f} MiB  [{card}]")
    for bs in (1, 8):
        graph_timings(inf, pre.preprocess(frames[bs][0])[0], args, card, "int8")

    # the forward in int8 beside bf16, and the kernels' share of it (the
    # bounds scale the batch-8 request's work: both batches are 640x640)
    for bs in (1, 8):
        bt, _ = pre.preprocess(frames[bs][0])
        x = bt.permute(0, 3, 1, 2).to(torch.bfloat16)
        before = (conv_s8.launches, quant_pack_s8.launches)
        ms8 = cuda_ms(lambda: inf.model(x), iters=3)
        if (conv_s8.launches - before[0], quant_pack_s8.launches - before[1]) \
                != (5 * n_q, 5 * n_q):  # 2 warm-up + 3 timed
            raise AssertionError("the timed int8 forward did not run through both kernels")
        ms16 = cuda_ms(lambda: inf_bf16.model(x), iters=3)
        log(f"[int8 stages] batch {bs}: int8 forward {ms8:.3f} ms, bf16 forward {ms16:.3f} ms, "
            f"int8 / bf16 {ms8 / ms16:.2f} (CUDA events, 3 calls)  [{card}]")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            inf.model(x)
            torch.cuda.synchronize()
        ev = prof.key_averages()
        all_us = sum(e.device_time_total for e in ev)
        share = {}
        for kern in ("conv_s8_kernel", "quant_pack"):
            us = sum(e.device_time_total for e in ev if kern in e.key)
            share[kern] = (us, sum(e.count for e in ev if kern in e.key))
        (conv_us, conv_n), (pack_us, pack_n) = share["conv_s8_kernel"], share["quant_pack"]
        log(f"[int8 stages] batch {bs} forward: {fwd_macs * bs / 8 / 1e12:.4f} TMAC in {n_q} "
            f"quantized convs; profiler: conv_s8 {conv_us / 1e3:.3f} ms in {conv_n} launches "
            f"(bound {2 * fwd_macs * bs / 8 / INT8_OPS_PER_S * 1e3:.3f} ms), quant_pack_s8 "
            f"{pack_us / 1e3:.3f} ms in {pack_n} launches (bound "
            f"{pack_bytes[0] * bs / 8 / HBM_BYTES_PER_S * 1e3:.3f} ms), of {all_us / 1e3:.3f} ms "
            f"device time (conv_s8 {100 * conv_us / max(all_us, 1e-9):.1f}%, quant_pack_s8 "
            f"{100 * pack_us / max(all_us, 1e-9):.1f}%), of a {ms8:.3f} ms forward (events)  "
            f"[{card}]")

    # the kernels alone at the path's most expensive shapes (MACs a launch; on
    # the flagship the Detect cls tower's 3x3 320->320 at 80x80 and the 1x1
    # 2560->640 at 40x40)
    def launch_macs(key):
        ci, co, k, s, h, w = key
        return ((h + 2 * (k // 2) - k) // s + 1) * ((w + 2 * (k // 2) - k) // s + 1) \
            * co * ci * k * k

    entries = []
    for kk in (3, 1):
        key = max((c for c in cases if c[2] == kk), key=lambda c: (launch_macs(c), c[0]))
        mod, x = cases[key]
        b, (ci, co, k, s, h, w) = x.shape[0], key
        xq = quant_pack_s8(x, mod.s_x, mod.w_q.shape[3])
        out_dtype = torch.bfloat16 if k == 3 else torch.int32
        call = (xq, mod.w_q, mod.s_x, mod.s_w, mod.b, s, k // 2, True, out_dtype)
        k_ms, how = kernel_ms(lambda: conv_s8(*call), 10, "conv_s8_kernel")
        p_ms = cuda_ms(lambda: conv_int8_cuda.conv_s8_plain(*call), iters=3, warmup=1)
        kmacs = b * launch_macs(key)
        out_elems = kmacs // (ci * k * k)
        nbytes = xq.numel() + mod.w_q.numel() + 12 * co + out_dtype.itemsize * out_elems
        ops_ms = 2 * kmacs / INT8_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if k == 3:
            xb = x.to(torch.bfloat16).contiguous()
            wb = conv_int8_cuda.unpack_weight(mod.w_q, ci).permute(3, 2, 0, 1).to(
                torch.bfloat16).contiguous()
            lib_ms = None  # no PyTorch call computes an int8 3x3 convolution
            ctx = cuda_ms(lambda: F.conv2d(xb, wb, None, s, k // 2), iters=10)
            extra = (f"for context, a different function: cuDNN's bf16 conv of the same "
                     f"shape {ctx:.4f} ms")
        else:  # a 1x1 conv's int32 sums are one int8 matrix product: (M, Ci16) x (Ci16, Co)
            a2 = xq.reshape(-1, xq.shape[3])
            b2 = mod.w_q.reshape(co, -1).t()
            if not torch.equal(torch._int_mm(a2, b2).reshape(b, h, w, co).permute(0, 3, 1, 2),
                               conv_s8(*call)):
                raise AssertionError("torch._int_mm disagrees with conv_s8's int32 sums")
            lib_ms = cuda_ms(lambda: torch._int_mm(a2, b2), iters=10)
            extra = (f"torch._int_mm (cuBLASLt, NHWC out) of the same sums {lib_ms:.4f} ms, "
                     f"identical")
        log(f"[conv_s8 at main-path shapes] {k}x{k} s{s} {ci}->{co} at {h}x{w}, batch {b}, "
            f"{str(out_dtype).split('.')[-1]} out, tile "
            f"{conv_int8_cuda.conv_tile(out_elems // co, co, torch.cuda.get_device_properties(dev).multi_processor_count)}: "
            f"kernel {k_ms:.4f} ms ({how}), {kmacs / k_ms / 1e9:.2f} TMAC/s, bound "
            f"{max(ops_ms, bytes_ms):.4f} ms ({100 * max(ops_ms, bytes_ms) / k_ms:.1f}%); plain "
            f"(float64 conv + epilogue) {p_ms:.3f} ms; {extra}  [{card}]")
        entries.append({
            "name": "conv_s8" if k == 3 else "conv_s8 (1x1, int32 out)",
            "route": "cuda",
            "source": "cerberusdet_tpu_torch/csrc/conv_int8.cu",
            "replaces": "cerberusdet_tpu/ops/conv_int8_pallas.py:65",
            "shape": f"{k}x{k} s{s} {ci}->{co} at {h}x{w}, batch {b}",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms,
        })

    # quant_pack_s8 alone at the path's largest input (bf16 in, int8 out)
    key = max(cases, key=lambda c: cases[c][1].numel())
    mod, x = cases[key]
    ci16 = mod.w_q.shape[3]
    q_ms, how = kernel_ms(lambda: quant_pack_s8(x, mod.s_x, ci16), 20, "quant_pack")
    qp_ms = cuda_ms(lambda: conv_int8_cuda.quant_pack_s8_plain(x, mod.s_x, ci16), iters=5)
    q_bytes = x.numel() * x.element_size() + x.numel() // x.shape[1] * ci16
    q_bound = q_bytes / HBM_BYTES_PER_S * 1e3
    y = torch.empty_like(x)
    copy_ms = cuda_ms(lambda: y.copy_(x), iters=20)
    del y
    log(f"[quant_pack_s8 at main-path shapes] x {tuple(x.shape)} bf16 -> (B, H, W, {ci16}) "
        f"int8: kernel {q_ms:.4f} ms ({how}), {q_bytes / q_ms / 1e6:.1f} GB/s, bound "
        f"{q_bound:.4f} ms ({100 * q_bound / q_ms:.1f}%); plain {qp_ms:.3f} ms; for context, "
        f"a plain copy of x (torch.empty_like(x).copy_(x), {2 * x.numel() * x.element_size() / 1e6:.1f} "
        f"MB moved) {copy_ms:.4f} ms by events, {2 * x.numel() * x.element_size() / copy_ms / 1e6:.1f} "
        f"GB/s  [{card}]")
    entries.append({
        "name": "quant_pack_s8",
        "route": "cuda",
        "source": "cerberusdet_tpu_torch/csrc/conv_int8.cu",
        "replaces": "cerberusdet_tpu/nn/module.py:162 (quantize_act, no Pallas kernel; part "
                    "of conv_s8's redesign)",
        "shape": f"{tuple(x.shape)} bf16",
        "launches": pack_launches,
        "max_abs_err": pack_err,
        "ms": q_ms,
        "plain_ms": qp_ms,
        "bound_ms": q_bound,
        "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call quantizes, transposes and pads in one
    })
    conv_s8.launches = launches  # the comparison and timing launches do not count
    quant_pack_s8.launches = pack_launches
    return entries



# the val phase: native (w, h) sizes of the seeded val images; at imgsz 640,
# batch 32 and pad 0.5 each task's 96 images sort into 3 rect batches,
# (512, 672), (672, 672) and (672, 512), wider or taller than 640
VAL_SIZES = [(500, 375), (375, 500), (640, 480), (1280, 720), (333, 500)]
VAL_IMAGES, VAL_BATCH = 96, 32
LABEL_CONF = 0.25  # detections at or above it become the val set's labels


def val_stats(out):
    """run_task's accumulated (tp, conf, pred_cls, target_cls), concatenated."""
    import numpy as np

    return [np.concatenate(x, 0) for x in zip(*out["metrics"].stats)]


def same_val(a, b, what: str) -> None:
    """Identical val statistics and results, or raise."""
    import numpy as np

    sa, sb = val_stats(a), val_stats(b)
    if any(x.shape != y.shape or not np.array_equal(x, y) for x, y in zip(sa, sb)) \
            or a["results"] != b["results"] or a["seen"] != b["seen"]:
        raise AssertionError(f"{what}: the val statistics or results differ")


def recall50(out) -> float:
    """The share of labels matched at IoU 0.5 by a detection of their class."""
    tp, _, _, target = val_stats(out)
    return float(tp[:, 0].sum()) / max(len(target), 1)


def val_batch_convs(model, x, task, checked, calls):
    """One forward of the int8 `model`'s `task` branch (all heads for task
    None) on x, holding
    quant_pack_s8 and conv_s8 against their plain versions at each quantized
    conv's input whose (B, Ci, Co, k, s, H, W) is not in `checked` yet, as
    conv2d_int8 calls them there (raising on any difference);
    checked[shape] takes the plain versions' times (conv, pack) by CUDA
    events, the largest |kernel - plain| of each (conv, pack), and the
    kernels' times (conv, pack), each the mean of 5 launches by CUDA
    events; calls[shape] counts the shape's calls in this forward. The
    comparisons' and timings' launches are taken back."""
    import torch

    from cerberusdet_tpu_torch.nn.layers import Conv
    from cerberusdet_tpu_torch.ops import conv_int8_cuda as ci

    before = (ci.conv_s8.launches, ci.quant_pack_s8.launches)

    def hook(mod, args):
        x = args[0]
        key = (x.shape[0], mod.c1, mod.c2, mod.k[0], mod.s[0], x.shape[2], x.shape[3])
        calls[key] = calls.get(key, 0) + 1
        if key in checked:
            return
        ci16 = mod.w_q.shape[3]
        q_plain = ci.quant_pack_s8_plain(x, mod.s_x, ci16)
        q_kernel = ci.quant_pack_s8(x, mod.s_x, ci16)
        pack_err = int((q_kernel.int() - q_plain.int()).abs().max())
        if pack_err:
            raise AssertionError(f"quant_pack_s8 differs from its plain version at {key}")
        out = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
        conv = (q_plain, mod.w_q, mod.s_x, mod.s_w, mod.b, mod.s[0], mod.p[0], bool(mod.act),
                out)
        got = ci.conv_s8(*conv)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = ci.conv_s8_plain(*conv)
        mid = torch.cuda.Event(enable_timing=True)
        mid.record()
        ci.quant_pack_s8_plain(x, mod.s_x, ci16)
        end.record()
        torch.cuda.synchronize()
        conv_err = float((got.double() - want.double()).abs().max())
        if conv_err or not torch.equal(got, want):
            raise AssertionError(f"conv_s8 differs from its plain version at {key}")
        checked[key] = (start.elapsed_time(mid), mid.elapsed_time(end), conv_err, pack_err,
                        cuda_ms(lambda: ci.conv_s8(*conv), iters=5),
                        cuda_ms(lambda: ci.quant_pack_s8(x, mod.s_x, ci16), iters=5))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, Conv) and m.int8]
    try:
        model(x, tasks=None if task is None else [task])
    finally:
        for h in hooks:
            h.remove()
    ci.conv_s8.launches, ci.quant_pack_s8.launches = before


def conv_totals(checked, calls):
    """Sums over one forward's int8 convs, from val_batch_convs's records:
    (conv_s8 ms, quant_pack_s8 ms, their plain versions' ms, conv bound ms,
    pack bound ms, launches of each kernel, largest |kernel - plain| of
    each). Kernel and plain times are each shape's mean by CUDA events
    times the shape's calls; the bounds are the MACs at the int8 tensor-core
    rate and the bytes read and written at HBM's rate."""
    from cerberusdet_tpu_torch.ops.conv_int8_cuda import padded_channels

    k_conv = sum(checked[k][4] * n for k, n in calls.items())
    k_pack = sum(checked[k][5] * n for k, n in calls.items())
    p_conv = sum(checked[k][0] * n for k, n in calls.items())
    p_pack = sum(checked[k][1] * n for k, n in calls.items())
    macs = sum(n * b * co * ci * k * k * ((h + 2 * (k // 2) - k) // s + 1)
               * ((w + 2 * (k // 2) - k) // s + 1)
               for (b, ci, co, k, s, h, w), n in calls.items())
    pack_bytes = sum(n * b * h * w * (2 * ci + padded_channels(ci))
                     for (b, ci, co, k, s, h, w), n in calls.items())
    return (k_conv, k_pack, p_conv, p_pack, 2 * macs / INT8_OPS_PER_S * 1e3,
            pack_bytes / HBM_BYTES_PER_S * 1e3, sum(calls.values()),
            max(c[2] for c in checked.values()), max(c[3] for c in checked.values()))


def validate(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640,
             n_images: int = VAL_IMAGES, batch: int = VAL_BATCH, workers: int = 8):
    """The validation path at full width: a seeded 2-task val set on disk,
    labelled with the seeded model's own bf16 detections at conf >= 0.25,
    evaluated by the entry point's main (cli/val.py) in float32, bf16 and
    bf16 + int8 'all', with its gates (recall 1.0 in bf16, NMS kernel and
    int8 kernels against their plain versions over whole val runs and at
    every quantized conv shape of each rect batch, launch counts). Returns
    the kernels-line entries of the val path."""
    import argparse
    import tempfile

    import numpy as np
    import torch
    import yaml

    from cerberusdet_tpu_torch.cli import val as cli
    from cerberusdet_tpu_torch.data.loaders import create_dataloader
    from cerberusdet_tpu_torch.evaluation.val import run_task
    from cerberusdet_tpu_torch.manager.checkpoint import save_checkpoint
    from cerberusdet_tpu_torch.manager.run_manager import parse_data_config
    from cerberusdet_tpu_torch.manager.weights import export_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.nn.layers import Conv
    from cerberusdet_tpu_torch.ops import conv_int8_cuda, nms_cuda
    from cerberusdet_tpu_torch.ops.nms import select_candidates
    from cerberusdet_tpu_torch.quant.ptq import fused_conv_weights
    from cerberusdet_tpu_torch.testing import calibrate_bn, write_labels, write_val_set

    conv_s8, quant_pack_s8 = conv_int8_cuda.conv_s8, conv_int8_cuda.quant_pack_s8
    nms = nms_cuda.greedy_nms_cuda
    saved = (nms.launches, conv_s8.launches, quant_pack_s8.launches)
    names = {t: [f"{t}_{i}" for i in range(n)] for t, n in zip(TASKS, NCS)}
    root = tempfile.mkdtemp(prefix="cerberus_val_")
    try:
        # ---- the val set, the seeded model and its checkpoint
        t0 = time.perf_counter()
        dirs = {t: write_val_set(os.path.join(root, t), n_images, VAL_SIZES, seed=20 + i)
                for i, t in enumerate(TASKS)}
        data_yaml = os.path.join(root, "data.yaml")
        with open(data_yaml, "w") as f:
            yaml.safe_dump({"task_ids": TASKS, "nc": NCS, "names": [names[t] for t in TASKS],
                            "train": [dirs[t] for t in TASKS],
                            "val": [dirs[t] for t in TASKS]}, f)
        model = CerberusModel(cfg, TASKS, NCS, device=dev).init(seed=0)
        distinct_heads(model, seed=1)
        calib, _ = create_dataloader(dirs[TASKS[0]], imgsz, 8, task="bn", cache_dir=root)
        x = torch.from_numpy(np.stack([calib[i][0] for i in range(8)])).to(dev)
        calibrate_bn(model, x.permute(0, 3, 1, 2).float() / 255.0)
        ckpt = os.path.join(root, "seeded.ckpt.npz")
        save_checkpoint(ckpt, export_jax_params(model), {
            "cfg": cfg, "task_ids": TASKS, "nc": NCS, "names": [names[t] for t in TASKS]},
            half=False)
        del model, x, calib
        log(f"[val] {n_images} JPEGs a task at native sizes {VAL_SIZES}, the seeded "
            f"{os.path.basename(cfg)} (BatchNorm statistics from 8 of them) saved as a "
            f".ckpt.npz, in {time.perf_counter() - t0:.2f} s")

        def loaders():
            return {t: create_dataloader(dirs[t], imgsz, batch, rect=True, pad=0.5,
                                         classnames=names[t], task=f"{t}_val",
                                         num_threads=workers)[1] for t in TASKS}

        # ---- labels: the seeded model's own bf16 detections at conf >= 0.25
        bf16 = cli.load_model_for_eval(ckpt, "", dev).to(torch.bfloat16)
        n_labels = {}
        for ti, (task, loader) in enumerate(loaders().items()):
            dets = run_task(bf16, task, loader, NCS[ti], return_dets=True)["dets"]
            keep = {p: d[d[:, 4] >= LABEL_CONF] for p, d in dets.items()}
            n_labels[task] = write_labels(keep)
            per_image = [len(d) for d in keep.values()]
            log(f"[val] {task}: {n_labels[task]} labels from bf16 detections at conf >= "
                f"{LABEL_CONF} ({sum(n > 0 for n in per_image)} of {len(per_image)} images "
                f"have some, at most {max(per_image)})")
            if not n_labels[task]:
                raise AssertionError(f"{task}: the seeded model detects nothing at conf >= "
                                     f"{LABEL_CONF}")
        for t in TASKS:  # the labels changed: drop the label caches
            for f in os.listdir(os.path.join(root, t, "labels", "val")):
                if f.endswith(".cache.npy"):
                    os.remove(os.path.join(root, t, "labels", "val", f))
        shapes = {t: sorted({tuple(int(v) for v in s) for s in loader.dataset.batch_shapes})
                  for t, loader in loaders().items()}
        log(f"[val] rect letterbox shapes (h, w) per task at batch {batch}, pad 0.5: {shapes}")

        # ---- the entry point's main, three times
        common = ["--weights", ckpt, "--data", data_yaml, "--device", str(dev), "--imgsz",
                  str(imgsz), "--batch-size", str(batch), "--project",
                  os.path.join(root, "runs"), "--exist-ok", "--workers", str(workers)]
        n_batches = {t: len(loader) for t, loader in loaders().items()}
        runs = {}
        for label, extra in (("float32", []), ("bf16", ["--bf16"]),
                             ("int8", ["--bf16", "--int8", "all"])):
            torch.cuda.synchronize()
            nms.launches = conv_s8.launches = quant_pack_s8.launches = 0
            t = time.perf_counter()
            out = cli.main(common + extra)
            wall = time.perf_counter() - t
            launches = (nms.launches, conv_s8.launches, quant_pack_s8.launches)
            runs[label] = (out, wall, launches)
            want = sum(n_batches.values())
            log(f"[val {label}] main: {wall:.2f} s for {sum(o['seen'] for o in out.values())} "
                f"images; NMS launches {launches[0]} (expected {want}: one per batch and "
                f"task), conv_s8 {launches[1]}, quant_pack_s8 {launches[2]}  [{card}]")
            if launches[0] != want:
                raise AssertionError(f"{label} val: NMS launched {launches[0]} times, not once "
                                     f"per batch and task ({want})")
            stage_s = 0.0
            for task, o in out.items():
                mp, mr, map50, mAP = o["results"][:4]
                pre, inf, nms_t = o["speed"]
                stage_s += sum(sum(x[1:]) for x in o["times"])
                log(f"[val {label}] {task}: P {mp:.4f} R {mr:.4f} mAP50 {map50:.4f} mAP "
                    f"{mAP:.4f}; speed (ms per image) preprocess {pre:.3f}, inference {inf:.3f}, "
                    f"NMS {nms_t:.3f}; per batch (h, w): (preprocess, inference, NMS) ms "
                    + ", ".join(f"{s}: ({1e3 * a:.1f}, {1e3 * b:.1f}, {1e3 * c:.1f})"
                                for s, a, b, c in o["times"]) + f"  [{card}]")
            log(f"[val {label}] wall {wall:.2f} s: the three timed stages {stage_s:.2f} s "
                f"({100 * stage_s / wall:.1f}%), the rest (decode waits, matching and AP on "
                f"the host, model load{', quantization' if label == 'int8' else ''}) "
                f"{wall - stage_s:.2f} s  [{card}]")
        for task in TASKS:
            r = recall50(runs["bf16"][0][task])
            log(f"[val bf16] {task}: recall at IoU 0.5 {r:.4f} of {n_labels[task]} labels "
                f"(the labels are the same model's bf16 detections)")
            if r != 1.0:
                raise AssertionError(f"{task}: bf16 val re-found {r:.4f} of the labels, not all: "
                                     "the letterbox -> native chain loses boxes")
            log(f"[val] {task}: int8 mAP50 {runs['int8'][0][task]['results'][2]:.4f}, mAP "
                f"{runs['int8'][0][task]['results'][3]:.4f}; float32 "
                f"{runs['float32'][0][task]['results'][2]:.4f}, "
                f"{runs['float32'][0][task]['results'][3]:.4f}; against the bf16-derived labels "
                f"(seeded weights, synthetic images)")

        # ---- the NMS kernel against the plain loop over the whole bf16 val
        for ti, (task, loader) in enumerate(loaders().items()):
            t = time.perf_counter()
            a = run_task(bf16, task, loader, NCS[ti])
            rt_wall = time.perf_counter() - t
            rt_stages = sum(sum(x[1:]) for x in a["times"])
            log(f"[val bf16] {task}: run_task alone {rt_wall:.3f} s, of which the three timed "
                f"stages {rt_stages:.3f} s ({100 * rt_stages / rt_wall:.1f}%); the rest is the "
                f"host's (waits for decode, matching and AP)  [{card}]")
            b = run_task(bf16, task, loader, NCS[ti], use_kernel=False, max_nms=nms_cuda.MAX_K)
            same_val(a, b, f"{task}: NMS kernel against the plain loop")
            same_val(a, runs["bf16"][0][task], f"{task}: this bf16 model against main's")
            log(f"[val bf16] {task}: run_task with the NMS kernel and with the plain loop "
                f"(use_kernel=False, max_nms {nms_cuda.MAX_K}): identical stats and results "
                f"({len(val_stats(a)[0])} detections), identical to main's bf16 run")
        nms.launches = 0

        # ---- the int8 kernels against their plain versions
        opt = argparse.Namespace(imgsz=imgsz, batch_size=batch, workers=workers, int8="all")
        m8 = cli.load_model_for_eval(ckpt, "", dev)
        fused = fused_conv_weights(m8)
        m8.to(torch.bfloat16)
        cli.quantize_for_eval(m8, parse_data_config(data_yaml, check=True), opt,
                              torch.bfloat16, fused)
        del fused
        per_task = {t: sum(1 for st in m8.plan([t]) for m in m8.block(st.uid).modules()
                           if isinstance(m, Conv) and m.int8) for t in TASKS}
        want = sum(per_task[t] * n_batches[t] for t in TASKS)
        if runs["int8"][2][1:] != (want, want):
            raise AssertionError(f"int8 val launched conv_s8 / quant_pack_s8 "
                                 f"{runs['int8'][2][1:]} times, not once per quantized Conv of "
                                 f"each batch's task ({want})")
        log(f"[val int8] main launched conv_s8 and quant_pack_s8 {want} times each: one per "
            f"quantized Conv of each batch's branch ({per_task} a forward)")
        for ti, (task, loader) in enumerate(loaders().items()):
            a = run_task(m8, task, loader, NCS[ti])
            b = run_task(m8, task, loader, NCS[ti], use_kernel=False, max_nms=nms_cuda.MAX_K)
            same_val(a, b, f"{task}: int8 kernels against their plain versions")
            same_val(a, runs["int8"][0][task], f"{task}: this int8 model against main's")
            log(f"[val int8] {task}: with conv_s8 / quant_pack_s8 and with their plain versions "
                f"(use_kernel=False, max_nms {nms_cuda.MAX_K}): identical stats and results "
                f"({len(val_stats(a)[0])} detections), identical to main's int8 run")
        checked, calls_by_shape = {}, {}
        for ti, (task, loader) in enumerate(loaders().items()):
            for bt in loader:
                xb = (torch.from_numpy(bt["img"]).to(dev).permute(0, 3, 1, 2).float()
                      / 255.0).to(torch.bfloat16)
                calls = {}
                val_batch_convs(m8, xb, task, checked, calls)
                calls_by_shape[(task, xb.shape[2], xb.shape[3])] = (xb, calls)
        log(f"[val int8] quant_pack_s8 and conv_s8 identical to their plain versions at "
            f"{len(checked)} distinct (B, Ci, Co, k, s, H, W) of the quantized convs of every "
            f"rect batch of both tasks")

        # ---- timings at val traffic
        task = TASKS[0]
        big = max((k for k in calls_by_shape if k[0] == task), key=lambda k: k[1] * k[2])
        xb, calls = calls_by_shape[big]
        # every launch of the batch's forward, each at its shape's mean time
        (k_conv, k_pack, conv_plain, pack_plain, conv_bound, pack_bound, n_calls, _,
         _) = conv_totals(checked, calls)
        log(f"[val int8] one {task} batch {tuple(xb.shape)}: conv_s8 {k_conv:.3f} ms summed over "
            f"its {n_calls} launches ({len(calls)} shapes, each at the mean of 5 launches by "
            f"CUDA events), bound {conv_bound:.3f} ms "
            f"({conv_bound * INT8_OPS_PER_S / 1e15:.3f} T int8 ops), plain "
            f"{conv_plain:.1f} ms; quant_pack_s8 {k_pack:.3f} ms summed alike, bound "
            f"{pack_bound:.3f} ms, plain {pack_plain:.1f} ms  [{card}]")

        # the NMS kernel on each bf16 val batch's candidates: picks against the
        # plain loop, time a launch, and the work its inputs need
        nms_err, per_batch = 0, []
        for ti, (tk, loader) in enumerate(loaders().items()):
            for bt in loader:
                xv = (torch.from_numpy(bt["img"]).to(dev).permute(0, 3, 1, 2).float()
                      / 255.0).to(torch.bfloat16)
                pred = bf16(xv, tasks=[tk])[tk][0]
                _, conf, _, offset_boxes = select_candidates(pred, NCS[ti], 0.001, True, None,
                                                             nms_cuda.MAX_K, False)
                positives = (conf > 0).sum(1)
                idx_k, val_k = nms(offset_boxes, conf, 0.6, 300)
                idx_p, val_p = nms_cuda.greedy_nms(offset_boxes, conf, 0.6, 300)
                err = max(int((idx_k.long() - idx_p.long()).abs().max()),
                          int((val_k.long() - val_p.long()).abs().max()))
                if err:
                    raise AssertionError(f"{tk}: the NMS kernel disagrees with the plain loop "
                                         "at val traffic")
                nms_err = max(nms_err, err)
                k_ms, how = kernel_ms(lambda: nms(offset_boxes, conf, 0.6, 300), 10,
                                      "nms_kernel")
                p_ms = cuda_ms(lambda: nms_cuda.greedy_nms(offset_boxes, conf, 0.6, 300),
                               iters=1, warmup=1)
                cand_ms = cuda_ms(lambda: select_candidates(
                    pred, NCS[ti], 0.001, True, None, nms_cuda.MAX_K, False), iters=3)
                ops, steps = nms_work(offset_boxes, conf, 0.6, 300)
                b, k = conf.shape
                nbytes = b * k * (16 + 4) + b * 300 * (4 + 1)
                per_batch.append((k_ms, p_ms, nbytes / HBM_BYTES_PER_S * 1e3,
                                  ops / FP32_OPS_PER_S * 1e3))
                log(f"[nms at val traffic] {tk} batch of {tuple(xv.shape[2:])}: B,K={b, k}, "
                    f"positive candidates per image {int(positives.min())}-"
                    f"{int(positives.max())}, mean {float(positives.float().mean()):.0f} "
                    f"(shared memory holds 10240), steps per image {min(steps)}-{max(steps)}: "
                    f"picks identical with the plain loop; kernel {k_ms:.4f} ms a launch "
                    f"({how}), plain {p_ms:.2f} ms, bound {max(per_batch[-1][2:]):.5f} ms; "
                    f"the candidates (stable sort of {b} x {pred.shape[1] * NCS[ti]} scores) "
                    f"{cand_ms:.3f} ms (events)  [{card}]")
        nms_k, nms_plain, nms_bytes_ms, nms_ops_ms = (float(np.mean(v)) for v in zip(*per_batch))
        nms_bound = max(nms_bytes_ms, nms_ops_ms)
        log(f"[nms at val traffic] mean over the {len(per_batch)} bf16 val batches: kernel "
            f"{nms_k:.4f} ms a launch, plain {nms_plain:.2f} ms, bound {nms_bound:.5f} ms  "
            f"[{card}]")
        launches = {"nms": runs["bf16"][2][0], "conv": runs["int8"][2][1],
                    "pack": runs["int8"][2][2]}
        return [{
            "name": "nms (val: multi-label, conf 0.001, K 16384, B 32; mean over the batches)",
            "route": "cuda",
            "source": "cerberusdet_tpu_torch/csrc/nms.cu",
            "replaces": "cerberusdet_tpu/ops/nms_pallas.py:34",
            "launches": launches["nms"],
            "max_abs_err": nms_err,
            "ms": nms_k,
            "plain_ms": nms_plain,
            "bound_ms": nms_bound,
            "bound_by": "bytes" if nms_bytes_ms >= nms_ops_ms else "operations",
            "library_ms": None,
        }, {
            "name": f"conv_s8 (val: one batch {tuple(xb.shape)}, all {n_calls} launches summed)",
            "route": "cuda",
            "source": "cerberusdet_tpu_torch/csrc/conv_int8.cu",
            "replaces": "cerberusdet_tpu/ops/conv_int8_pallas.py:65",
            "launches": launches["conv"],
            "max_abs_err": max(c[2] for c in checked.values()),
            "ms": k_conv,
            "plain_ms": conv_plain,
            "bound_ms": conv_bound,
            "bound_by": "operations",
            "library_ms": None,
        }, {
            "name": f"quant_pack_s8 (val: one batch {tuple(xb.shape)}, all {n_calls} launches "
                    "summed)",
            "route": "cuda",
            "source": "cerberusdet_tpu_torch/csrc/conv_int8.cu",
            "replaces": "cerberusdet_tpu/nn/module.py:162 (quantize_act, no Pallas kernel; "
                        "part of conv_s8's redesign)",
            "launches": launches["pack"],
            "max_abs_err": max(c[3] for c in checked.values()),
            "ms": k_pack,
            "plain_ms": pack_plain,
            "bound_ms": pack_bound,
            "bound_by": "bytes",
            "library_ms": None,
        }]
    finally:
        shutil.rmtree(root, ignore_errors=True)
        nms.launches, conv_s8.launches, quant_pack_s8.launches = saved

# the train entry point's cell: JPEGs a task, cut from VOC's 16551 train and
# 4952 test images to fit the script's time limit
TRAIN_CLI_TRAIN, TRAIN_CLI_VAL, TRAIN_CLI_BATCH = 48, 16, 8
PROFILED_STEPS = 3
PAPER_HYP = os.path.join(ROOT, "configs", "hyps", "hyp.cerber-voc_obj365.yaml")


def batch_digest(batch) -> str:
    """A hash of a step's `img` and `bboxes` for one task."""
    import hashlib

    import numpy as np

    h = hashlib.sha1(np.ascontiguousarray(batch["img"]).tobytes())
    h.update(np.ascontiguousarray(batch["bboxes"]).tobytes())
    return h.hexdigest()


def train_cli(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640,
              n_train: int = TRAIN_CLI_TRAIN, n_val: int = TRAIN_CLI_VAL,
              batch: int = TRAIN_CLI_BATCH, workers=None):
    """The train entry point (cli/train.py:main) at full width: the seeded
    flagship (BatchNorm statistics from 8 train images) as --weights, per-task
    augmented loaders over seeded labelled JPEGs with the paper's hyps (mosaic
    1.0, mixup 0.285), --bf16, per-task batch 8. Run A: 2 epochs from a
    fresh build of the native decoder; run R: A resumed with its opt.yaml's
    epochs raised to 3; run B: a fresh 3-epoch run with --nosave --noval, its
    steps synchronised and timed. Gates: the TAL kernels launch once per task
    and step (and per val batch and task where the val computes losses), the
    NMS kernel once per val batch and task; A's first step with the plain
    assigner gives the kernels' losses (rtol 1e-5); B's steps get A's and
    R's batches (hashes of img and bboxes); R starts from the saved params
    exactly; A's final val on last.ckpt.npz equals cli/val.py's main on the
    same file; the TAL and NMS kernels equal their plain versions on the
    first inputs the run gave them. Returns the kernels-line entries of this
    path."""
    import tempfile

    import numpy as np
    import torch
    import yaml

    from cerberusdet_tpu_torch import native
    from cerberusdet_tpu_torch.cli import train as cli_train
    from cerberusdet_tpu_torch.cli import val as cli_val
    from cerberusdet_tpu_torch.data.loaders import create_dataloader
    from cerberusdet_tpu_torch.manager import run_manager
    from cerberusdet_tpu_torch.manager.checkpoint import (
        flatten_tree,
        load_checkpoint,
        save_checkpoint,
    )
    from cerberusdet_tpu_torch.manager.weights import export_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.ops import nms as nms_mod
    from cerberusdet_tpu_torch.ops import nms_cuda, tal_cuda
    from cerberusdet_tpu_torch.testing import calibrate_bn, write_val_set
    from cerberusdet_tpu_torch.train import loss as loss_mod
    from cerberusdet_tpu_torch.train import trainer as trainer_mod
    from cerberusdet_tpu_torch.train.step import MultiTaskTrainer

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kern = {"nms": nms_cuda.greedy_nms_cuda, "tal_select": tal_cuda.select_kernel,
            "tal_assign": tal_cuda.assign_kernel, "tal_norm": tal_cuda.norm_kernel}
    saved_counts = {k: f.launches for k, f in kern.items()}
    patches = []

    def patch(obj, name, new):
        patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    names = [[f"{t}_{i}" for i in range(n)] for t, n in zip(TASKS, NCS)]
    root = tempfile.mkdtemp(prefix="cerberus_train_")
    try:
        # ---- the data and the starting checkpoint
        t0 = time.perf_counter()
        train_dirs, val_dirs = [], []
        for i, (t, nc) in enumerate(zip(TASKS, NCS)):
            train_dirs.append(write_val_set(os.path.join(root, t, "train"), n_train, VAL_SIZES,
                                            seed=40 + i, n_labels=6, nc=nc))
            val_dirs.append(write_val_set(os.path.join(root, t, "val"), n_val, VAL_SIZES,
                                          seed=50 + i, n_labels=4, nc=nc))
        data_yaml = os.path.join(root, "data.yaml")
        with open(data_yaml, "w") as f:
            yaml.safe_dump({"task_ids": TASKS, "nc": NCS, "names": names, "train": train_dirs,
                            "val": val_dirs}, f)
        model = CerberusModel(cfg, TASKS, NCS, device=dev).init(seed=0)
        distinct_heads(model, seed=1)
        calib, _ = create_dataloader(train_dirs[0], imgsz, 8, task="bn", cache_dir=root)
        x = torch.from_numpy(np.stack([calib[i][0] for i in range(8)])).to(dev)
        calibrate_bn(model, x.permute(0, 3, 1, 2).float() / 255.0)
        weights = os.path.join(root, "start.ckpt.npz")
        save_checkpoint(weights, export_jax_params(model), {
            "cfg": cfg, "task_ids": TASKS, "nc": NCS, "names": names}, half=False)
        del model, x, calib
        log(f"[train cli] {n_train} train and {n_val} val JPEGs a task at native sizes "
            f"{VAL_SIZES}, 6 / 4 random labels an image; the seeded "
            f"{os.path.basename(cfg)} (BatchNorm statistics from 8 train images) as "
            f"--weights; in {time.perf_counter() - t0:.2f} s")

        # ---- probes around the loop (the path itself is unchanged)
        probe = {"hashes": [], "enter": [], "hash_s": [], "step_s": [], "first": None,
                 "resumed": None, "sync": False, "profile": None}
        real_step = MultiTaskTrainer.step

        def step(self, state, batches, lrs, momentum, freeze_shared=False, mark=None):
            i = len(probe["hashes"])
            probe["enter"].append(time.perf_counter())
            probe["hashes"].append({t: batch_digest(b) for t, b in batches.items()})
            probe["hash_s"].append(time.perf_counter() - probe["enter"][-1])
            if i == 0 and probe["resumed"] is not None:  # R starts from the saved params
                want = flatten_tree(probe["resumed"])
                got = flatten_tree(export_jax_params(state.model))
                bad = [k for k, v in want.items() if k not in got or not np.array_equal(
                    got[k], v)]
                if bad or len(got) != len(want):
                    raise AssertionError(f"the resumed params differ from the saved ones at "
                                         f"{len(bad)} leaves, e.g. {bad[:3]}")
                probe["resumed"] = len(want)
            if i == 0 and probe["first"] is None:  # the plain assigner from the same state
                snap = snapshot(state)
                for loss in self.losses.values():
                    loss.use_kernel = False
                try:
                    _, plain = real_step(self, state, batches, lrs, momentum, freeze_shared)
                finally:
                    for loss in self.losses.values():
                        loss.use_kernel = True
                probe["first"] = {t: [float(v) for v in it] for t, it in plain.items()}
                restore(state, snap)
                del snap
            if probe["profile"] == i:  # B: the profiler over PROFILED_STEPS steps
                from torch.profiler import ProfilerActivity, profile

                sync()
                # (the CPU's activity only where the phase is rehearsed without a card)
                prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                           else ProfilerActivity.CPU])
                prof.__enter__()
                probe["prof"] = (prof, time.perf_counter(), [])
            t = time.perf_counter()
            out = real_step(self, state, batches, lrs, momentum, freeze_shared)
            if probe["sync"]:
                sync()
                probe["step_s"].append(time.perf_counter() - t)
            if probe["profile"] is not None and probe.get("prof"):
                prof, t_enter, steps = probe["prof"]
                steps.append(time.perf_counter() - t)
                if len(steps) == PROFILED_STEPS:
                    wall = time.perf_counter() - t_enter
                    prof.__exit__(None, None, None)
                    busy = sum(e.device_time_total for e in prof.key_averages()) / 1e3
                    probe["prof_result"] = {"steps": (i - PROFILED_STEPS + 1, i),
                                            "busy_ms": busy, "step_ms": 1e3 * sum(steps),
                                            "wall_ms": 1e3 * wall}
                    probe["prof"] = None
            if isinstance(probe["first"], dict):
                worst = 0.0
                for task, it in out[1].items():
                    for a, b in zip(it, probe["first"][task]):
                        rel = abs(float(a) - b) / max(abs(b), 1e-30)
                        worst = max(worst, rel)
                        if rel > 1e-5:
                            raise AssertionError(f"{task}: kernel-assigner loss {float(a)} vs "
                                                 f"plain {b} at the first step")
                log(f"[train cli] run A's first step: the plain assigner from the same state "
                    f"gives the kernels' losses within rtol {worst:.3g} (limit 1e-5): "
                    f"{probe['first']}")
                probe["first"] = True
            return out

        patch(MultiTaskTrainer, "step", step)

        vals = []  # (batches, with the loss, seconds, detections) per run_task of the loop
        real_run_task = trainer_mod.run_task

        def run_task(model, task, loader, *a, **kw):
            t = time.perf_counter()
            out = real_run_task(model, task, loader, *a, **kw)
            n_det = sum(len(s[1]) for s in out["metrics"].stats)
            vals.append((len(loader), kw.get("compute_loss") is not None,
                         time.perf_counter() - t, n_det))
            return out

        patch(trainer_mod, "run_task", run_task)

        captured = {}  # the first TAL and NMS inputs of run A
        real_assign = loss_mod.task_aligned_assign

        def assign(*a, **kw):
            if "tal" not in captured:
                captured["tal"] = ([v.detach().clone() for v in a[:6]], kw["num_classes"])
            return real_assign(*a, **kw)

        patch(loss_mod, "task_aligned_assign", assign)
        real_nms = nms_mod.greedy_nms_cuda

        def nms(boxes, scores, iou_thres, max_det):
            if "nms" not in captured:
                captured["nms"] = (boxes.clone(), scores.clone(), iou_thres, max_det)
            return real_nms(boxes, scores, iou_thres, max_det)

        patch(nms_mod, "greedy_nms_cuda", nms)

        timed = {"val_epoch": [], "save_model": [], "save_best_task_model": []}

        def timing(cls, name):
            real = getattr(cls, name)

            def wrapper(*a, **kw):
                t = time.perf_counter()
                out = real(*a, **kw)
                timed[name].append(time.perf_counter() - t)
                return out
            patch(cls, name, wrapper)

        timing(trainer_mod.TrainLoop, "val_epoch")
        timing(run_manager.RunManager, "save_model")
        timing(run_manager.RunManager, "save_best_task_model")

        cli_check = {}
        real_final = trainer_mod.TrainLoop._final_val_on_ckpts

        def final_val(self):
            out = real_final(self)
            if not cli_check:  # run A: cli/val.py's main on the same last.ckpt.npz
                before = {k: f.launches for k, f in kern.items()}
                t = time.perf_counter()
                got = cli_val.main(
                    ["--weights", str(self.manager.wdir / "last.ckpt.npz"), "--data",
                     data_yaml, "--imgsz", str(imgsz), "--batch-size", str(batch), "--no-rect",
                     "--device", str(dev), "--project", os.path.join(root, "val"),
                     "--exist-ok"] + (["--workers", str(workers)] if workers else []))
                for k, f in kern.items():  # the comparison's launches do not count
                    f.launches = before[k]
                for t_ in TASKS:
                    a, b = out["last"][t_], got[t_]
                    if a["results"] != b["results"] or not np.array_equal(a["maps"], b["maps"]) \
                            or a["seen"] != b["seen"]:
                        raise AssertionError(f"{t_}: the final val on last.ckpt.npz "
                                             f"{a['results']} differs from cli/val.py's "
                                             f"{b['results']}")
                cli_check.update({t_: (got[t_]["results"][:4], sum(
                    len(s[1]) for s in got[t_]["metrics"].stats)) for t_ in TASKS})
                log(f"[train cli] run A's final val on last.ckpt.npz == cli/val.py main on the "
                    f"same file (--no-rect, batch {batch}; {time.perf_counter() - t:.2f} s): "
                    + ", ".join(f"{t_}: P R mAP50 mAP {np.round(r, 5).tolist()} from {n} "
                                f"detections" for t_, (r, n) in cli_check.items()))
            return out

        patch(trainer_mod.TrainLoop, "_final_val_on_ckpts", final_val)

        project = os.path.join(root, "runs")
        common = ["--data", data_yaml, "--device", str(dev)]
        fresh = common + ["--cfg", cfg, "--hyp", PAPER_HYP, "--imgsz", str(imgsz),
                          "--batch-size", f"{batch},{batch}", "--bf16", "--warmup-min-iters", "4",
                          "--weights", weights, "--project", project, "--seed", "0"] + (
                              ["--workers", str(workers)] if workers else [])

        def run(label, argv):
            for f in kern.values():
                f.launches = 0
            probe.update(hashes=[], enter=[], hash_s=[], step_s=[])
            vals.clear()
            for v in timed.values():
                v.clear()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loop = cli_train.main(argv)
            wall = time.perf_counter() - t
            counts = {k: f.launches for k, f in kern.items()}
            tasks_stepped = sum(len(h) for h in probe["hashes"])
            val_batches = sum(v[0] for v in vals)
            loss_batches = sum(v[0] for v in vals if v[1])
            expect = {"nms": val_batches, "tal_select": tasks_stepped + loss_batches,
                      "tal_assign": tasks_stepped + loss_batches,
                      "tal_norm": tasks_stepped + loss_batches}
            peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
            log(f"[train cli] run {label}: {len(probe['hashes'])} steps, {len(vals)} task vals "
                f"over {val_batches} batches ({loss_batches} with losses); launches {counts}, "
                f"expected {expect}; main's wall {wall:.2f} s; peak memory {peak:.2f} GiB  "
                f"[{card}]")
            if counts != expect:
                raise AssertionError(f"run {label}: kernel launches {counts} != {expect}")
            return loop, {"hashes": list(probe["hashes"]), "wall": wall, "counts": counts,
                          "vals": list(vals), "timed": {k: list(v) for k, v in timed.items()},
                          "enter": list(probe["enter"]), "hash_s": list(probe["hash_s"]),
                          "step_s": list(probe["step_s"]), "peak": peak}

        # ---- run A: 2 epochs, the native decoder built by the run's first decode
        decoder = native.default_decoder()
        for so in native.BUILD_DIR.glob("libcerberus_io_*.so"):
            so.unlink()
        if decoder.name:
            raise AssertionError("the native decoder was resolved before the train phase")
        loop_a, a = run("A", fresh + ["--epochs", "2", "--name", "A"])
        if probe["first"] is not True or not cli_check:
            raise AssertionError("run A did not run its first-step or final-val comparison")
        log(f"[train cli] JPEG decode by {decoder.name!r} (what run A's first decode built: "
            f"{sorted(p.name for p in native.BUILD_DIR.glob('libcerberus_io_*.so'))})  [{card}]")
        last = loop_a.manager.wdir / "last.ckpt.npz"

        # ---- run R: A resumed, its opt.yaml's epochs raised to 3
        opt_yaml = loop_a.manager.save_dir / "opt.yaml"
        with open(opt_yaml) as f:
            saved = yaml.safe_load(f)
        saved["epochs"] = 3
        with open(opt_yaml, "w") as f:
            yaml.safe_dump(saved, f, sort_keys=False)
        probe["resumed"] = load_checkpoint(str(last))["params"]
        loop_r, r = run("R", common + ["--resume", str(last)])
        if not isinstance(probe["resumed"], int) or loop_r.start_epoch != 2:
            raise AssertionError(f"run R did not resume at epoch 2 ({loop_r.start_epoch})")
        log(f"[train cli] run R resumed at epoch 3 of 3 in {loop_r.manager.save_dir.name}, its "
            f"{probe['resumed']} params equal to the saved ones exactly")
        probe["resumed"] = None
        del loop_a, loop_r

        # ---- run B: a fresh 3-epoch run, each step synchronised and timed
        nb = len(a["hashes"]) // 2
        # the profiler in epoch 3, after its 2 warm-up steps where the epoch has room
        probe["sync"], probe["profile"] = True, 2 * nb + max(0, min(2, nb - PROFILED_STEPS))
        try:
            loop_b, b = run("B", fresh + ["--epochs", "3", "--name", "B", "--nosave",
                                          "--noval"])
        finally:
            probe["sync"], probe["profile"] = False, None
        if b["hashes"][:2 * nb] != a["hashes"] or b["hashes"][2 * nb:] != r["hashes"]:
            raise AssertionError("runs A, R and B did not feed the steps the same batches")
        log(f"[train cli] run B's {len(b['hashes'])} steps got run A's and run R's batches "
            f"(sha1 of img and bboxes per task and step): two fresh seeded runs and a resume "
            f"feed identical batches")

        # ---- what B measured
        timings = loop_b.timings
        warm = [i for i in range(len(timings)) if i % nb >= 2]  # 2 warm-up steps an epoch
        step_ms = 1e3 * float(np.median([b["step_s"][i] for i in warm]))
        data_ms = [1e3 * timings[i]["data_s"] for i in warm]
        # a loop iteration, step start to step start, less the probe's own hashing
        iter_ms = 1e3 * float(np.median([b["enter"][i] - b["enter"][i - 1] - b["hash_s"][i - 1]
                                         for i in warm]))
        hash_ms = 1e3 * float(np.median(b["hash_s"]))
        n_img = len(TASKS) * batch
        log(f"[train cli] run B, a step (host clock around MultiTaskTrainer.step ending in a "
            f"synchronise, median of {len(warm)} after 2 warm-up steps an epoch): "
            f"{step_ms:.2f} ms, {n_img / step_ms * 1e3:.1f} img/s; a loop iteration (step start "
            f"to step start, the data wait included, less the probe's {hash_ms:.2f} ms of "
            f"hashing) {iter_ms:.2f} ms, {n_img / iter_ms * 1e3:.1f} img/s  [{card}]")
        log(f"[train cli] run B, the host's wait for the loaders' batches a step: median "
            f"{np.median(data_ms):.2f} ms, max {max(data_ms):.2f} ms; at the first step of "
            f"each epoch {[round(1e3 * timings[e * nb]['data_s'], 1) for e in range(3)]} ms  "
            f"[{card}]")
        pr = probe.get("prof_result")
        if pr is None:
            raise AssertionError("run B's profiled steps did not run")
        log(f"[train cli] run B, device busy over steps {pr['steps']} (the profiler's kernel "
            f"time): {pr['busy_ms']:.2f} ms in {pr['step_ms']:.2f} ms of steps "
            f"({100 * pr['busy_ms'] / pr['step_ms']:.1f}%), in {pr['wall_ms']:.2f} ms of the "
            f"loop ({100 * pr['busy_ms'] / pr['wall_ms']:.1f}%)  [{card}]")
        ds = loop_b.datasets[TASKS[0]]
        ds.set_epoch(0)
        n_items = min(16, len(ds))
        t = time.perf_counter()
        for i in range(n_items):
            ds[i]
        aug_ms = (time.perf_counter() - t) / n_items * 1e3
        log(f"[train cli] host augmentation (the paper's hyps: mosaic 1.0, mixup 0.285; decode "
            f"by {decoder.name}), one thread, {n_items} items: {aug_ms:.2f} ms an image  "
            f"[{card}]")
        val_s = a["timed"]["val_epoch"] + r["timed"]["val_epoch"]
        task_val_s = [v[2] for run_ in (a, r) for v in run_["vals"] if v[1]]
        save_s = a["timed"]["save_model"] + r["timed"]["save_model"]
        best_s = a["timed"]["save_best_task_model"] + r["timed"]["save_best_task_model"]
        log(f"[train cli] runs A and R, the val of the EMA model per epoch (2 tasks x {n_val} "
            f"images, float32, with losses): {[round(v, 2) for v in val_s]} s, of which "
            f"run_task per task {[round(v, 2) for v in task_val_s]} s and the per-task best "
            f"checkpoints {[round(v, 2) for v in best_s]} s; save_model (last.ckpt.npz in "
            f"float32 with EMA and momentum, best.ckpt.npz): {[round(v, 2) for v in save_s]} "
            f"s; main's wall: A {a['wall']:.1f} s, R {r['wall']:.1f} s, B {b['wall']:.1f} s; "
            f"peak memory A {a['peak']:.2f} GiB, B {b['peak']:.2f} GiB  [{card}]")
        del loop_b

        # ---- the kernels at the first inputs this path gave them
        (args, nc), (boxes, scores, iou, max_det) = captured["tal"], captured["nms"]
        runs = {"A": a, "R": r, "B": b}
        entries = tal_entries(args, nc, {k: a["counts"][k] for k in TAL_KERNELS},
                              "train CLI: an augmented batch", card,
                              {k: {"launches_by_run": {n: x["counts"][k] for n, x in runs.items()}}
                               for k in TAL_KERNELS})
        entries.append(nms_kernel_entry(
            boxes, scores, iou, max_det, "train CLI: per-epoch and final val",
            a["counts"]["nms"], card,
            {"launches_by_run": {n: x["counts"]["nms"] for n, x in runs.items()}}))
        return entries
    finally:
        for obj, name, orig in reversed(patches):
            setattr(obj, name, orig)
        for k, f in kern.items():
            f.launches = saved_counts[k]
        shutil.rmtree(root, ignore_errors=True)


# the serving entry points' cell: detect over a folder of seeded JPEGs at the
# val cell's native sizes; serving at --max-batch 8 under a flood of requests
# of the serving cell's 480x640 frames from concurrent clients
DETECT_IMAGES, SERVE_BATCH, FLOOD_REQUESTS, FLOOD_CLIENTS = 24, 8, 64, 16
# the sequential requests: the flood's four 480x640 frames (the detect folder's
# four images with the most bf16 detections, resized), then native (w, h)
# sizes that fill the preprocessor's 4 device letterboxes (the warm-up took
# 640x640) and two that take its host path
OTHER_SIZES = [(1280, 720), (500, 375), (375, 500), (333, 500)]


def detect_run(cli, argv, dev):
    """cli.detect.main(argv) with CerberusDetInference.predict probed.
    Returns (save_dir, wall s, calls [(inference, batch, shapes, dets, s,
    start)]), one call per image; logs where main's wall went."""
    import numpy as np
    import torch

    from cerberusdet_tpu_torch.infer import inference as inf_mod

    orig = inf_mod.CerberusDetInference.predict
    calls = []

    def probe(self, batch, original_shape=None, **kw):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(self, batch, original_shape=original_shape, **kw)
        calls.append((self, batch, original_shape, out, time.perf_counter() - t, t))
        return out

    inf_mod.CerberusDetInference.predict = probe
    try:
        t = time.perf_counter()
        save_dir = cli.main(argv)
        wall = time.perf_counter() - t
    finally:
        inf_mod.CerberusDetInference.predict = orig
    starts = [c[5] for c in calls]
    loop = [b - a for a, b in zip(starts, starts[1:])]
    log(f"[detect] main's wall {wall:.2f} s: set-up before the first predict (model load, "
        f"fuse, cast{', calibration and quantization' if '--int8' in argv else ''}) "
        f"{starts[0] - t:.2f} s, the first image {1e3 * (starts[1] - starts[0]) if loop else 0:.1f} "
        f"ms (the capture), each later image {1e3 * float(np.median(loop[1:] or [0])):.2f} ms "
        f"median (imread, letterbox, predict, drawing, imwrite and crops)")
    return save_dir, wall, calls


def check_detect_outputs(save_dir, src, calls, label: str) -> int:
    """Each annotated file byte-identical to cv2.imwrite of the visualizer's
    drawing of the image's detections, and one crop per detection whose box
    holds pixels. Returns the crops."""
    import cv2
    import numpy as np

    from cerberusdet_tpu_torch.cli.detect import iter_images
    from cerberusdet_tpu_torch.infer import CerberusVisualizer

    vis = CerberusVisualizer(line_thickness=0)
    want_crops = set()
    tmp = os.path.join(save_dir, "_check.jpg")
    for (path, im0), call in zip(iter_images(src), calls):
        dets = call[3][0]
        cv2.imwrite(tmp, vis.draw_detections(im0, dets, hide_task=False))
        with open(tmp, "rb") as f, open(os.path.join(save_dir, path.name), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"detect {label}: {path.name} differs from the "
                                     "visualizer's drawing of its detections")
        for j, d in enumerate(dets):
            x1, y1, x2, y2 = d["box"]
            if im0[max(y1, 0):y2, max(x1, 0):x2].size:
                want_crops.add(os.path.join("crops", d["label_name"].replace(" ", "_"),
                                            f"{path.stem}_{j}.jpg"))
    os.remove(tmp)
    crops = {os.path.relpath(os.path.join(d, f), save_dir)
             for d, _, fs in os.walk(os.path.join(save_dir, "crops")) for f in fs}
    if crops != want_crops:
        raise AssertionError(f"detect {label}: {len(crops)} crops written, "
                             f"{len(want_crops)} detections with a non-empty box")
    return len(crops)


def same_as_plain(calls, label: str) -> None:
    """Each probed request identical to predict on the same batch with
    use_kernel=False (eager, the plain NMS loop and plain int8 convs)."""
    from cerberusdet_tpu_torch.infer.inference import CerberusDetInference

    for inf, batch, shapes, out, *_ in calls:
        plain = CerberusDetInference.predict(inf, batch, original_shape=shapes,
                                             use_kernel=False)
        if plain != out:
            same_results(out, plain, score_rtol=0.0)  # says where
            raise AssertionError(f"{label}: a request differs from the plain path")


def flood_client(url: str, bodies, order, clients: int):
    """The flood's load generator, run in a process of its own: POST
    bodies[order[i]] to url/predict for every i from `clients` threads.
    Returns (wall s, [(status, response bytes, latency s) or None for a
    request that raised] in order)."""
    import threading
    import urllib.request

    results = [None] * len(order)

    def client(k):
        for i in range(k, len(order), clients):
            req = urllib.request.Request(url + "/predict", data=bodies[order[i]], method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = (r.status, r.read(), time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    return time.perf_counter() - t0, results


def serve_run(cli, ckpt, extra, dev, frames, flood: int, clients: int, card: str,
                  label: str):
    """cli.serve.build(...) on 127.0.0.1 port 0 with serve_forever on a
    thread: /healthz; the sequential requests of `frames` ([(jpeg bytes,
    (h, w))]), each response against predict on the frame's padded batch
    with use_kernel=False; then `flood` requests of the 480x640 frames from
    `clients` threads, each response against the sequential one of the same
    frame. Returns a dict of what was measured."""
    import multiprocessing as mp
    import threading
    import urllib.request

    import cv2
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cerberusdet_tpu_torch.ops import conv_int8_cuda, nms_cuda
    from cerberusdet_tpu_torch.serve.server import _to_jsonable
    from cerberusdet_tpu_torch.utils.profiling import pool_mib

    nms = nms_cuda.greedy_nms_cuda
    opt = cli.parse_opt(["--weights", ckpt, "--imgsz", str(frames.imgsz), "--max-batch",
                         str(frames.max_batch), "--max-wait-ms", "5", "--host", "127.0.0.1",
                         "--port", "0", "--device", str(dev)] + extra)
    t = time.perf_counter()
    inference, engine, server = cli.build(opt)
    build_s = time.perf_counter() - t
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return json.loads(r.read())

    def post(data):
        req = urllib.request.Request(url + "/predict", data=data, method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
            return r.status, body, time.perf_counter() - t0

    try:
        health = get("/healthz")
        if health != {"status": "ok", "tasks": TASKS}:
            raise AssertionError(f"serve {label}: /healthz said {health}")
        programs = dict(inference.programs)
        if dev.type == "cuda" and len(programs) != 1:
            raise AssertionError(f"serve {label}: the warm-up captured {len(programs)} "
                                 "predict programs, not one")
        start = get("/stats")
        nms.launches = conv_int8_cuda.conv_s8.launches = 0
        conv_int8_cuda.quant_pack_s8.launches = 0
        n_q = len(inference.int8_convs)

        # (a) sequential requests, each against the plain path on its padded batch
        seq = []
        for data, _ in frames.sequential:
            status, body, _ = post(data)
            if status != 200:
                raise AssertionError(f"serve {label}: status {status}")
            im = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            h, w = im.shape[:2]
            if (h, w) in engine.pre._device_fns:  # the route the server's batch took
                one = engine.pre._device_fn(h, w)(torch.from_numpy(im[None]).to(dev))
            else:
                one = torch.from_numpy(engine.pre.preprocess_host([im])[0])
            padded = torch.cat([one, one.new_zeros((frames.max_batch - 1,) + one.shape[1:])])
            plain = inference.predict(padded, original_shape=[(h, w)] * frames.max_batch,
                                      use_kernel=False)[0]
            if body["detections"] != _to_jsonable(plain):
                raise AssertionError(f"serve {label}: a {w}x{h} response differs from predict "
                                     "on its padded batch with use_kernel=False")
            seq.append(body["detections"])
        flood_frames = [i for i, (_, hw) in enumerate(frames.sequential) if hw == (480, 640)]
        if not sum(len(seq[i]) for i in flood_frames):
            raise AssertionError(f"serve {label}: the flood's frames draw no detections")
        routes = [(h, w) in engine.pre._device_fns for _, (h, w) in frames.sequential]
        log(f"[serve {label}] {len(seq)} sequential requests at native sizes "
            f"{[f'{w}x{h}' for _, (h, w) in frames.sequential]} ({sum(routes)} letterboxed on "
            f"the card, {len(routes) - sum(routes)} on the host, as the preprocessor routes "
            f"them): each response equals "
            f"predict on its batch zero-padded to {frames.max_batch} with use_kernel=False "
            f"({sum(map(len, seq))} detections, {sum(len(seq[i]) for i in flood_frames)} of them "
            f"in the flood's {len(flood_frames)} 480x640 frames)")

        # (b) the flood, twice: the first captures the letterbox graphs of the
        # batch sizes it meets, the second finds most of them

        def flood_run(which, profiled: bool):
            before = get("/stats")
            order = [flood_frames[i % len(flood_frames)] for i in range(flood)]
            tracing = profiled and dev.type == "cuda"
            prof = profile(activities=[ProfilerActivity.CUDA]) if tracing else None
            # the load generator runs in a process of its own, so that its
            # threads do not share the server's interpreter
            with mp.get_context("spawn").Pool(1) as pool:
                pool.apply(time.sleep, (0,))  # the worker is up
                if tracing:
                    prof.start()
                wall, raw = pool.apply(flood_client, (url, [d for d, _ in frames.sequential],
                                                      order, clients))
                if tracing:
                    prof.stop()
            busy = ""
            if tracing:
                dev_ms = sum(e.device_time_total for e in prof.key_averages()) / 1e3
                busy = (f"; the card busy {dev_ms:.1f} ms = {100 * dev_ms / (1e3 * wall):.1f}% of "
                        f"the wall (the profiler's device time, a lower bound where its trace "
                        f"drops records)")
            after = get("/stats")
            if any(r is None or r[0] != 200 for r in raw):
                raise AssertionError(f"serve {label}: "
                                     f"{sum(r is None or r[0] != 200 for r in raw)} flood "
                                     "requests failed")
            results = [(j, r[0], json.loads(r[1]), r[2]) for j, r in zip(order, raw)]
            differ = sum(r[2]["detections"] != seq[r[0]] for r in results)
            if differ:
                matched = sum(matched_detections([r[2]["detections"]], [seq[r[0]]])
                              for r in results)
                total = sum(len(seq[r[0]]) for r in results)
                raise AssertionError(f"serve {label}: {differ} of {flood} flood responses "
                                     f"differ from the sequential response of their frame "
                                     f"({matched} of {total} detections matched at IoU 0.5)")
            lat = np.array([r[3] for r in results]) * 1e3
            n_b = after["batches"] - before["batches"]
            out = {"rps": flood / wall, "p50": float(np.percentile(lat, 50)),
                   "p99": float(np.percentile(lat, 99)), "fill": flood / (n_b * frames.max_batch),
                   "captures": len(engine.pre._programs)}
            log(f"[serve {label}] flood {which}: {flood} requests of 480x640 JPEGs from "
                f"{clients} client threads in {wall:.3f} s: {out['rps']:.1f} requests/s = "
                f"{out['rps']:.1f} img/s; client latency p50 {out['p50']:.2f} ms, p99 "
                f"{out['p99']:.2f} ms, max {lat.max():.2f} ms; {n_b} batches, mean fill "
                f"{out['fill']:.3f} of {frames.max_batch}; preprocessor captures after it "
                f"{out['captures']}{busy}; every response 200 and equal to the sequential "
                f"response of its frame  [{card}]")
            return out

        cold = flood_run("1 (cold)", profiled=False)
        # every batch size's letterbox of the flood's shape, captured while the
        # batcher is idle, so that the profiled flood runs what a warm service runs
        ims = [cv2.imdecode(np.frombuffer(frames.sequential[j][0], np.uint8), cv2.IMREAD_COLOR)
               for j in flood_frames]
        for b in range(1, frames.max_batch + 1):
            engine.pre.preprocess([ims[i % len(ims)] for i in range(b)])
        warm = flood_run("2 (warm: every batch size's letterbox captured; profiled)",
                         profiled=True)
        end = get("/stats")

        if end["errors"] != start["errors"]:
            raise AssertionError(f"serve {label}: the engine counted errors")
        batches = end["batches"] - start["batches"]
        launches = {"nms": nms.launches, "conv_s8": conv_int8_cuda.conv_s8.launches,
                    "quant_pack_s8": conv_int8_cuda.quant_pack_s8.launches}
        want = {"nms": len(TASKS) * batches, "conv_s8": n_q * batches,
                "quant_pack_s8": n_q * batches}
        if launches != want:
            raise AssertionError(f"serve {label}: launches {launches}, expected {want} for "
                                 f"{batches} served batches")
        if dev.type == "cuda" and inference.programs != programs:
            raise AssertionError(f"serve {label}: {len(inference.programs)} predict programs "
                                 f"after the requests (the warm-up's one expected)")
        if len(engine.pre._device_fns) > 4 or \
                len(engine.pre._programs) > 4 * frames.max_batch:
            raise AssertionError(f"serve {label}: the preprocessor letterboxes "
                                 f"{len(engine.pre._device_fns)} source shapes on the card in "
                                 f"{len(engine.pre._programs)} graphs (at most 4 shapes)")
        # where a served batch's time goes: one full batch of the flood's frames
        # through each stage alone, the batcher idle (host clock, median of 5)
        def med(fn):
            ts = []
            for _ in range(5):
                t = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t)
            return 1e3 * float(np.median(ts))

        bodies = [frames.sequential[ims_j][0] for ims_j in
                  (flood_frames[i % len(flood_frames)] for i in range(frames.max_batch))]
        decoded = [cv2.imdecode(np.frombuffer(d, np.uint8), cv2.IMREAD_COLOR) for d in bodies]
        bt, shp = engine.pre.preprocess(decoded)
        dets = inference.predict(bt, original_shape=shp)
        stage = {"decode": med(lambda: [cv2.imdecode(np.frombuffer(d, np.uint8),
                                                     cv2.IMREAD_COLOR) for d in bodies]),
                 "preprocess": med(lambda: engine.pre.preprocess(decoded)),
                 "predict": med(lambda: inference.predict(bt, original_shape=shp)),
                 "json": med(lambda: [json.dumps({"detections": _to_jsonable(d)})
                                      for d in dets])}
        if dev.type == "cuda":
            (prog,) = inference.programs.values()
            stage["replay + copy"] = med(lambda: prog.run(torch.as_tensor(bt)).cpu())
        log(f"[serve {label}] one batch of {frames.max_batch} of the flood's frames "
            f"({sum(map(len, dets))} detections), stage by stage with the batcher idle (host "
            f"clock, median of 5): " + ", ".join(f"{k} {v:.2f} ms" for k, v in stage.items())
            + f"; predict's formatting of the detections {stage['predict'] - stage.get('replay + copy', 0.0):.2f} "
            f"ms; the stages sum to {sum(v for k, v in stage.items() if k != 'replay + copy'):.2f} "
            f"ms against the warm flood's {1e3 * frames.max_batch * warm['fill'] / warm['rps']:.2f} "
            f"ms a batch  [{card}]")

        mib = [pool_mib(p) if dev.type == "cuda" and p is not None else 0.0
               for p in (inference._pool, engine.pre._pool)]
        log(f"[serve {label}] build + warm-up {build_s:.2f} s; {batches} served batches: "
            f"launches {launches} (one NMS per task and batch"
            + (f", one conv_s8 and quant_pack_s8 per quantized Conv ({n_q}) and batch"
               if n_q else "") + f"); predict programs {len(inference.programs)}, preprocessor "
            f"captures {len(engine.pre._programs)} (h, w, b) for {len(engine.pre._device_fns)} "
            f"source shapes; graph pools: predict {mib[0]:.1f} MiB, preprocessor {mib[1]:.1f} "
            f"MiB  [{card}]")
        return {"inference": inference, "launches": launches, "batches": batches,
                "cold": cold, "warm": warm}
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=10)


def nms_entry(inf, batch, nc_by_task, conf: float, name: str, launches: int, card: str):
    """The NMS kernel on the candidates of `batch` (both tasks' picks against
    the plain loop), its time and bound on the first task's: a kernels-line
    entry."""
    import torch

    from cerberusdet_tpu_torch.ops import nms_cuda
    from cerberusdet_tpu_torch.ops.nms import select_candidates

    nms = nms_cuda.greedy_nms_cuda
    saved = nms.launches
    x = torch.as_tensor(batch).to(inf.device).permute(0, 3, 1, 2).to(inf.dtype)
    preds = inf.model(x)
    err, timed = 0, None
    for task in TASKS:
        _, sc, _, boxes = select_candidates(preds[task][0], nc_by_task[task], conf, False, None,
                                            nms_cuda.MAX_K, False)
        idx_k, val_k = nms(boxes, sc, 0.45, 300)
        idx_p, val_p = nms_cuda.greedy_nms(boxes, sc, 0.45, 300)
        err = max(err, int((idx_k.long() - idx_p.long()).abs().max()),
                  int((val_k.long() - val_p.long()).abs().max()))
        if err:
            raise AssertionError(f"{name}: the NMS kernel disagrees with the plain loop")
        timed = timed or (boxes, sc)
    boxes, sc = timed
    k_ms, how = kernel_ms(lambda: nms(boxes, sc, 0.45, 300), 20, "nms_kernel")
    p_ms = cuda_ms(lambda: nms_cuda.greedy_nms(boxes, sc, 0.45, 300), iters=3, warmup=1)
    ops, steps = nms_work(boxes, sc, 0.45, 300)
    b, k = sc.shape
    bytes_ms = (b * k * 20 + b * 300 * 5) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    nms.launches = saved
    log(f"[nms at {name}] B,K={b, k}, positives an image {(sc > 0).sum(1).tolist()}, steps "
        f"{steps}: picks identical with the plain loop on both tasks; kernel {k_ms:.4f} ms "
        f"({how}), plain {p_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.6f} ms  [{card}]")
    return {"name": f"nms ({name})", "route": "cuda",
            "source": "cerberusdet_tpu_torch/csrc/nms.cu",
            "replaces": "cerberusdet_tpu/ops/nms_pallas.py:34", "launches": launches,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None}


def entry_points(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640,
                 n_images: int = DETECT_IMAGES, max_batch: int = SERVE_BATCH,
                 flood: int = FLOOD_REQUESTS, clients: int = FLOOD_CLIENTS):
    """The serving entry points at full width (phase 8): cli.detect over a
    folder in bf16, bf16 + int8 "all" and from a reference .pt, and
    cli.serve in bf16 and int8 "all" under sequential requests and a flood,
    with their gates. Returns the kernels-line entries of the path."""
    import types

    import cv2
    import numpy as np
    import torch
    import yaml

    from cerberusdet_tpu_torch.cli import detect as cli_detect
    from cerberusdet_tpu_torch.cli import serve as cli_serve
    from cerberusdet_tpu_torch.infer import CerberusPreprocessor
    from cerberusdet_tpu_torch.manager.checkpoint import save_checkpoint
    from cerberusdet_tpu_torch.manager.pt_import import import_pt, load_torch_state_dict
    from cerberusdet_tpu_torch.manager.weights import export_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.ops import conv_int8_cuda, nms_cuda
    from cerberusdet_tpu_torch.testing import calibrate_bn, write_val_set
    from cerberusdet_tpu_torch.tools import export_to_pt

    conv_s8, quant_pack_s8 = conv_int8_cuda.conv_s8, conv_int8_cuda.quant_pack_s8
    nms = nms_cuda.greedy_nms_cuda
    saved = (nms.launches, conv_s8.launches, quant_pack_s8.launches)
    names = {t: [f"{t}_{i}" for i in range(n)] for t, n in zip(TASKS, NCS)}
    nc_by_task = dict(zip(TASKS, NCS))
    root = tempfile.mkdtemp(prefix="cerberus_serve_")
    try:
        # ---- the seeded flagship as a .ckpt.npz, a folder of JPEGs, a data yaml
        t0 = time.perf_counter()
        src = write_val_set(os.path.join(root, "src"), n_images, VAL_SIZES, seed=30)
        model = CerberusModel(cfg, TASKS, NCS, device=dev).init(seed=0)
        distinct_heads(model, seed=1)
        imgs = [cv2.imread(os.path.join(src, f)) for f in sorted(os.listdir(src))[:8]]
        host = CerberusPreprocessor(img_size=imgsz, prefer_device=False, device=dev)
        x = torch.from_numpy(host.preprocess(imgs)[0]).to(dev).permute(0, 3, 1, 2)
        calibrate_bn(model, x)
        ckpt = os.path.join(root, "seeded.ckpt.npz")
        save_checkpoint(ckpt, export_jax_params(model), {
            "cfg": cfg, "task_ids": TASKS, "nc": NCS, "names": [names[t] for t in TASKS]},
            half=False)
        n_params = sum(p.numel() for p in model.parameters())
        del model, x
        data_yaml = os.path.join(root, "data.yaml")
        with open(data_yaml, "w") as f:
            yaml.safe_dump({"task_ids": TASKS, "nc": NCS, "names": [names[t] for t in TASKS],
                            "train": [src, src], "val": [src, src]}, f)
        log(f"[entry points] {n_images} JPEGs at native sizes {VAL_SIZES}, the seeded "
            f"{os.path.basename(cfg)} ({n_params / 1e6:.2f} M params, BatchNorm statistics "
            f"from 8 of them) saved as a .ckpt.npz, in {time.perf_counter() - t0:.2f} s")

        # ---- detect, bf16
        common = ["--source", src, "--imgsz", str(imgsz), "--device", str(dev), "--bf16",
                  "--project", os.path.join(root, "runs"), "--save-crop"]
        nms.launches = 0
        save_dir, wall, calls = detect_run(cli_detect, ["--weights", ckpt, "--name", "bf16"]
                                           + common, dev)
        nms_detect = nms.launches
        inf = calls[0][0]
        if len(calls) != n_images or any(c[0] is not inf for c in calls):
            raise AssertionError(f"detect bf16: {len(calls)} predict calls for {n_images} "
                                 "images")
        key = inf.program_key(torch.zeros((1, imgsz, imgsz, 3)), 0.25, 0.45, 0.8, False, 300)
        if dev.type == "cuda" and (list(inf.programs) != [key] or inf.dtype != torch.bfloat16):
            raise AssertionError(f"detect bf16: {len(inf.programs)} captured programs, not one "
                                 f"(batch 1, {imgsz}x{imgsz}, bf16)")
        # the capture's eager run launches the kernels once more (infer/graphs.py)
        runs = n_images + len(inf.programs)
        if nms_detect != len(TASKS) * runs:
            raise AssertionError(f"detect bf16: {nms_detect} NMS launches for {n_images} "
                                 f"images and {len(inf.programs)} capture, not one per task "
                                 "and run")
        n_crops = check_detect_outputs(save_dir, src, calls, "bf16")
        same_as_plain(calls, "detect bf16")
        bf16_out = [c[3] for c in calls]
        ms = [1e3 * c[4] for c in calls[1:]]
        n_det = sum(len(o[0]) for o in bf16_out)
        log(f"[detect bf16] main over {n_images} images: {wall:.2f} s wall, "
            f"{1e3 * wall / n_images:.2f} ms an image (load, capture, decode, draw and writes "
            f"included); predict {np.median(ms):.3f} ms median (min {min(ms):.3f}, max "
            f"{max(ms):.3f}) an image after the first (host clock, replayed), the first "
            f"{1e3 * calls[0][4]:.1f} ms (capture); {n_det} detections, {n_crops} crops; one "
            f"predict program; NMS launches {nms_detect} (2 a replay, 2 in the capture's eager "
            f"run); each image identical with "
            f"use_kernel=False; each annotated file byte-identical to the visualizer's  [{card}]")
        busiest = max(calls, key=lambda c: len(c[3][0]))
        entries = [nms_entry(inf, busiest[1], nc_by_task, 0.25,
                             f"detect: B 1, conf 0.25, the image with the most detections "
                             f"({len(busiest[3][0])})", nms_detect, card)]
        del inf, calls, busiest

        # ---- detect, bf16 + int8 "all", calibrated on the source images
        nms.launches = conv_s8.launches = quant_pack_s8.launches = 0
        save_dir, wall, calls = detect_run(
            cli_detect, ["--weights", ckpt, "--name", "int8", "--int8", "all"] + common, dev)
        inf = calls[0][0]
        n_q = len(inf.int8_convs)
        launches8 = (nms.launches, conv_s8.launches, quant_pack_s8.launches)
        runs = n_images + len(inf.programs)
        want = (len(TASKS) * runs, n_q * runs, n_q * runs)
        if launches8 != want or not n_q:
            raise AssertionError(f"detect int8: launches (NMS, conv_s8, quant_pack_s8) "
                                 f"{launches8}, expected {want}")
        if dev.type == "cuda" and len(inf.programs) != 1:
            raise AssertionError(f"detect int8: {len(inf.programs)} captured programs")
        check_detect_outputs(save_dir, src, calls, "int8")
        same_as_plain(calls, "detect int8")
        n_match = sum(matched_detections(c[3], ref) for c, ref in zip(calls, bf16_out))
        ms = [1e3 * c[4] for c in calls[1:]]
        log(f"[detect int8] main: {wall:.2f} s wall (calibration on 8 source images and "
            f"quantization included), predict {np.median(ms):.3f} ms median an image after the "
            f"first; {n_q} quantized Convs, launches (NMS, conv_s8, quant_pack_s8) {launches8}: "
            f"one per task / quantized Conv and image, and the capture's eager run; each image identical with the plain "
            f"int8 convs and NMS; {sum(len(c[3][0]) for c in calls)} detections, {n_match} "
            f"matched to bf16's (task, label, IoU >= 0.5)  [{card}]")
        checked, conv_calls = {}, {}
        xb = torch.as_tensor(calls[0][1]).to(dev).permute(0, 3, 1, 2).to(inf.dtype)
        val_batch_convs(inf.model, xb, None, checked, conv_calls)
        (k_conv, k_pack, conv_plain, pack_plain, conv_bound, pack_bound, n_calls, _,
         _) = conv_totals(checked, conv_calls)
        # the kernels' own device time in a batch-1 forward: the profiler's mean
        # launch (over the launches its trace keeps) times the forward's launches
        dev_ms = {"conv_s8_kernel": k_conv, "quant_pack": k_pack}
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    inf.model(xb)
                torch.cuda.synchronize()
            for kname in dev_ms:
                hits = [e for e in prof.key_averages() if kname in e.key]
                seen = sum(e.count for e in hits)
                dev_ms[kname] = (sum(e.device_time_total for e in hits) / 1e3 / seen * n_calls
                                 if seen else float("nan"))
        log(f"[detect int8] one batch-1 forward, {n_calls} launches of each kernel at "
            f"{len(conv_calls)} shapes: conv_s8 {dev_ms['conv_s8_kernel']:.3f} ms of device time "
            f"(the profiler's mean launch over 3 forwards x {n_calls}), {k_conv:.3f} ms summed "
            f"by CUDA events (each shape's mean of 5 wrapper calls: host-bound at batch 1), "
            f"bound {conv_bound:.4f} ms, plain {conv_plain:.1f} ms; quant_pack_s8 "
            f"{dev_ms['quant_pack']:.3f} ms of device time, {k_pack:.3f} ms by events, bound "
            f"{pack_bound:.4f} ms, plain {pack_plain:.1f} ms; both identical to their plain "
            f"versions at every shape  [{card}]")
        for nm, ms_, plain_, bound_, by, err_i, n_l in (
                ("conv_s8", dev_ms["conv_s8_kernel"], conv_plain, conv_bound, "operations", 2,
                 launches8[1]),
                ("quant_pack_s8", dev_ms["quant_pack"], pack_plain, pack_bound, "bytes", 3,
                 launches8[2])):
            entries.append({
                "name": f"{nm} (detect int8: one batch-1 forward, all {n_calls} launches "
                        "summed)",
                "route": "cuda", "source": "cerberusdet_tpu_torch/csrc/conv_int8.cu",
                "replaces": ("cerberusdet_tpu/ops/conv_int8_pallas.py:65" if nm == "conv_s8"
                             else "cerberusdet_tpu/nn/module.py:162 (quantize_act, no Pallas "
                                  "kernel; part of conv_s8's redesign)"),
                "launches": n_l, "max_abs_err": max(c[err_i] for c in checked.values()),
                "ms": ms_, "plain_ms": plain_, "bound_ms": bound_, "bound_by": by,
                "library_ms": None})
        del inf, calls, xb
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---- detect from a reference .pt of the same weights
        pt = os.path.join(root, "seeded.pt")
        t = time.perf_counter()
        export_to_pt.main(["--weights", ckpt, "--out", pt])
        export_s = time.perf_counter() - t
        t = time.perf_counter()
        sd = load_torch_state_dict(pt)
        read_s = time.perf_counter() - t
        del sd
        t = time.perf_counter()
        import_pt(CerberusModel(cfg, TASKS, NCS, device=dev).init(0), pt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        import_s = time.perf_counter() - t
        nms.launches = 0
        _, wall, calls = detect_run(cli_detect, ["--weights", pt, "--cfg", cfg, "--data",
                                                 data_yaml, "--name", "pt"] + common, dev)
        if [c[3] for c in calls] != bf16_out:
            raise AssertionError("detect .pt: the detections differ from the .ckpt.npz run's")
        log(f"[detect .pt] tools.export_to_pt wrote {os.path.getsize(pt) / 2**20:.1f} MiB in "
            f"{export_s:.2f} s; load_torch_state_dict {read_s:.2f} s, import_pt into the "
            f"model on the card {import_s:.2f} s ({n_params / 1e6:.2f} M params); main "
            f"{wall:.2f} s; every image's detections identical to the .ckpt.npz bf16 run's  "
            f"[{card}]")
        del calls

        # ---- serve: sequential requests at mixed shapes, then a flood
        paths = [p for p, _ in cli_detect.iter_images(src)]
        busiest = sorted(range(n_images), key=lambda i: -len(bf16_out[i][0]))[:4]
        sequential = []
        for i in busiest:
            im = cv2.resize(cv2.imread(str(paths[i])), (640, 480), interpolation=cv2.INTER_AREA)
            sequential.append((cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, 90])[1]
                               .tobytes(), (480, 640)))
        req_dir = write_val_set(os.path.join(root, "requests"), len(OTHER_SIZES), OTHER_SIZES,
                                seed=31)
        for f, (w, h) in zip(sorted(os.listdir(req_dir)), OTHER_SIZES):
            with open(os.path.join(req_dir, f), "rb") as fh:
                sequential.append((fh.read(), (h, w)))
        frames = types.SimpleNamespace(sequential=sequential, imgsz=imgsz, max_batch=max_batch)
        served = {}
        for label, extra in (("bf16", ["--bf16"]), ("int8", ["--bf16", "--int8", "all"])):
            served[label] = serve_run(cli_serve, ckpt, extra, dev, frames, flood,
                                            clients, card, label)
            if label == "bf16":
                inf = served[label].pop("inference")
                pre = CerberusPreprocessor(img_size=imgsz, device=dev)
                ims = [cv2.imdecode(np.frombuffer(d, np.uint8), cv2.IMREAD_COLOR)
                       for d, hw in sequential if hw == (480, 640)]
                batch = pre.preprocess_device(np.stack([ims[i % len(ims)]
                                                        for i in range(max_batch)]))[0]
                entries.append(nms_entry(inf, batch, nc_by_task, 0.25,
                                         f"serve: B {max_batch}, a full batch of the flood's "
                                         f"frames, conf 0.25",
                                         served[label]["launches"]["nms"], card))
                del inf, pre, batch
            served[label].pop("inference", None)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        return entries
    finally:
        shutil.rmtree(root, ignore_errors=True)
        nms.launches, conv_s8.launches, quant_pack_s8.launches = saved


# phase 9: the measurement entry points at headline traffic. The timed loops
# run BENCH_ITERS replays a round (the entry points' own defaults are 20 and
# 10: the headline numbers come from `python -m cerberusdet_tpu_torch.bench`)
BENCH_ITERS = 3
HEADLINE_BATCH, REFERENCE_BATCH = 128, 32


def headline(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640,
             big: int = HEADLINE_BATCH, small: int = REFERENCE_BATCH, iters: int = BENCH_ITERS,
             train_batch: int = TRAIN_BATCH, train_labels: int = TRAIN_LABELS):
    """The measurement entry points at full width (phase 9):
    cerberusdet_tpu_torch.bench's main in int8 and bf16 at batch `big` and
    `small`, tools.bench_serving's main in int8 at batch `small` and
    tools.bench_train_step's main, with their gates. Returns the
    kernels-line entries of the path."""
    import torch

    from cerberusdet_tpu_torch import bench
    from cerberusdet_tpu_torch.ops import conv_int8_cuda, nms_cuda, tal_cuda
    from cerberusdet_tpu_torch.ops import nms as nms_mod
    from cerberusdet_tpu_torch.tools import bench_serving, bench_train_step
    from cerberusdet_tpu_torch.train import loss as loss_mod
    from cerberusdet_tpu_torch.utils import profiling
    from cerberusdet_tpu_torch.utils.profiling import tensor_leaves

    kern = {"conv_s8": conv_int8_cuda.conv_s8, "quant_pack_s8": conv_int8_cuda.quant_pack_s8,
            "nms": nms_cuda.greedy_nms_cuda, "tal_select": tal_cuda.select_kernel,
            "tal_assign": tal_cuda.assign_kernel, "tal_norm": tal_cuda.norm_kernel}
    name_of = {f: k for k, f in kern.items()}
    saved = {k: f.launches for k, f in kern.items()}
    patches = []
    on_card = dev.type == "cuda"

    def patch(obj, name, new):
        patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    def counts():
        return {k: f.launches for k, f in kern.items()}

    def zero():
        for f in kern.values():
            f.launches = 0

    run = {}  # the entry point being driven: its loops, its model, its probe

    class ProbedLoop(profiling.HonestLoop):
        """The entry points' HonestLoop, which records each captured loop's
        launches a replay and its replays, and runs the phase's probe on the
        graph before it is freed (the probe's launches taken back)."""

        def close(self):
            if self.prog is not None:
                run["loops"].append(({name_of[w]: n for w, n in
                                      zip(self.prog.counted, self.prog.launches)},
                                     self.prog.replays))
                if run.get("probe"):
                    before = counts()
                    run["probe"](self)
                    for k, f in kern.items():
                        f.launches = before[k]
            super().close()

    def expected_launches():
        """Each captured loop's launches a replay times its replays and the
        capture's eager run (infer/graphs.py), summed."""
        want = {k: 0 for k in kern}
        for per_replay, replays in run["loops"]:
            for k, n in per_replay.items():
                want[k] += n * (replays + 1)
        return want

    def replay_equals_eager(loop):
        """One replay against the forward run eagerly on the same input, bit
        for bit. Returns the replay's outputs."""
        loop.prog.replay()
        got = [t.clone() for t in tensor_leaves(loop.output)]
        eager = tensor_leaves(loop.fn(loop.x))
        torch.cuda.synchronize()
        if len(got) != len(eager) or not all(torch.equal(a, b) for a, b in zip(got, eager)):
            raise AssertionError(f"{run['label']}: a replay differs from the forward run "
                                 "eagerly on the same input")
        return got

    def slices_equal(loop):
        """The batch-`big` replay against `big // small` eager forwards of its
        slices, bit for bit (an index that overflows at the large batch
        would show here)."""
        got = replay_equals_eager(loop)
        for i in range(big // small):
            rows = slice(i * small, (i + 1) * small)
            part = tensor_leaves(loop.fn(loop.x[rows]))
            for g, p in zip(got, part):
                if not torch.equal(g[rows], p):
                    diff = (g[rows].double() - p.double()).abs()
                    log(f"[bench] batch {big} vs slice {i}: {int((diff > 0).sum())} of "
                        f"{p.numel()} values differ, largest {float(diff.max()):.3g}")
                    raise AssertionError(f"{run['label']}: the batch-{big} forward differs "
                                         f"from the batch-{small} forwards of its slices")
        run["slices"] = big // small

    def drive(label, argv, probe=None):
        """bench.main(argv) with its launches counted from 0, its model kept
        and `probe` run on its captured loop; returns (result, launches,
        seconds)."""
        run.clear()
        run.update(label=label, loops=[], probe=probe if on_card else None)
        zero()
        t = time.perf_counter()
        result = bench.main(argv + ["--iters", str(iters), "--imgsz", str(imgsz), "--cfg", cfg]
                            + ([] if on_card else ["--device", "cpu"]))
        took = time.perf_counter() - t
        got = counts()
        if on_card and got != expected_launches():
            raise AssertionError(f"{label}: launches {got}, expected {expected_launches()} "
                                 f"(a replay's launches times the replays and the capture)")
        return result, got, took

    real_build = bench.build

    def build(*a, **kw):
        run["model"] = real_build(*a, **kw)
        return run["model"]

    try:
        patch(profiling, "HonestLoop", ProbedLoop)  # the loop of profiling.honest_time
        patch(bench, "build", build)
        n_q = None
        results, entries = {}, []
        for label, argv, probe in (
                (f"int8 batch {big}", ["--batch", str(big)], slices_equal),
                (f"int8 batch {small}", ["--batch", str(small)], replay_equals_eager),
                (f"bf16 batch {big}", ["--batch", str(big), "--bf16"], replay_equals_eager),
                (f"bf16 batch {small}", ["--batch", str(small), "--bf16"],
                 replay_equals_eager)):
            result, launched, took = drive(label, argv, probe)
            model = run.pop("model")
            n_convs, n_int8 = profiling.model_convs(model)
            nodes = result["conv_nodes"]
            if label.startswith("int8"):
                n_q = n_int8
                if not n_int8 or (on_card and (nodes["conv_s8"], nodes["quant_pack_s8"]) != (
                        n_int8, n_int8)):
                    raise AssertionError(f"{label}: graph nodes {nodes} for {n_int8} int8 Convs")
            if on_card and (nodes["convs"] < n_convs or (label.startswith("bf16")
                                                         and nodes["conv_s8"])):
                raise AssertionError(f"{label}: {nodes} conv nodes for {n_convs} convolutions")
            results[label] = result
            ms = result["ms"] if result["ms"] is not None else result["host_ms"]
            log(f"[bench] {label}: {result['metric']} {result['value']} img/s "
                f"(vs_baseline {result['vs_baseline']}), {ms:.3f} ms a forward, host "
                f"{result['host_ms']:.3f} ms ({iters} replays a round, best of 3); graph nodes "
                f"{nodes}, pool {result['pool_mib']} MiB; {n_convs} convolutions, {n_int8} int8; "
                f"the golden check passed; launches {launched}; "
                + ("one replay identical to the eager forward; " if on_card else "")
                + (f"the batch-{big} forward identical to its {run['slices']} batch-{small} "
                   "slices; " if "slices" in run else "")
                + f"main in {took:.1f} s  [{card}]")
            if label.startswith("int8"):
                # both kernels against their plain versions at every distinct conv
                # shape of this batch's forward, each timed by CUDA events
                checked, calls = {}, {}
                x = bench.make_input(result["batch"], imgsz, dev).permute(0, 3, 1, 2)
                with torch.no_grad():
                    val_batch_convs(model, x.to(torch.bfloat16), None, checked, calls)
                (k_conv, k_pack, p_conv, p_pack, conv_bound, pack_bound, n_calls, conv_err,
                 pack_err) = conv_totals(checked, calls)
                log(f"[bench] {label}: conv_s8 and quant_pack_s8 identical to their plain "
                    f"versions at all {len(checked)} distinct conv shapes; one forward's "
                    f"{n_calls} launches of each: conv_s8 {k_conv:.3f} ms (bound {conv_bound:.3f} "
                    f"ms, {100 * conv_bound / k_conv:.1f}%; plain {p_conv:.1f} ms), "
                    f"quant_pack_s8 {k_pack:.3f} ms (bound {pack_bound:.3f} ms, "
                    f"{100 * pack_bound / k_pack:.1f}%; plain {p_pack:.1f} ms), each shape's "
                    f"mean of 5 launches by CUDA events times its calls  [{card}]")
                if result["batch"] == big:
                    for nm, ms_, plain_, bound_, by, err_ in (
                            ("conv_s8", k_conv, p_conv, conv_bound, "operations", conv_err),
                            ("quant_pack_s8", k_pack, p_pack, pack_bound, "bytes", pack_err)):
                        entries.append({
                            "name": f"{nm} (headline bench: one int8 forward at batch {big}, "
                                    f"{imgsz} px, all {n_calls} launches summed)",
                            "route": "cuda", "source": "cerberusdet_tpu_torch/csrc/conv_int8.cu",
                            "replaces": ("cerberusdet_tpu/ops/conv_int8_pallas.py:65"
                                         if nm == "conv_s8" else
                                         "cerberusdet_tpu/nn/module.py:162 (quantize_act, no "
                                         "Pallas kernel; part of conv_s8's redesign)"),
                            "launches": launched[nm], "max_abs_err": err_, "ms": ms_,
                            "plain_ms": plain_, "bound_ms": bound_, "bound_by": by,
                            "library_ms": None})
                del x
            del model
            if on_card:
                torch.cuda.empty_cache()
        patch(bench, "build", real_build)

        # ---- bench_serving, int8 "all" at batch `small`: the NMS kernel per stage
        captured = {}
        real_nms = nms_mod.greedy_nms_cuda

        def nms(boxes, scores, iou_thres, max_det):
            if "nms" not in captured:
                captured["nms"] = (boxes.clone(), scores.clone(), iou_thres, max_det)
            return real_nms(boxes, scores, iou_thres, max_det)

        patch(nms_mod, "greedy_nms_cuda", nms)
        run.clear()
        run.update(label="bench_serving", loops=[])
        zero()
        t = time.perf_counter()
        staged = bench_serving.main(["--batch", str(small), "--iters", str(iters), "--imgsz",
                                     str(imgsz), "--cfg", cfg]
                                    + ([] if on_card else ["--device", "cpu"]))
        took = time.perf_counter() - t
        served = counts()
        if on_card:
            want = expected_launches()
            stages = [per for per, _ in run["loops"]]
            if served != want or [s["nms"] for s in stages] != [0, len(TASKS), len(TASKS)] \
                    or any(s["conv_s8"] != n_q for s in stages):
                raise AssertionError(f"bench_serving: launches {served}, expected {want}; a "
                                     f"replay's launches by stage {stages}")
        log(f"[bench_serving] int8 all, batch {small}, {imgsz} px, conf 0.25: {staged}; "
            f"launches {served} (NMS: tasks x (replays + the capture's eager run) of the "
            f"two stages with NMS; conv_s8 and quant_pack_s8: {n_q} a forward); main in "
            f"{took:.1f} s  [{card}]")
        boxes, scores, iou, max_det = captured["nms"]
        entries.append(nms_kernel_entry(
            boxes, scores, iou, max_det, "bench_serving: int8 all, conf 0.25", served["nms"],
            card))

        # ---- bench_train_step: the plain assigner, then the TAL kernels
        real_assign = loss_mod.task_aligned_assign

        def assign(*a, **kw):
            if kw.get("use_kernel") and "tal" not in captured:
                captured["tal"] = ([v.detach().clone() for v in a[:6]], kw["num_classes"])
            return real_assign(*a, **kw)

        patch(loss_mod, "task_aligned_assign", assign)
        zero()
        t = time.perf_counter()
        stepped = bench_train_step.main(["--batch", str(train_batch), "--iters", str(iters),
                                         "--max-labels", str(train_labels), "--imgsz",
                                         str(imgsz), "--cfg", cfg]
                                        + ([] if on_card else ["--device", "cpu"]))
        took = time.perf_counter() - t
        trained = counts()
        steps = (bench_train_step.WARMUP_STEPS + iters) * bench_train_step.TURNS.count("pallas")
        want = {k: len(TASKS) * steps if on_card else 0 for k in TAL_KERNELS}
        if {k: trained[k] for k in TAL_KERNELS} != want:
            raise AssertionError(f"bench_train_step: TAL launches {trained}, expected {want} "
                                 "(once per task and step of the kernels' runs)")
        if stepped["loss_rel_diff"] > 1e-5:
            raise AssertionError(f"bench_train_step: the routes' first-step losses differ by "
                                 f"{stepped['loss_rel_diff']} (limit 1e-5)")
        log(f"[bench_train_step] per-task batch {train_batch}, {imgsz} px, {train_labels} gt "
            f"rows: {stepped}; TAL launches {want} (the kernels' two runs, once per task and "
            f"step, none on the plain route's); main in {took:.1f} s  [{card}]")
        args, nc = captured["tal"]
        entries.extend(tal_entries(args, nc, {k: trained[k] for k in TAL_KERNELS},
                                   "bench_train_step", card))
        return entries
    finally:
        for obj, name, orig in reversed(patches):
            setattr(obj, name, orig)
        for k, f in kern.items():
            f.launches = saved[k]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from cerberusdet_tpu_torch.infer import CerberusDetInference, CerberusPreprocessor
    from cerberusdet_tpu_torch.infer.graphs import CapturedProgram
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.ops import conv_int8_cuda, nms_cuda, tal_cuda
    from cerberusdet_tpu_torch.ops.nms import (
        cross_task_suppress,
        non_max_suppression,
        select_candidates,
    )
    from cerberusdet_tpu_torch.testing import (
        boundary_candidates,
        crowded_tal_scene,
        duplicate_candidates,
        norm_scene,
        random_candidates,
        sparse_tal_scene,
        tal_scene,
        tied_tal_scene,
        train_batches,
    )
    from cerberusdet_tpu_torch.train.loss import DetectionLoss
    from cerberusdet_tpu_torch.train.schedules import warmup_lrs
    from cerberusdet_tpu_torch.train.step import MultiTaskTrainer, init_train_state
    from cerberusdet_tpu_torch.utils.profiling import card_name_power, pool_mib

    torch.set_grad_enabled(False)  # serving; the train phases enable it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_name_power()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  card: {card}")

    # ---- 1. build: one nvcc per source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(lambda m: m.build(verbose=True),
                             (nms_cuda, tal_cuda, conv_int8_cuda)))
    log(f"[build] {', '.join(os.path.relpath(p, ROOT) for p in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 2. kernels against plain, on the card
    cases = [
        ("K8400 thr0.45 ties zero-tail class-offset",
         random_candidates(8, 8400, seed=1, zeros_from=6000, classes=20), 0.45),
        ("K8400 thr0.7 ties", random_candidates(8, 8400, seed=2), 0.7),
        ("K16384 thr0.45", random_candidates(8, 16384, seed=3, classes=3), 0.45),
        ("K16384 thr0.7 zero-tail", random_candidates(8, 16384, seed=4, zeros_from=9000), 0.7),
        ("boundary thr0.45", boundary_candidates(0.45, n=16)[:2], 0.45),
        ("boundary thr0.7", boundary_candidates(0.7, n=16)[:2], 0.7),
        ("K8400 thr0.45 negative scores", random_candidates(
            8, 8400, seed=5, low=-0.5, classes=20), 0.45),
        ("K2000 thr0.45 100 positives among negatives (the kernel's tail loop)",
         random_candidates(8, 2000, seed=6, zeros_from=100, low=-0.5, size=(40, 200)), 0.45),
        ("K8400 thr0.45 all positive", random_candidates(8, 8400, seed=7, low=0.01,
                                                         classes=20), 0.45),
        ("B1 K8400 thr0.45", random_candidates(1, 8400, seed=8, classes=20), 0.45),
        ("K16384 thr0.7 all positive (slots beyond shared memory)",
         random_candidates(8, 16384, seed=9, low=0.01), 0.7),
        ("K16384 thr0.45 all positive, large boxes (survivors back into shared memory)",
         random_candidates(8, 16384, seed=10, low=0.01, size=(150, 400)), 0.45),
        ("K8400 thr0.45 duplicates with tied scores", duplicate_candidates(8, 8400, seed=11),
         0.45),
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

    tal_cases = [(f"random{i}", tal_scene(i), 7) for i in range(3)] + [
        ("dense", tal_scene(5, dense=True, M=16), 7),
        ("empty image", tal_scene(3, empty_first=True), 7),
        ("M40", tal_scene(7, M=40, N=384), 7),
        ("tied zeros", tied_tal_scene(0), 5),
        ("tied zeros B3 M16", tied_tal_scene(1, B=3, M=16), 5),
        ("crowded: most anchors claimed by several gts", crowded_tal_scene(0), 7),
        ("sparse N333: a row with fewer than k inside anchors", sparse_tal_scene(4), 7),
        ("N 5, below k", sparse_tal_scene(5, N=5), 7),
        ("N 8400, not a multiple of 32", sparse_tal_scene(6, N=8400, M=40), 7),
    ]
    tal_err = {"tal_select": 0, "tal_assign": 0.0, "tal_norm": 0.0}
    for name, scene, nc in tal_cases:
        inp = tal_cuda.kernel_inputs(*[torch.from_numpy(x).to(dev) for x in scene], nc)
        err, pos = tal_compare(inp, nc)
        tal_err = {k: max(v, err[k]) for k, v in tal_err.items()}
        log(f"[tal kernels vs plain] {name}: B,M,N={tuple(pos.shape)} positives "
            f"{int(pos.sum())} max|diff| {err}")

    norm_cases = [("the flagship's B 8, N 8400, nc 20", 8, 8400, 20, 0.3),
                  ("nc 19", 8, 8400, 19, 0.3), ("nc 1", 3, 333, 1, 0.5),
                  ("an all-background batch", 8, 8400, 20, 0.0),
                  ("B * N 999, not a multiple of 256", 3, 333, 19, 0.3)]
    for name, b, n, nc, share in norm_cases:
        t = [torch.from_numpy(x).to(dev) for x in norm_scene(n + nc, b, n, 12, nc, share)]
        tal_err["tal_norm"] = max(tal_err["tal_norm"], norm_compare(*t, nc))
        log(f"[tal_norm vs plain] {name}: B,N,nc=({b}, {n}, {nc}), {int(t[1].sum())} fg "
            f"anchors: identical")

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
    first_requests(inf, pre, frames, "bf16", card)
    programs = dict(inf.programs)
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
    if inf.programs != programs or sum(p.replays for p in programs.values()) != n_requests + 2:
        raise AssertionError("the requests did not replay the graphs captured by the first "
                             "request of each batch size")
    for bs, times in per_bs.items():
        ms = 1e3 * float(np.median(times))
        log(f"[main] batch {bs}: {ms:.2f} ms/request (median of {len(times)}, replayed, "
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

    # the same batches with the plain NMS loop on the card: identical results
    for batch, shapes, _ in (served[0], served[-1]):
        out = inf.predict(batch, original_shape=shapes)
        plain = inf.predict(batch, original_shape=shapes, use_kernel=False)
        same_results(out, plain, score_rtol=0.0)
    log("[main] batch 1 and batch 8 with the plain NMS loop on the card: identical results")

    # the captured programs: one per key, each replay identical with an eager run
    args = (CONF, 0.45, 0.8, False, 300)
    for bs in (1, 8):
        for imgs in frames[bs][:2]:  # the capturing request, then other frames
            replay_matches_eager(inf, pre.preprocess(imgs)[0], args)
    bt1 = pre.preprocess(frames[1][0])[0]
    replay_matches_eager(inf, bt1, (CONF, 0.5, 0.8, False, 300))
    keys = {inf.program_key(bt1, *args), inf.program_key(served[-1][0], *args),
            inf.program_key(bt1, CONF, 0.5, 0.8, False, 300)}
    if set(inf.programs) != keys or any(inf.programs[k] is not p for k, p in programs.items()):
        raise AssertionError(f"bf16: {len(inf.programs)} programs for {len(keys)} keys")
    log(f"[graphs] bf16: replayed == predict_device run eagerly, bit for bit, at batch 1 and "
        f"8, for the capturing request and one with other frames; iou_thres 0.5 captured a "
        f"new key: {len(inf.programs)} captures for {len(keys)} distinct keys; graph pool "
        f"{pool_mib(inf._pool):.1f} MiB  [{card}]")

    # the preprocessor: one letterbox graph per source shape and batch, at most 4 shapes
    for hw in [(720, 1280), (1080, 1920), (640, 640)]:
        imgs = list(rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8))
        out, _ = pre.preprocess(imgs)
        eager = pre._device_fn(*hw)(torch.from_numpy(np.stack(imgs)).to(dev))
        if not isinstance(out, torch.Tensor) or not torch.equal(out, eager):
            raise AssertionError(f"the device letterbox of {hw} differs from its eager run")
    fifth, _ = pre.preprocess(list(rng.integers(0, 256, (2, 300, 400, 3), dtype=np.uint8)))
    if not isinstance(fifth, np.ndarray) or len(pre._device_fns) != 4:
        raise AssertionError("a fifth source shape did not take the host letterbox")
    log(f"[graphs] preprocessor: 4 source shapes letterboxed on the card, each replay "
        f"identical with its eager run ({len(pre._programs)} graphs); a fifth shape took the "
        f"host path")

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
        # the same stages each captured alone and replayed: their device time
        fwd_g = CapturedProgram(inf.model, x, dev, None)
        ct_g = CapturedProgram(lambda m: cross_task_suppress(m, task_idx, 0.8, scan_rows=300),
                               merged, dev, None)
        log(f"[stages, replayed] batch {bs}: forward {cuda_ms(fwd_g.graph.replay, iters=5):.3f} "
            f"ms, cross-task {cuda_ms(ct_g.graph.replay, iters=5):.3f} ms (each stage captured "
            f"alone, CUDA events around 5 replays)  [{card}]")
        del fwd_g, ct_g

    for bs in (1, 8):
        graph_timings(inf, pre.preprocess(frames[bs][0])[0], args, card, "bf16")

    # kernel at the main path's shapes: the candidates of the last batch-8 request
    task_ms = {}
    for task in TASKS:
        pred = inf.model(served[-1][0].permute(0, 3, 1, 2).to(torch.bfloat16))[task][0]
        _, conf, _, offset_boxes = select_candidates(
            pred, len(names[task]), CONF, False, None, nms_cuda.MAX_K, False)
        k_ms, how = kernel_ms(lambda: nms_cuda.greedy_nms_cuda(offset_boxes, conf, 0.45, 300),
                              20, "nms_kernel")
        call_ms = cuda_ms(lambda: nms_cuda.greedy_nms_cuda(offset_boxes, conf, 0.45, 300),
                          iters=20)
        p_ms = cuda_ms(lambda: nms_cuda.greedy_nms(offset_boxes, conf, 0.45, 300), iters=3,
                       warmup=1)
        ops, steps = nms_work(offset_boxes, conf, 0.45, 300)
        task_ms[task] = (k_ms, p_ms, ops, steps, tuple(conf.shape))
        log(f"[nms at main-path shapes] {task}: B,K={tuple(conf.shape)} kernel {k_ms:.4f} ms"
            f" ({how}), a wrapper call {call_ms:.4f} ms (events), plain {p_ms:.3f} ms, "
            f"steps per image {steps}  [{card}]")
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

    # ---- 3b. the int8 serving path at full width
    kernels.extend(serve_int8(inf, pre, frames, served, names, card, dev))

    del inf, model, preds, served, programs, pre
    torch.cuda.empty_cache()

    # ---- 4. the train path at full width
    torch.set_grad_enabled(True)
    t0 = time.perf_counter()
    model = CerberusModel(FLAGSHIP, TASKS, NCS, device=dev).init(seed=0)
    losses = {t: DetectionLoss(nc=nc, strides=model.strides) for t, nc in zip(TASKS, NCS)}
    trainer = MultiTaskTrainer(model, losses, compute_dtype=torch.bfloat16, device=dev)
    state = init_train_state(model)
    batches = {t: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for t, b in train_batches(TASKS, NCS, TRAIN_BATCH, 640, TRAIN_LABELS,
                                         TRAIN_REAL, seed=0).items()}
    log(f"[train] yolov8x_2task, bf16 compute, per-task batch {TRAIN_BATCH}, "
        f"{TRAIN_LABELS} gt rows ({TRAIN_REAL} real), set up in "
        f"{time.perf_counter() - t0:.2f} s")

    # the TAL kernels at the train path's shapes, on the flagship's predictions
    model.eval()
    with torch.no_grad():
        x = batches[TASKS[0]]["img"].permute(0, 3, 1, 2).to(torch.bfloat16)
        feats = model(x, tasks=[TASKS[0]])[TASKS[0]][1]
    loss0 = losses[TASKS[0]]
    args = loss0.assign_args(loss0.decode(feats, batches[TASKS[0]]))
    flag_inp = tal_cuda.kernel_inputs(*args, NCS[0])
    err, flag_pos = tal_compare(flag_inp, NCS[0])
    tal_err = {k: max(v, err[k]) for k, v in tal_err.items()}
    log(f"[tal kernels vs plain] flagship {TASKS[0]}: B,M,N={tuple(flag_pos.shape)} "
        f"positives {int(flag_pos.sum())} max|diff| {err}")
    del feats, x

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    for kern in (tal_cuda.select_kernel, tal_cuda.assign_kernel, tal_cuda.norm_kernel):
        kern.launches = 0
    step_times, items_log = [], []
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 2**30  # before the first step, earlier phases' too
    for ni in range(WARMUP_STEPS + TIMED_STEPS):
        lrs, mom = warmup_lrs(ni, 100, 0.0, 0.01, 1.0)
        timed = ni >= WARMUP_STEPS
        torch.cuda.synchronize()
        t = time.perf_counter()
        if timed:
            mark("start")
        state, items = trainer.step(state, batches, lrs, mom, mark=mark if timed else None)
        torch.cuda.synchronize()
        if timed:
            step_times.append(time.perf_counter() - t)
        vals = {k: [float(v) for v in it] for k, it in items.items()}
        items_log.append(vals)
        if not all(np.isfinite(v) for it in vals.values() for v in it):
            raise AssertionError(f"non-finite losses at step {ni}: {vals}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    tal_launches = {"tal_select": tal_cuda.select_kernel.launches,
                    "tal_assign": tal_cuda.assign_kernel.launches,
                    "tal_norm": tal_cuda.norm_kernel.launches}
    n_steps = WARMUP_STEPS + TIMED_STEPS
    log(f"[train] {n_steps} steps, TAL kernel launches {tal_launches} (expected "
        f"{len(TASKS) * n_steps} each: tasks x steps)")
    if any(v != len(TASKS) * n_steps for v in tal_launches.values()):
        raise AssertionError("the train path did not launch every TAL kernel once per task "
                             "and step")
    log(f"[train] losses (box, cls, dfl, total) first step {items_log[0]}, last step "
        f"{items_log[-1]}")
    stage = {"forward_loss": 0.0, "backward": 0.0, "update": 0.0}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        if name in stage:
            stage[name] += a.elapsed_time(b) / TIMED_STEPS
    step_ms = 1e3 * float(np.median(step_times))
    log(f"[train] step {step_ms:.2f} ms (median of {TIMED_STEPS}, host clock), "
        f"{2 * TRAIN_BATCH / step_ms * 1e3:.1f} img/s, peak memory {peak_gb:.2f} GiB, of which "
        f"{held_gb:.2f} GiB was allocated before the first step  [{card}]")

    # each TAL kernel and plain stage alone at the flagship shapes
    beta = 6
    sel = tal_cuda.select_kernel(flag_inp, 10, beta)
    tgt, fg, lab, _, al, pos = tal_cuda.assign_kernel(flag_inp, sel, beta)
    plain = tal_cuda.TaskAlignedAssigner(10, NCS[0])
    labels = flag_inp["labels"].clamp(0, NCS[0] - 1)
    planes = plain.select_topk(flag_inp["scores"], flag_inp["pd_bboxes"], flag_inp["anchors"],
                               labels, flag_inp["gt_bboxes"], flag_inp["mask_gt"])
    tgt_p, fg_p, mp_p, pa_p, po_p = plain.resolve(*planes)
    t_lab = labels.gather(1, tgt_p)
    launch = {
        "tal_select": lambda: tal_cuda.select_kernel(flag_inp, 10, beta),
        "tal_assign": lambda: tal_cuda.assign_kernel(flag_inp, sel, beta),
        "tal_norm": lambda: tal_cuda.norm_kernel(tgt, fg, lab, al, pos, NCS[0], 1e-9),
    }
    plain_stage = {
        "tal_select": lambda: plain.select_topk(flag_inp["scores"], flag_inp["pd_bboxes"],
                                                flag_inp["anchors"], labels,
                                                flag_inp["gt_bboxes"], flag_inp["mask_gt"]),
        "tal_assign": lambda: plain.resolve(*planes),
        "tal_norm": lambda: plain.normalise(t_lab, fg_p, mp_p, planes[2], pa_p, po_p,
                                            torch.float32),
    }
    tal_ms = {}
    for name in launch:
        k_ms, how = kernel_ms(launch[name], 20, name + "_kernel")
        tal_ms[name] = (k_ms, cuda_ms(plain_stage[name], iters=3), how,
                        cuda_ms(launch[name], iters=20))
    assign_ms = cuda_ms(lambda: tal_cuda.task_aligned_assign(*args, num_classes=NCS[0]),
                        iters=20)
    plain_assign_ms = cuda_ms(lambda: tal_cuda.task_aligned_assign(
        *args, num_classes=NCS[0], use_kernel=False), iters=3)
    for name, (k_ms, p_ms, how, call_ms) in tal_ms.items():
        log(f"[tal at main-path shapes] {name}: kernel {k_ms:.4f} ms ({how}), a wrapper "
            f"call {call_ms:.4f} ms (events), plain stage {p_ms:.3f} ms  [{card}]")
    log(f"[train stages] per step: forwards + loss {stage['forward_loss']:.2f} ms (of which "
        f"the assigner {len(TASKS) * assign_ms:.3f} ms: {len(TASKS)} x {assign_ms:.4f} ms, "
        f"kernels and their glue), backward {stage['backward']:.2f} ms, clip + optimizer + "
        f"EMA {stage['update']:.2f} ms; the plain assigner would take {plain_assign_ms:.3f} "
        f"ms a task  [{card}]")
    for kern in (tal_cuda.select_kernel, tal_cuda.assign_kernel, tal_cuda.norm_kernel):
        kern.launches = len(TASKS) * n_steps  # the comparison and timing launches do not count

    # one step from the same state with the plain assigner: the same losses
    snap = snapshot(state)
    _, items_k = trainer.step(state, batches, *warmup_lrs(n_steps, 100, 0.0, 0.01, 1.0))
    restore(state, snap)
    for loss in losses.values():
        loss.use_kernel = False
    _, items_p = trainer.step(state, batches, *warmup_lrs(n_steps, 100, 0.0, 0.01, 1.0))
    for loss in losses.values():
        loss.use_kernel = True
    worst = 0.0
    for t in TASKS:
        for a, b in zip(items_k[t], items_p[t]):
            rel = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
            worst = max(worst, rel)
            if rel > 1e-5:
                raise AssertionError(f"{t}: kernel-assigner loss {float(a)} vs plain {float(b)}")
    log(f"[train] one step with the plain assigner from the same state: losses within "
        f"rtol {worst:.3g} (limit 1e-5)")
    tal_work_flag = tal_work(flag_inp, flag_pos, NCS[0])
    del state, trainer, model, batches, snap, planes
    torch.cuda.empty_cache()

    for name in ("tal_select", "tal_assign", "tal_norm"):
        ops, nbytes = tal_work_flag[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cerberusdet_tpu_torch/csrc/tal.cu",
            "replaces": ("cerberusdet_tpu/ops/tal_pallas.py:146" if name == "tal_norm"
                         else "cerberusdet_tpu/ops/tal_pallas.py:99"),
            "launches": tal_launches[name],
            "max_abs_err": tal_err[name],
            "ms": tal_ms[name][0],
            "plain_ms": tal_ms[name][1],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,  # no PyTorch call computes a task-aligned assignment
        })

    # ---- 5. against a reference on a small input: card float64 vs CPU float64
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
    args = (CONF, 0.45, 0.8, False, 300)
    replay_matches_eager(on_card, xs, args)
    xb = torch.from_numpy(xs)
    before = on_card.programs[on_card.program_key(xb, *args)].run(xb).clone()
    bias = on_card.model.block(on_card.model.head_uid("a")).cls0[2].b
    with torch.no_grad():
        bias.copy_(bias + 0.5)  # in place: the graph reads the same tensor
    replay_matches_eager(on_card, xs, args)
    after = on_card.programs[on_card.program_key(xb, *args)].run(xb)
    if torch.equal(before, after) or len(on_card.programs) != 1:
        raise AssertionError("the replay did not see an in-place weight update")
    log("[graphs] float64: replayed == predict_device run eagerly, bit for bit, before and "
        "after an in-place update of a Detect bias, which the replay sees; 1 capture")

    # one train step, float64, the same state and batches on the card and the CPU.
    # The BatchNorm statistics are float32 sums (as in the JAX package), which
    # the card (and cuDNN's backward) takes in another order than the CPU; the
    # port against itself with only that order changed moves the losses by
    # ~4e-6 and each tensor by ~3e-4 of its change (python tests/test_torch_train.py).
    small_batches = train_batches(["a", "b"], [3, 5], 2, 64, 8, 4, seed=6)
    ref_step = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        m = CerberusModel(SMALL, ["a", "b"], [3, 5], device="cpu").init(seed=2)
        m = m.to(device=where, dtype=torch.float64)
        init_sd = {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
        tr = MultiTaskTrainer(m, {t: DetectionLoss(nc=nc, strides=m.strides)
                                  for t, nc in (("a", 3), ("b", 5))},
                              compute_dtype=torch.float64, device=where)
        st, it = tr.step(init_train_state(m), small_batches,
                         *warmup_lrs(1, 4, 0.0, 0.01, 1.0))
        ref_step[label] = ({t: [float(v) for v in x] for t, x in it.items()},
                                {k: v.detach().cpu() for k, v in m.state_dict().items()})
    (it_card, sd_card), (it_cpu, sd_cpu) = ref_step["card"], ref_step["cpu"]
    for t in ("a", "b"):
        np.testing.assert_allclose(it_card[t], it_cpu[t], rtol=3e-5)
    worst = close_updates(sd_card, sd_cpu, init_sd, 5e-3, "float64 train step")
    log(f"[reference] yolov8n_2task 64 px float64 train step: card == CPU, losses "
        f"{it_card} vs {it_cpu}, tensors within {worst:.3g} of their change (limit 5e-3)")

    # ---- 6. the validation path at full width
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    kernels.extend(validate(card, dev))
    log(f"[val] phase in {time.perf_counter() - t0:.1f} s")

    # ---- 7. the train entry point at full width
    torch.set_grad_enabled(True)
    t0 = time.perf_counter()
    kernels.extend(train_cli(card, dev))
    log(f"[train cli] phase in {time.perf_counter() - t0:.1f} s")

    # ---- 8. the serving entry points at full width
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    kernels.extend(entry_points(card, dev))
    log(f"[entry points] phase in {time.perf_counter() - t0:.1f} s")

    # ---- 9. the measurement entry points at headline traffic
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[bench] {torch.cuda.memory_allocated() / 2**30:.2f} GiB held by earlier phases")
    t0 = time.perf_counter()
    kernels.extend(headline(card, dev))
    log(f"[bench] phase in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
