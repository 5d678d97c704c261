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
  4. train the flagship at 640 px, bf16 compute, per-task batch 8, 300 gt
     rows of which 40 are real, seeded batches and init, with warmup lrs and
     momentum that change every step: 2 + 10 eager steps
     (MultiTaskTrainer.raw_step, stage by stage) against the captured step
     (MultiTaskTrainer.step: the key's first call runs the step eagerly and
     captures it, then 12 replays), each with its device-busy share, peak
     memory and the step's graph pool; finite losses; every TAL kernel
     launched once per task and step (a replay once per task); one capture
     per key for {voc, animals}, {voc} alone and {voc, animals} with
     freeze_shared, each used twice; 6 replays bit for bit with 6 raw_steps
     from one snapshot under deterministic algorithms (losses, parameters,
     BN buffers, momentum buffers, EMA); a replaced momentum buffer makes the
     replay raise; one step from the same state with the plain assigner,
     under a key of its own, launching no TAL kernel and giving the same
     losses;
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
     summed over one int8 batch. The eval forward runs eagerly; a
     forward captured per shape, which run_task does not take, is measured
     by hand (eval_graphs, below);
  7. train the flagship through the train entry point (cli/train.py:main):
     the seeded model (BatchNorm statistics from 8 train images) as
     --weights, 24 train and 8 val seeded labelled JPEGs a task, the
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
     plain versions on the first inputs the path gave them. The steps replay
     the captured step. Prints the step time, the step call's host time and
     the loop iteration unsynchronised (run A), the host's wait for data,
     the device-busy share of the unsynchronised loop, host augmentation per
     image, the decoder, val and save times, the step's graph pool, peak
     memory and main's wall. Run A also draws what a JAX train run draws
     (utils/plots.py): the first 3 train batches a task, the final val's
     label and prediction mosaics, and where matplotlib is installed the
     label statistics, PR curves and confusion matrices; each decodes, and
     the first train mosaic equals the one drawn again from the host copy
     of its batch, on the CPU and from the card, bit for bit;
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
     once per task and replay; the train-step routes (each timed eagerly,
     then as back-to-back replays of the captured step) agree on their first
     losses within 1e-5 and the kernels' route launches each TAL kernel once
     per task and step;
 10. drive the training data path's routes at full width over
     tools/bench_train_e2e's seeded set (32 noise JPEGs of 640 px a task,
     the packed disk cache): each warp route of the augmentation on the card
     on a batch of 8 (matmul for the default hyps, affine3 for the paper's,
     gather at perspective 0.0005) equal to the CPU's augmentation of the
     same collated plans within the CPU tests' bound (2 levels on < 1% of
     values), the resident form equal to the shipped form bit for bit, each
     timed; the one-sample blur / median variants within the same bound;
     integer-translation warps on every route equal to the host cv2 items
     bit for bit; 4 worker processes' batches equal to 8 threads' (sha1 of
     img and labels); bench_loader on 8 and 4 threads, 4 and 8 processes
     and the card; bench_train_e2e host and device for the default and the
     paper's hyps, whose device runs feed the step the host runs' labels
     (sha1 a task and step) and launch each TAL kernel once per task and
     step. Prints each route's device ms, the loaders' img/s and the e2e
     img/s, the host's wait a step and the loop's busy share;
 11. carry int8 between the blocks (quant/ptq.py:propagate_act_quant, which
     every int8 entry point runs): the flagship in bf16 + int8 "all" at
     batch 1 and 8, 3 replayed requests each, beside a copy of the same
     quantized model without annotations: responses and packed device
     outputs identical; conv_s8 and quant_pack_s8 once per quantized Conv
     and request, conv_s8 requantizing bf16(y) in its epilogue for every
     annotated block whose last Conv is int8 (no quantize of its own); each
     annotated block's int8 output equal to the CPU's quantize_act of the
     unannotated block's; conv_s8 against its plain version at every
     distinct conv shape and mode of a propagated forward (the new mode is
     also in every earlier conv_s8 comparison). The headline forward
     (bench.build) at batch 32 and 128 with and without the annotations,
     each captured and replayed with the conv-node guard and the requantize
     guard: ms, img/s, conv_s8 / quant_pack_s8 / concat / pool device time
     and the graph pool. The int8 max pool (its bf16 route on the card) and
     the integer route of grouped / 5x5 convs against the CPU; the zoo model
     (every block of the main registry) served in int8 on the card,
     propagated == unannotated;
 12. drive ROADMAP item 9's user surface: the genetic evolver through the
     train CLI's options (2 generations of 1 epoch, bf16, batch 8,8, on 16
     train / 8 val seeded JPEGs a task, seed 0): evolve.json holds both,
     generation 2's hyps lie in DEFAULT_META's bounds, differ from
     generation 1's and equal a host replay of the mutation from its logged
     results; each generation launches the TAL kernels once per task and
     step (and per val batch with losses) and NMS once per val batch and
     task, and its peak memory does not grow by a step pool; the checkpoint
     Ensemble of two seeded flagships (attempt_load) on a batch of 8
     letterboxed 480x640 frames, its 16800 candidates a task clamped to the
     NMS kernel's 16384, detections identical with the plain loop's, one NMS
     launch a task; tools/bench_c2f_split at batch 32 in bf16 and int8
     "all": the split equal to the concat route (float32 within 1e-4 at 128
     px; int8 bit for bit), conv_s8 launches a forward 143 against the
     split's, both variants timed with the headline's method and the
     split's own conv-node guard, conv_s8's int32 mode against its plain
     version and torch._int_mm at the split's largest chunk conv. Logs
     which optional packages (matplotlib, mlflow, ray, orbax, tensorstore)
     the machine has;
 13. data parallelism (parallel/mesh.py and its callers), on the one card:
     (a) the seeded flagship served over make_mesh([cuda:0, cuda:0]), two
     replicas, a batch of 8 seeded 480x640 frames split 4 + 4, in bf16 and
     int8 "all" (propagated), against one replica of the same weights: int8
     identical, bf16 matched (matched_detections, >= DP_SERVE_MATCH, the
     matched scores within DP_SERVE_SCORE and boxes within DP_SERVE_BOX
     px); NMS once per task and replica, conv_s8
     and quant_pack_s8 once per quantized Conv and replica, a program per
     replica; both int8 kernels against their plain versions at a replica's
     conv shapes; a request's ms against one replica's; then cli.serve
     --mesh (the visible cards) answering 8 requests as cli.serve does;
     (b) phase 4's captured step in an NCCL group of one: the all-reduces
     recorded into the capture counted (4 a BatchNorm the task forwards
     run, 2 a task's loss, 1 the gradients; NCCL reduces a group of one in
     place, with no kernel), 3 replays == 3 raw_steps bit for bit under
     deterministic algorithms, the first step and every state tensor after
     4 steps == the group-less step's bit for bit, TAL once per task and
     step, a replay's ms against the group-less replay's; (c) NCCL's
     refusal of two ranks on one card
     printed, then two Gloo ranks in processes of their own on cuda:0, the
     global per-task batch of 8 split 4 + 4, float32 (TF32 off), 2 eager
     raw_steps: the ranks' states identical (sha1 of every tensor), each
     step against one process's step over the 8 rows from the same state
     (losses within DP_LOSS_RTOL, each state tensor within DP_STATE_FRAC of
     that step's change or twice its gap in one process's step over the
     rows reversed; a batch-8 eval forward against 4 + 4 and the
     free-running drift printed), TAL once per task,
     step and rank, the captured step's refusal of a Gloo group; (d) the
     same two ranks run cli.val's main on phase 6's val set cut to 32 images
     a task (batch 8, rect: whole batches a rank): every rank reports the
     one-process val's metrics over the same statistics in rank order
     exactly, and over its own order within DP_VAL_TIE_TOL (tied
     confidences); NMS once per batch and task of a rank's shard.
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
import warnings

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
WARMUP_STEPS, TIMED_STEPS = 2, 10


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


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms: `iters` calls captured in one CUDA
    graph, one replay between CUDA events, so the host's launch cost of
    each call is not in it. fn must be capturable (no host sync)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int, name: str):
    """(device ms, source) of the kernel whose name contains `name`, per
    call of fn(), which launches it once: the kernel's own time on the card
    from the profiler's CUDA trace, the mean over the launches it recorded.
    Where the trace shows no such kernel, the mean time of a call in a CUDA
    graph of `iters` calls (graph_ms), and source says so."""
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
    return graph_ms(fn, iters), f"events around a CUDA graph of {iters} calls (the profiler " \
                                "saw no kernel)"


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
                  "conv_s8": "conv_s8_kernel", "quant_s8": "quant_nchw_kernel"}


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
    """Put `snapshot`'s values back, in place: a captured step reads the
    state's tensors at the addresses it captured."""
    import torch

    model_sd, ema_sd, opt, n = snap
    state.model.load_state_dict(model_sd)
    state.ema.load_state_dict(ema_sd)
    with torch.no_grad():
        for bufs, saved in ((state.opt_state.momentum_buf, opt.momentum_buf),
                            (state.opt_state.second_moment, opt.second_moment)):
            for k, v in (saved or {}).items():
                bufs[k].copy_(v)
    state.opt_state.step = opt.step
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
    against conv_s8_plain on the same inputs in each of its five epilogue
    modes: int32, float32, bfloat16, int8 of y and int8 of the bf16-rounded
    y (the scale a float32 tensor on the card, read there).
    Returns the largest |kernel - plain| over them; raises, after printing
    the count of differing elements and the largest ulp or step, on any
    difference."""
    import torch

    from cerberusdet_tpu_torch.ops.conv_int8_cuda import conv_s8, conv_s8_plain

    pad = w_q.shape[1] // 2
    plain32 = conv_s8_plain(xq, w_q, s_x, s_w, bias, stride, pad, act, torch.float32)
    q_scale = max(float(plain32.abs().max()), 1e-6) / 127.0
    q_full = torch.tensor(q_scale, dtype=torch.float32, device=xq.device)
    q_tensor = torch.tensor(0.8 * q_scale, dtype=torch.float32, device=xq.device)
    worst = 0.0
    for dtype, q, q_dtype in ((torch.int32, None, torch.float32),
                              (torch.float32, None, torch.float32),
                              (torch.bfloat16, None, torch.float32),
                              (torch.int8, q_full, torch.float32),
                              (torch.int8, q_tensor, torch.bfloat16)):
        args = (xq, w_q, s_x, s_w, bias, stride, pad, act, dtype, q)
        got = conv_s8(*args, tile=tile, q_dtype=q_dtype)
        ref = conv_s8_plain(*args, q_dtype)
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
            log(f"[conv_s8 vs plain] {dtype} (of {q_dtype}), tile {tile}: {n_diff} of "
                f"{got.numel()} elements differ, {how}")
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
        f"bf16 / int8 of y / int8 of bf16(y): identical (max |diff| {max_err})")
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
            f"{max(ops_ms, bytes_ms):.4f} ms ({100 * max(ops_ms, bytes_ms) / max(k_ms, 1e-9):.1f}%); "
        f"plain "
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
    log(f"[quant_pack_s8 at main-path shapes] x {tuple(x.shape)} {x.dtype} -> (B, H, W, {ci16}) "
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
        "shape": f"{tuple(x.shape)} {str(x.dtype).split('.')[-1]}",
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

    def hook(mod, args, kwargs):
        x = args[0]
        q_out = kwargs.get("q_out")
        q_out = mod.act_quant("q_out") if q_out is None else q_out
        key = (x.shape[0], mod.c1, mod.c2, mod.k[0], mod.s[0], x.shape[2], x.shape[3],
               q_out is not None)
        calls[key] = calls.get(key, 0) + 1
        if key in checked:
            return
        ci16 = mod.w_q.shape[3]
        q_plain = ci.quant_pack_s8_plain(x, mod.s_x, ci16)
        q_kernel = ci.quant_pack_s8(x, mod.s_x, ci16)
        pack_err = int((q_kernel.int() - q_plain.int()).abs().max())
        if pack_err:
            raise AssertionError(f"quant_pack_s8 differs from its plain version at {key}")
        dtype = mod.compute_like.dtype
        out = torch.int8 if q_out is not None else dtype
        q_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
        conv = (q_plain, mod.w_q, mod.s_x, mod.s_w, mod.b, mod.s[0], mod.p[0], bool(mod.act),
                out, q_out, q_dtype)
        got = ci.conv_s8(*conv[:10], q_dtype=q_dtype)
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
                        cuda_ms(lambda: ci.conv_s8(*conv[:10], q_dtype=q_dtype), iters=5),
                        cuda_ms(lambda: ci.quant_pack_s8(x, mod.s_x, ci16), iters=5))

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in model.modules()
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
               for (b, ci, co, k, s, h, w, _), n in calls.items())
    pack_bytes = sum(n * b * h * w * (2 * ci + padded_channels(ci))
                     for (b, ci, co, k, s, h, w, _), n in calls.items())
    return (k_conv, k_pack, p_conv, p_pack, 2 * macs / INT8_OPS_PER_S * 1e3,
            pack_bytes / HBM_BYTES_PER_S * 1e3, sum(calls.values()),
            max(c[2] for c in checked.values()), max(c[3] for c in checked.values()))


# a measurement run by hand, not by main(): the eval forward captured as the
# JAX package jits it per shape, which run_task does not take (PERF.md, Findings):
#   python3 -c "import chip_smoke; chip_smoke.eval_graphs()"
def repeat_set(root: str, src: str, copies: int) -> str:
    """A val set of `copies` hard-linked copies of the images and labels
    under `src` (a write_val_set root): the same native sizes, so that rect
    batches of one shape come in runs. Returns its image directory."""
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub, "val"), exist_ok=True)
        for c in range(copies):
            for f in sorted(os.listdir(os.path.join(src, sub, "val"))):
                if f.endswith((".jpg", ".txt")):
                    os.link(os.path.join(src, sub, "val", f),
                            os.path.join(root, sub, "val", f"{c}_{f}"))
    return os.path.join(root, "images", "val")


def captured_forward(model, task: str):
    """A stand-in for `model` in run_task whose `task` forward is captured
    as JAX jits it per shape, one graph alive at most: a shape's first batch
    eager, its second in a row captured (infer/graphs.py:CapturedProgram,
    whose eager run gives that batch's outputs), the rest of the run
    replayed; a new shape drops the graph. `.kinds` lists each batch's
    ("eager", "capture" or "replay"), `.pools` each graph's pool MiB."""
    import torch

    from cerberusdet_tpu_torch.infer.graphs import CapturedProgram
    from cerberusdet_tpu_torch.ops import conv_int8_cuda as ci
    from cerberusdet_tpu_torch.utils.profiling import pool_mib

    class CapturedForward(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = model
            self.shape = self.program = None
            self.kinds, self.pools = [], []

        def eager(self, x):
            return self.inner(x, tasks=[task])[task]

        def forward(self, x, tasks):
            if tuple(x.shape) != self.shape:
                self.shape, self.program = tuple(x.shape), None
                self.kinds.append("eager")
                return {task: self.eager(x)}
            if self.program is None:
                pool = torch.cuda.graph_pool_handle()
                self.program = CapturedProgram(self.eager, x, x.device, pool,
                                               (ci.conv_s8, ci.quant_pack_s8))
                self.kinds.append("capture")
                self.pools.append(pool_mib(pool))
                return {task: self.program.first}
            self.kinds.append("replay")
            return {task: self.program.run(x)}

    return CapturedForward()


def captured_val(model, label: str, task: str, nc: int, loader, card: str,
                 deterministic: bool = False, pairs: int = 2) -> None:
    """run_task (evaluation/val.py, an eager forward) on `model` for `task`
    over `loader()`'s rect batches, whose shapes come in runs, against
    run_task on captured_forward(model): first with each captured batch's
    forward held bit for bit against the eager forward on the same batch
    (the probe's launches taken back); then `pairs` times an eager run and a
    captured run, in turns, each timed with its peak memory. Every run's
    statistics must be identical, and the int8 kernels launch once per
    quantized Conv and batch. cuDNN as eval_flags sets it, with
    cudnn.deterministic where `deterministic`."""
    import numpy as np
    import torch

    from cerberusdet_tpu_torch.evaluation.val import run_task
    from cerberusdet_tpu_torch.nn.layers import Conv
    from cerberusdet_tpu_torch.ops import conv_int8_cuda as ci

    probe = captured_forward(model, task)
    real_forward = probe.forward

    def checked(x, tasks):
        out = real_forward(x, tasks)[task]
        saved = (ci.conv_s8.launches, ci.quant_pack_s8.launches)
        pred, feats = probe.eager(x)
        if not torch.equal(out[0], pred) or not all(
                torch.equal(a, b) for a, b in zip(out[1], feats)):
            again = probe.eager(x)[0]
            raise AssertionError(
                f"{label} {tuple(x.shape)} ({probe.kinds[-1]}): the forward differs from the "
                f"eager forward by {float((out[0].double() - pred.double()).abs().max())}; two "
                f"eager forwards differ by {float((again.double() - pred.double()).abs().max())}")
        ci.conv_s8.launches, ci.quant_pack_s8.launches = saved
        return {task: out}

    probe.forward = checked
    n_int8 = sum(1 for st in model.plan([task]) for m in model.block(st.uid).modules()
                 if isinstance(m, Conv) and m.int8)
    outs, timed = {}, {"eager": [], "captured": []}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=deterministic, allow_tf32=False):
        for what, m in [("probe", probe)] + [("eager", model), ("captured", None)] * pairs:
            m = m if m is not None else captured_forward(model, task)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = (ci.conv_s8.launches, ci.quant_pack_s8.launches)
            t = time.perf_counter()
            out = run_task(m, task, loader(), nc)
            wall = time.perf_counter() - t
            del m
            launched = (ci.conv_s8.launches - before[0], ci.quant_pack_s8.launches - before[1])
            if launched != (n_int8 * len(out["times"]),) * 2:
                raise AssertionError(f"{label} {what} run: conv_s8 / quant_pack_s8 launched "
                                     f"{launched} times, not once per quantized Conv "
                                     f"({n_int8}) and batch ({len(out['times'])})")
            peak = (torch.cuda.max_memory_allocated() / 2**30,
                    torch.cuda.max_memory_reserved() / 2**30)
            same_val(out, outs.get("probe", out),
                     f"{label}: the {what} run's val against the probe run's")
            outs.setdefault(what, out)
            if what != "probe":
                timed[what].append((wall, [b[2] for b in out["times"]], peak))
    kinds, n = probe.kinds, len(probe.kinds)
    replayed = [i for i, k in enumerate(kinds) if k == "replay"]
    shapes = [tuple(b[0]) for b in outs["probe"]["times"]]
    want = [("eager" if i == 0 or shapes[i - 1] != s else
             "capture" if i == 1 or shapes[i - 2] != s else "replay")
            for i, s in enumerate(shapes)]
    if kinds != want or not replayed:
        raise AssertionError(f"{label}: the batches ran {kinds}, not {want} (a shape's first "
                             "batch eager, its second in a row captured, the rest replayed)")
    log(f"[val graphs] {label}{' (cudnn.deterministic)' if deterministic else ''}: {n} batches "
        f"of {len(set(shapes))} rect shapes: {kinds.count('eager')} eager, "
        f"{kinds.count('capture')} captured, {len(replayed)} replayed "
        f"({100 * len(replayed) / n:.1f}%); each == the eager forward bit for bit, and every "
        f"run's val statistics identical; conv_s8 and quant_pack_s8 {n_int8} launches a batch "
        f"in every run; graph pools (MiB, one alive at a time) "
        + ", ".join(f"{m:.0f}" for m in probe.pools) + f"  [{card}]")
    for what, runs in timed.items():
        for i, (wall, inf, (alloc, reserved)) in enumerate(runs):
            log(f"[val graphs] {label} {what} run {i + 1}: wall {wall:.3f} s, inference stage "
                f"{1e3 * sum(inf):.1f} ms over {n} batches, "
                f"{1e3 * np.mean([inf[j] for j in replayed]):.2f} ms a batch over the "
                f"{len(replayed)} replayed batches' positions, "
                f"{1e3 * np.mean([inf[j] for j in range(n) if j not in replayed]):.2f} over the "
                f"others; peak memory allocated {alloc:.2f} GiB, reserved {reserved:.2f} GiB  "
                f"[{card}]")


def forward_sequence(model, label: str, task: str, loader, card: str) -> None:
    """The task's forward over the rect batch shapes of `loader`'s dataset,
    in order, as run_task calls it (a synchronise after each batch): eager
    and captured_forward, in turns eager, captured, captured, eager, on
    seeded channels-last inputs made on the card (no decode). Logs each
    run's seconds and the batches replayed."""
    import numpy as np
    import torch

    from cerberusdet_tpu_torch.ops import conv_int8_cuda as ci

    ds = loader.dataset
    sizes = np.bincount(ds.batch_index)
    shapes = [(int(n), 3, int(h), int(w)) for n, (h, w) in zip(sizes, ds.batch_shapes)]
    dtype = next(model.parameters()).dtype
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = {s: torch.rand((s[0], s[2], s[3], 3), generator=g, device="cuda").permute(
        0, 3, 1, 2).to(dtype) for s in set(shapes)}
    saved = (ci.conv_s8.launches, ci.quant_pack_s8.launches)
    runs = []
    for capture in (False, True, True, False):
        fwd = captured_forward(model, task) if capture else model
        torch.cuda.synchronize()
        t = time.perf_counter()
        for s in shapes:
            fwd(xs[s], tasks=[task])
            torch.cuda.synchronize()
        runs.append((capture, time.perf_counter() - t,
                     fwd.kinds.count("replay") if capture else 0))
        del fwd
    ci.conv_s8.launches, ci.quant_pack_s8.launches = saved
    log(f"[val graphs] {label} forward over the {len(shapes)} rect batch shapes of "
        f"{len(ds)} images ({len(set(shapes))} shapes), a synchronise a batch: "
        + ", ".join(f"{'captured' if c else 'eager'} {t:.3f} s ({r} replays)" for c, t, r in runs)
        + f"  [{card}]")


def eval_graphs(cfg: str = FLAGSHIP, imgsz: int = 640, batch: int = VAL_BATCH,
                workers: int = 8, copies: int = 10, float32_copies: int = 3,
                sequence_copies: int = 52) -> None:
    """The eval forward captured per shape (captured_forward) against
    run_task's eager forward, on hard-linked copies of one task's seeded val
    set (VAL_IMAGES JPEGs at VAL_SIZES, random labels): captured_val in bf16
    and int8 'all' over `copies` copies and in float32 (cudnn.deterministic)
    over `float32_copies`, and forward_sequence in bf16 and int8 over the
    rect shapes of `sequence_copies` copies (52: 4992 images, about VOC2007
    test's 4952)."""
    import argparse
    import tempfile

    import numpy as np
    import torch
    import yaml

    from cerberusdet_tpu_torch.cli import val as cli
    from cerberusdet_tpu_torch.data.loaders import create_dataloader
    from cerberusdet_tpu_torch.manager.checkpoint import save_checkpoint
    from cerberusdet_tpu_torch.manager.run_manager import parse_data_config
    from cerberusdet_tpu_torch.manager.weights import export_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.ops import conv_int8_cuda, nms_cuda
    from cerberusdet_tpu_torch.quant.ptq import fused_conv_weights
    from cerberusdet_tpu_torch.testing import calibrate_bn, write_val_set
    from cerberusdet_tpu_torch.utils.profiling import card_name_power

    card, dev, task = card_name_power(), torch.device("cuda"), TASKS[0]
    torch.set_grad_enabled(False)
    for m in (nms_cuda, conv_int8_cuda):
        m.build()
    names = {t: [f"{t}_{i}" for i in range(n)] for t, n in zip(TASKS, NCS)}
    root = tempfile.mkdtemp(prefix="cerberus_eval_graphs_")
    try:
        src = os.path.join(root, task)
        write_val_set(src, VAL_IMAGES, VAL_SIZES, seed=20, n_labels=3, nc=NCS[0])
        data_yaml = os.path.join(root, "data.yaml")
        with open(data_yaml, "w") as f:
            yaml.safe_dump({"task_ids": TASKS, "nc": NCS, "names": [names[t] for t in TASKS],
                            "train": [src, src], "val": [src, src]}, f)
        model = CerberusModel(cfg, TASKS, NCS, device=dev).init(seed=0)
        distinct_heads(model, seed=1)
        calib, _ = create_dataloader(src, imgsz, 8, task="bn", cache_dir=root)
        x = torch.from_numpy(np.stack([calib[i][0] for i in range(8)])).to(dev)
        calibrate_bn(model, x.permute(0, 3, 1, 2).float() / 255.0)
        ckpt = os.path.join(root, "seeded.ckpt.npz")
        save_checkpoint(ckpt, export_jax_params(model), {
            "cfg": cfg, "task_ids": TASKS, "nc": NCS, "names": [names[t] for t in TASKS]},
            half=False)
        del model, x, calib
        sets = {c: repeat_set(os.path.join(root, f"repeat{c}"), src, c)
                for c in (copies, float32_copies, sequence_copies)}

        def loader(c: int):
            return lambda: create_dataloader(sets[c], imgsz, batch, rect=True, pad=0.5,
                                             classnames=names[task], task=f"{task}_repeat{c}",
                                             num_threads=workers)[1]

        bf16 = cli.load_model_for_eval(ckpt, "", dev).to(torch.bfloat16)
        captured_val(bf16, "bf16", task, NCS[0], loader(copies), card)
        forward_sequence(bf16, "bf16", task, loader(sequence_copies)(), card)
        del bf16
        opt = argparse.Namespace(imgsz=imgsz, batch_size=batch, workers=workers, int8="all")
        m8 = cli.load_model_for_eval(ckpt, "", dev)
        fused = fused_conv_weights(m8)
        m8.to(torch.bfloat16)
        cli.quantize_for_eval(m8, parse_data_config(data_yaml, check=True), opt,
                              torch.bfloat16, fused)
        del fused
        captured_val(m8, "int8", task, NCS[0], loader(copies), card)
        forward_sequence(m8, "int8", task, loader(sequence_copies)(), card)
        del m8
        # float32: cuDNN's float32 engines may differ between two runs unless
        # deterministic; fewer copies, as a float32 forward takes ~10x bf16's
        f32 = cli.load_model_for_eval(ckpt, "", dev)
        captured_val(f32, "float32", task, NCS[0], loader(float32_copies), card,
                     deterministic=True, pairs=1)
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
# 4952 test images to fit the script's time limit (48 and 16 until phase 13
# came: 3 steps an epoch are the fewest that leave run B 2 warm-up steps and a
# profiled window of 3 in its last epoch)
TRAIN_CLI_TRAIN, TRAIN_CLI_VAL, TRAIN_CLI_BATCH = 24, 8, 8
PROFILED_STEPS = 3
PAPER_HYP = os.path.join(ROOT, "configs", "hyps", "hyp.cerber-voc_obj365.yaml")


def batch_digest(batch) -> str:
    """A hash of a step's `img` and `bboxes` for one task."""
    import hashlib

    import numpy as np

    h = hashlib.sha1(np.ascontiguousarray(batch["img"]).tobytes())
    h.update(np.ascontiguousarray(batch["bboxes"]).tobytes())
    return h.hexdigest()


def write_train_set(root: str, cfg: str, imgsz: int, dev, n_train: int, n_val: int):
    """The train entry point's cell under root: n_train / n_val seeded
    labelled JPEGs a task at VAL_SIZES (6 / 4 random labels an image), its
    data.yaml, and the seeded cfg (re-drawn box biases, BatchNorm statistics
    from 8 train images) as start.ckpt.npz. Returns (data yaml, weights)."""
    import numpy as np
    import torch
    import yaml

    from cerberusdet_tpu_torch.data.loaders import create_dataloader
    from cerberusdet_tpu_torch.manager.checkpoint import save_checkpoint
    from cerberusdet_tpu_torch.manager.weights import export_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.testing import calibrate_bn, write_val_set

    names = [[f"{t}_{i}" for i in range(n)] for t, n in zip(TASKS, NCS)]
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
    x = torch.from_numpy(np.stack([calib[i][0] for i in range(min(8, len(calib)))])).to(dev)
    calibrate_bn(model, x.permute(0, 3, 1, 2).float() / 255.0)
    weights = os.path.join(root, "start.ckpt.npz")
    save_checkpoint(weights, export_jax_params(model), {
        "cfg": cfg, "task_ids": TASKS, "nc": NCS, "names": names}, half=False)
    return data_yaml, weights


def check_plots(save_dir, drawn, dev, card: str, n_train_batches: int,
                n_val_batches: int) -> None:
    """The plots a train run that saves draws (utils/plots.py, as the JAX
    package's trainer): the first 3 train batches a task, the final val's
    label and prediction mosaics of batches 0-2, and where matplotlib is
    installed the label statistics and each task's confusion matrix (and PR
    curve where the metrics have one). Each decodes. The first train mosaic
    drawn again from the host copy of its batch (drawn["first"]), on the CPU
    and from a copy of the images on `dev`, equals the run's file bit for
    bit. Logs what matplotlib's absence skipped."""
    import importlib.util
    from pathlib import Path

    import cv2
    import numpy as np
    import torch

    from cerberusdet_tpu_torch.utils import plots

    save_dir = Path(save_dir)
    want = [f"train_batch_{t}_{i}.png" for t in TASKS for i in range(min(3, n_train_batches))]
    want += [f"val_batch{i}_{kind}_{t}.jpg" for t in TASKS for i in range(min(3, n_val_batches))
             for kind in ("labels", "pred")]
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    if have_mpl:
        want += ["labels.png"] + [f"{t}_confusion_matrix.png" for t in TASKS]
        want += [f"{t}_PR_curve.png" for t in TASKS if (save_dir / f"{t}_PR_curve.png").exists()]
    sizes = {}
    for name in want:
        im = cv2.imread(str(save_dir / name), cv2.IMREAD_UNCHANGED)
        if im is None or not im.size:
            raise AssertionError(f"plots: {name} is missing or does not decode")
        sizes[name] = im.shape
    task, i, batch = drawn["first"]
    ref = cv2.imread(str(save_dir / f"train_batch_{task}_{i}.png"), cv2.IMREAD_UNCHANGED)
    names = [f"{task}_{c}" for c in range(NCS[TASKS.index(task)])]
    for where in (torch.device("cpu"), dev):
        out = save_dir / f"redrawn_{where.type}.png"
        img = torch.from_numpy(batch["img"]).to(where).permute(0, 3, 1, 2)
        plots.plot_images({**batch, "img": img}, out, names=names)
        if not np.array_equal(cv2.imread(str(out), cv2.IMREAD_UNCHANGED), ref):
            raise AssertionError(f"plots: train_batch_{task}_{i}.png differs from the mosaic "
                                 f"drawn again from its batch's host copy on {where}")
        out.unlink()
    log(f"[plots] run A wrote {len(want)} plots, each decoding ({sizes[want[0]]} the first "
        f"train mosaic), the train mosaics in {drawn['seconds']:.2f} s of the loop; "
        f"train_batch_{task}_{i}.png equals the mosaic drawn again from the host copy of its "
        f"batch on the CPU and from its images on {dev.type}, bit for bit; matplotlib "
        f"{'found' if have_mpl else 'not installed'}, figures skipped: "
        f"{sorted(plots.SKIPPED) or 'none'}  [{card}]")


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
    from cerberusdet_tpu_torch.manager import run_manager
    from cerberusdet_tpu_torch.manager.checkpoint import flatten_tree, load_checkpoint
    from cerberusdet_tpu_torch.manager.weights import export_jax_params
    from cerberusdet_tpu_torch.ops import nms as nms_mod
    from cerberusdet_tpu_torch.ops import nms_cuda, tal_cuda
    from cerberusdet_tpu_torch.train import loss as loss_mod
    from cerberusdet_tpu_torch.train import trainer as trainer_mod
    from cerberusdet_tpu_torch.train.step import MultiTaskTrainer
    from cerberusdet_tpu_torch.utils.profiling import pool_mib

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
        data_yaml, weights = write_train_set(root, cfg, imgsz, dev, n_train, n_val)
        log(f"[train cli] {n_train} train and {n_val} val JPEGs a task at native sizes "
            f"{VAL_SIZES}, 6 / 4 random labels an image; the seeded "
            f"{os.path.basename(cfg)} (BatchNorm statistics from 8 train images) as "
            f"--weights; in {time.perf_counter() - t0:.2f} s")

        # ---- probes around the loop (the path itself is unchanged)
        probe = {"hashes": [], "enter": [], "hash_s": [], "step_s": [], "first": None,
                 "resumed": None, "sync": False, "profile": None}
        real_step = MultiTaskTrainer.step

        def step(self, state, batches, lrs, momentum, freeze_shared=False):
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
            profiled = probe["profile"] is not None and probe.get("prof")
            if probe["sync"] and not profiled:
                sync()
                probe["step_s"].append(time.perf_counter() - t)
            if profiled:  # the loop as it runs: no synchronise until the window's end
                probe["step_s"].append(float("nan"))
                prof, t_enter, steps = probe["prof"]
                steps.append(i)
                if len(steps) == PROFILED_STEPS:
                    sync()
                    wall = time.perf_counter() - t_enter
                    prof.__exit__(None, None, None)
                    busy = sum(e.device_time_total for e in prof.key_averages()) / 1e3
                    probe["prof_result"] = {"steps": (i - PROFILED_STEPS + 1, i),
                                            "busy_ms": busy, "wall_ms": 1e3 * wall}
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

        drawn = {"first": None, "seconds": 0.0}  # the train mosaics of the loop
        real_plot = trainer_mod.TrainLoop._plot_batch

        def plot_batch(self, task, i, b):
            if drawn["first"] is None:  # the host copy of the first plotted batch
                drawn["first"] = (task, i, {k: torch.as_tensor(b[k]).cpu().numpy().copy()
                                            for k in ("img", "bboxes", "cls", "mask")})
            t = time.perf_counter()
            real_plot(self, task, i, b)
            drawn["seconds"] += time.perf_counter() - t

        patch(trainer_mod.TrainLoop, "_plot_batch", plot_batch)

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
            pools = {"step": pool_mib(loop.trainer.pool)} if on_card else {}
            log(f"[train cli] run {label}: {len(probe['hashes'])} steps, {len(vals)} task vals "
                f"over {val_batches} batches ({loss_batches} with losses); launches {counts}, "
                f"expected {expect}; main's wall {wall:.2f} s; peak memory {peak:.2f} GiB; "
                f"{len(loop.trainer.programs)} captured steps; graph pools (MiB) {pools}  "
                f"[{card}]")
            if counts != expect:
                raise AssertionError(f"run {label}: kernel launches {counts} != {expect}")
            return loop, {"hashes": list(probe["hashes"]), "wall": wall, "counts": counts,
                          "vals": list(vals), "timed": {k: list(v) for k, v in timed.items()},
                          "enter": list(probe["enter"]), "hash_s": list(probe["hash_s"]),
                          "step_s": list(probe["step_s"]), "peak": peak,
                          "timings": list(loop.timings)}

        # ---- run A: 2 epochs, the native decoder built by the run's first decode
        decoder = native.default_decoder()
        for so in native.BUILD_DIR.glob("libcerberus_io_*.so"):
            so.unlink()
        if decoder.name:
            raise AssertionError("the native decoder was resolved before the train phase")
        loop_a, a = run("A", fresh + ["--epochs", "2", "--name", "A"])
        if probe["first"] is not True or not cli_check:
            raise AssertionError("run A did not run its first-step or final-val comparison")
        nb_a = len(a["hashes"]) // 2
        warm_a = [i for i in range(1, len(a["timings"])) if i % nb_a >= 2]
        enqueue_ms = 1e3 * float(np.median([a["timings"][i]["step_s"] for i in warm_a]))
        iter_a_ms = 1e3 * float(np.median([a["enter"][i] - a["enter"][i - 1] for i in warm_a]))
        log(f"[train cli] run A (steps not synchronised): the step call's host time median "
            f"{enqueue_ms:.2f} ms (the copies into the static buffers wait for the replay "
            f"before, while the host is ahead); a loop iteration (step start to step start, "
            f"the probe's hashing overlapping the replay) median {iter_a_ms:.2f} ms (2 warm-up "
            f"steps an epoch left out)  [{card}]")
        log(f"[train cli] JPEG decode by {decoder.name!r} (what run A's first decode built: "
            f"{sorted(p.name for p in native.BUILD_DIR.glob('libcerberus_io_*.so'))})  [{card}]")
        last = loop_a.manager.wdir / "last.ckpt.npz"
        check_plots(loop_a.manager.save_dir, drawn, dev, card, n_train_batches=nb_a,
                    n_val_batches=-(-n_val // batch))

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
        step_ms = 1e3 * float(np.nanmedian([b["step_s"][i] for i in warm]))
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
        log(f"[train cli] run B, device busy over steps {pr['steps']}, the loop not "
            f"synchronised (the profiler's kernel time): {pr['busy_ms']:.2f} ms in "
            f"{pr['wall_ms']:.2f} ms of the loop ({100 * pr['busy_ms'] / pr['wall_ms']:.1f}%), "
            f"{pr['wall_ms'] / PROFILED_STEPS:.2f} ms a loop iteration  [{card}]")
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
            "quant_s8": conv_int8_cuda.quant_s8,
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
        # a run: WARMUP_STEPS + iters eager steps, then as many captured (the
        # capture's eager run, a replay, iters timed replays)
        steps = 2 * (bench_train_step.WARMUP_STEPS + iters) * bench_train_step.TURNS.count(
            "pallas")
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


def train_step(card: str, dev, tal_err, cfg: str = FLAGSHIP, imgsz: int = 640,
               batch: int = TRAIN_BATCH, n_labels: int = TRAIN_LABELS):
    """The train step at full width (phase 4): MultiTaskTrainer.raw_step
    (eager) and .step (one captured CUDA graph per key, replayed) on seeded
    batches, with their gates: finite losses; every TAL kernel once per
    task and step (a replay launches each once per task); one capture per
    key over three keys; 6 replays bit for bit with 6 raw_steps from one
    snapshot under deterministic algorithms; a replaced momentum buffer
    raises; the plain assigner under its own key launches no TAL kernel and
    gives the same losses (rtol 1e-5). The TAL kernels against their plain
    versions on the flagship's predictions, updating `tal_err`, and timed
    alone. Returns the kernels-line entries of the TAL kernels."""
    import numpy as np
    import torch

    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.ops import tal_cuda
    from cerberusdet_tpu_torch.testing import train_batches
    from cerberusdet_tpu_torch.train.loss import DetectionLoss
    from cerberusdet_tpu_torch.train.schedules import warmup_lrs
    from cerberusdet_tpu_torch.train.step import (
        MultiTaskTrainer,
        init_train_state,
        state_tensors,
    )
    from cerberusdet_tpu_torch.utils.profiling import pool_mib

    entries = []
    t0 = time.perf_counter()
    model = CerberusModel(cfg, TASKS, NCS, device=dev).init(seed=0)
    losses = {t: DetectionLoss(nc=nc, strides=model.strides) for t, nc in zip(TASKS, NCS)}
    trainer = MultiTaskTrainer(model, losses, compute_dtype=torch.bfloat16, device=dev)
    state = init_train_state(model)
    batches = {t: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for t, b in train_batches(TASKS, NCS, batch, imgsz, n_labels, TRAIN_REAL,
                                         seed=0).items()}
    log(f"[train] {os.path.basename(cfg)}, bf16 compute, per-task batch {batch}, "
        f"{n_labels} gt rows ({TRAIN_REAL} real), set up in "
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

    tal_kernels = {"tal_select": tal_cuda.select_kernel, "tal_assign": tal_cuda.assign_kernel,
                   "tal_norm": tal_cuda.norm_kernel}

    def tal_counts():
        return {k: f.launches for k, f in tal_kernels.items()}

    def sched(i):  # warmup lrs and momentum: new values at every step
        return warmup_lrs(i, 100, 0.0, 0.01, 1.0)

    run = {"ni": 0, "tal": 0, "items": []}

    def stepped(fn, bt=None, freeze=False, **kw):
        """One step by fn (trainer.step or raw_step) with the next schedule
        values, synchronised: its host seconds. Holds its losses finite and
        counts the TAL launches it should make."""
        bt = batches if bt is None else bt
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, items = fn(state, bt, *sched(run["ni"]), freeze_shared=freeze, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        vals = {k: [float(v) for v in it] for k, it in items.items()}
        if not all(np.isfinite(v) for it in vals.values() for v in it):
            raise AssertionError(f"non-finite losses at step {run['ni']}: {vals}")
        run["items"].append(vals)
        run["ni"] += 1
        run["tal"] += sum(losses[t].use_kernel for t in bt)
        return dt

    def profiled(fn, n=3):
        """(the profiler's device ms, host ms) a step over n synchronised steps."""
        from torch.profiler import ProfilerActivity, profile

        # (the CPU's activity only where the phase is rehearsed without a card)
        with profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                                 else ProfilerActivity.CPU]) as prof:
            host = sum(stepped(fn) for _ in range(n))
        return (sum(e.device_time_total for e in prof.key_averages()) / 1e3 / n,
                1e3 * host / n)

    for f in tal_kernels.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 2**30  # before the first step, earlier phases' too
    # eager: raw_step, each stage marked on the timed steps
    eager_s = []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        timed = i >= WARMUP_STEPS
        if timed:
            mark("start")
        dt = stepped(trainer.raw_step, mark=mark if timed else None)
        if timed:
            eager_s.append(dt)
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    eager_busy = profiled(trainer.raw_step)
    # captured: the key's first call runs the step eagerly and captures it
    torch.cuda.reset_peak_memory_stats()
    capture_s = stepped(trainer.step)
    replay_s = [stepped(trainer.step) for _ in range(WARMUP_STEPS + TIMED_STEPS)][WARMUP_STEPS:]
    captured_peak = torch.cuda.max_memory_allocated() / 2**30
    replay_busy = profiled(trainer.step)
    prog = trainer.programs[trainer.step_key(batches)]
    step_pool = pool_mib(trainer.pool)
    check_s = []  # the host's address check before a replay: the state walked, compared
    for _ in range(5):
        t = time.perf_counter()
        prog.check(state_tensors(state))
        check_s.append(time.perf_counter() - t)
    if len(trainer.programs) != 1 or prog.replays != WARMUP_STEPS + TIMED_STEPS + 3 \
            or prog.launches != [len(TASKS)] * 3:
        raise AssertionError(f"the train step: {len(trainer.programs)} captures, "
                             f"{prog.replays} replays, {prog.launches} TAL launches a replay")
    # one capture per key, each key used twice: {a, b}, {a} alone, {a, b} frozen
    a_only = {TASKS[0]: batches[TASKS[0]]}
    for bt, freeze in ((batches, False), (a_only, False), (batches, True)):
        for _ in range(2):
            stepped(trainer.step, bt, freeze)
    keys = {trainer.step_key(batches), trainer.step_key(a_only),
            trainer.step_key(batches, True)}
    if set(trainer.programs) != keys or any(p.replays < 1 for p in trainer.programs.values()):
        raise AssertionError(f"{len(trainer.programs)} captured steps for {len(keys)} keys, "
                             f"replays {[p.replays for p in trainer.programs.values()]}")
    tal_launches = tal_counts()
    n_steps = run["ni"]
    log(f"[train] {n_steps} steps ({WARMUP_STEPS + TIMED_STEPS + 3} eager, then captured: "
        f"3 keys, {sum(p.replays for p in trainer.programs.values())} replays), TAL kernel "
        f"launches {tal_launches} (expected {run['tal']} each: tasks x steps; a replay "
        f"launches {prog.launches}); one capture per key: {{{TASKS[0]}, {TASKS[1]}}}, "
        f"{{{TASKS[0]}}} alone and {{{TASKS[0]}, {TASKS[1]}}} with freeze_shared, each used "
        f"twice")
    if any(v != run["tal"] for v in tal_launches.values()):
        raise AssertionError("the train path did not launch every TAL kernel once per task "
                             "and step")
    items_log = run["items"]
    log(f"[train] losses (box, cls, dfl, total) first step {items_log[0]}, last step "
        f"{items_log[-1]}")
    stage = {"forward_loss": 0.0, "backward": 0.0, "update": 0.0}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        if name in stage:
            stage[name] += a.elapsed_time(b) / TIMED_STEPS
    step_ms = 1e3 * float(np.median(eager_s))
    replay_ms = 1e3 * float(np.median(replay_s))
    log(f"[train] step eager (raw_step) {step_ms:.2f} ms, captured (a replay) {replay_ms:.2f} "
        f"ms: {step_ms / replay_ms:.3f}x (host clock ending in a synchronise, median of "
        f"{TIMED_STEPS} each), {2 * batch / step_ms * 1e3:.1f} / "
        f"{2 * batch / replay_ms * 1e3:.1f} img/s; the key's first call (eager step + "
        f"capture) {capture_s:.2f} s; device busy eager {eager_busy[0]:.2f} ms of "
        f"{eager_busy[1]:.2f} ms ({100 * eager_busy[0] / eager_busy[1]:.1f}%), replayed "
        f"{replay_busy[0]:.2f} ms of {replay_busy[1]:.2f} ms "
        f"({100 * replay_busy[0] / replay_busy[1]:.1f}%) (the profiler's device time over "
        f"3 synchronised steps); peak memory eager {eager_peak:.2f} GiB, captured "
        f"{captured_peak:.2f} GiB ({held_gb:.2f} GiB allocated before the first step), the "
        f"step's graph pool {step_pool:.0f} MiB; the address check before a replay "
        f"{1e3 * float(np.median(check_s)):.2f} ms of host time ({len(state_tensors(state))} "
        f"tensors)  [{card}]")

    # 6 replays against 6 raw_steps from one snapshot, with lrs and momentum
    # changing every step, under deterministic algorithms: bit for bit
    base = run["ni"]
    torch.backends.cudnn.deterministic = True
    with warnings.catch_warnings(record=True) as nondet:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det = MultiTaskTrainer(model, losses, compute_dtype=torch.bfloat16, device=dev)
            det.step(state, batches, *sched(base))  # the capture
            snap = snapshot(state)
            forms = {}
            for label, fn in (("replayed", det.step), ("eager", det.raw_step)):
                restore(state, snap)
                got = []
                for i in range(6):
                    _, items = fn(state, batches, *sched(base + 1 + i))
                    got.append({t: [v.clone() for v in it] for t, it in items.items()})
                torch.cuda.synchronize()
                forms[label] = (got, [(n, t.clone()) for n, t in state_tensors(state)])
            prog_det = next(iter(det.programs.values()))
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
    worst, n_tensors = 0.0, 0
    for a, b in zip(forms["replayed"][0], forms["eager"][0]):
        for t in TASKS:
            for x, y in zip(a[t], b[t]):
                worst = max(worst, float((x.double() - y.double()).abs()))
    unequal = []
    for (name, x), (_, y) in zip(*(forms[k][1] for k in ("replayed", "eager"))):
        n_tensors += 1
        if not torch.equal(x, y):
            unequal.append((name, float((x.double() - y.double()).abs().max())))
    nondet_ops = sorted({str(w.message).split(" does not have")[0][:80] for w in nondet
                         if "deterministic" in str(w.message)})
    if worst or unequal or len(det.programs) != 1 or prog_det.replays != 6:
        raise AssertionError(f"6 replays differ from 6 raw_steps from the same snapshot: "
                             f"losses by {worst}, {len(unequal)} of {n_tensors} state tensors "
                             f"(e.g. {unequal[:3]}); ops without a deterministic form: "
                             f"{nondet_ops}")
    log(f"[train] 6 replays == 6 raw_steps from one snapshot, lrs and momentum changing every "
        f"step, under cudnn.deterministic and use_deterministic_algorithms: losses and all "
        f"{n_tensors} parameters, BN buffers, momentum buffers and EMA tensors bit for bit "
        f"(ops that warned of no deterministic form: {nondet_ops or 'none'})")

    # a replaced momentum buffer (what the old restore's deep copy did) raises
    name = next(iter(state.opt_state.momentum_buf))
    kept = state.opt_state.momentum_buf[name]
    state.opt_state.momentum_buf[name] = kept.clone()
    before = (tal_counts(), state.n_updates, state.opt_state.step)
    try:
        det.step(state, batches, *sched(base))
    except RuntimeError as e:
        if name not in str(e):
            raise
        log(f"[train] a replaced momentum buffer makes the replay raise: {e}")
    else:
        raise AssertionError("a step over a replaced momentum buffer did not raise")
    finally:
        state.opt_state.momentum_buf[name] = kept
    if (tal_counts(), state.n_updates, state.opt_state.step) != before:
        raise AssertionError("the refused step launched kernels or advanced the state")
    del det, prog_det, forms, snap
    torch.cuda.empty_cache()

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
    log(f"[train stages] per eager step: forwards + loss {stage['forward_loss']:.2f} ms (of "
        f"which the assigner {len(TASKS) * assign_ms:.3f} ms: {len(TASKS)} x {assign_ms:.4f} "
        f"ms, kernels and their glue), backward {stage['backward']:.2f} ms, clip + optimizer + "
        f"EMA {stage['update']:.2f} ms; the plain assigner would take {plain_assign_ms:.3f} "
        f"ms a task  [{card}]")

    # one step from the same state with the plain assigner: a key of its own,
    # no TAL launch, the same losses
    snap = snapshot(state)
    _, items_k = trainer.step(state, batches, *sched(base))
    items_k = {t: [float(v) for v in it] for t, it in items_k.items()}
    keys = set(trainer.programs)
    for loss in losses.values():
        loss.use_kernel = False
    try:
        before = tal_counts()
        items_p = []
        for _ in range(2):  # the plain key's capture (an eager step), then a replay
            restore(state, snap)
            _, it = trainer.step(state, batches, *sched(base))
            items_p.append({t: [float(v) for v in x] for t, x in it.items()})
        plain_launches = {k: v - before[k] for k, v in tal_counts().items()}
    finally:
        for loss in losses.values():
            loss.use_kernel = True
    new_keys = set(trainer.programs) - keys
    if len(new_keys) != 1 or trainer.programs[new_keys.pop()].replays != 1 \
            or any(plain_launches.values()):
        raise AssertionError(f"the plain-assigner step: {len(set(trainer.programs) - keys)} "
                             f"new keys, TAL launches {plain_launches}")
    worst = 0.0
    for it_p in items_p:
        for t in TASKS:
            for a, b in zip(items_k[t], it_p[t]):
                rel = abs(a - b) / max(abs(b), 1e-30)
                worst = max(worst, rel)
                if rel > 1e-5:
                    raise AssertionError(f"{t}: kernel-assigner loss {a} vs plain {b}")
    log(f"[train] one step with the plain assigner from the same state, captured under a key "
        f"of its own and replayed once: no TAL launch, losses within rtol {worst:.3g} of the "
        f"kernels' (limit 1e-5)")
    for name, f in tal_kernels.items():  # the comparison and timing launches do not count
        f.launches = tal_launches[name]
    tal_work_flag = tal_work(flag_inp, flag_pos, NCS[0])
    del state, trainer, model, batches, snap, planes, prog
    torch.cuda.empty_cache()

    for name in ("tal_select", "tal_assign", "tal_norm"):
        ops, nbytes = tal_work_flag[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        entries.append({
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
    return entries


# the data phase: bench_train_e2e's set cut to 32 seeded noise JPEGs of 640 px
# a task (128 until phase 13 came: the script's time limit; 4 steps an epoch
# still hold the profiled window of 3 after a warm-up step) and batch (8 a
# task), bench_loader's run (64 images, batch 32; 256 before)
DATA_IMAGES, DATA_BATCH, LOADER_IMAGES, LOADER_BATCH = 32, 8, 64, 32
DEFAULT_HYP = os.path.join(ROOT, "configs", "hyps", "hyp.cerber-default.yaml")
AUG_MAX_DIFF, AUG_MAX_SHARE = 2, 0.01  # tests/test_torch_device_augment.py's bound


def aug_diff(a, b, what: str):
    """(max |diff|, share of values that differ) of two uint8 image batches;
    raises past the bound of the CPU tests."""
    d = (a.cpu().int() - b.cpu().int()).abs()
    worst, share = int(d.max()), float((d > 0).float().mean())
    if worst > AUG_MAX_DIFF or share >= AUG_MAX_SHARE:
        raise AssertionError(f"{what}: max|diff| {worst}, {100 * share:.4f}% of values differ "
                             f"(bound {AUG_MAX_DIFF} on < {100 * AUG_MAX_SHARE}%)")
    return worst, share


def label_digest(batch) -> str:
    """A hash of one task's padded label arrays."""
    import hashlib

    import numpy as np

    h = hashlib.sha1()
    for k in ("cls", "prob", "bboxes", "mask"):
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def data_path(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640,
              n_images: int = DATA_IMAGES, batch: int = DATA_BATCH,
              loader_images: int = LOADER_IMAGES, loader_batch: int = LOADER_BATCH,
              procs=(4, 8)):
    """The training data path's routes at full width (phase 10): the packed
    disk cache, the worker-process pool and the augmentation on the card,
    over bench_train_e2e's seeded set. Gates: every warp route (matmul for
    the default hyps, affine3 for the paper's, gather at perspective 0.0005)
    and pixel-op variant on the card equals the CPU's on the same collated
    plans within the CPU tests' bound; integer-translation warps equal the
    host cv2 items bit for bit; resident equals shipped bit for bit; the
    pool's batches equal the threads' (sha1); bench_train_e2e's device runs
    feed the step the host runs' labels (sha1 a task and step) and launch
    each TAL kernel once per task and step. Measures one augmentation batch
    per route, bench_loader's img/s on threads, processes and the card, and
    bench_train_e2e's img/s, the host's wait a step and the loop's busy
    share, host and device, for both hyps. Returns the kernels-line entries
    of this path."""
    from pathlib import Path

    import numpy as np
    import torch
    import yaml

    from cerberusdet_tpu_torch.data import device_augment as da
    from cerberusdet_tpu_torch.data.augment import PixelAugment
    from cerberusdet_tpu_torch.data.dataset import DetectionDataset
    from cerberusdet_tpu_torch.data.loaders import DataLoader, create_dataloader
    from cerberusdet_tpu_torch.ops import tal_cuda
    from cerberusdet_tpu_torch.tools import bench_loader, bench_train_e2e
    from cerberusdet_tpu_torch.train import loss as loss_mod
    from cerberusdet_tpu_torch.train.step import MultiTaskTrainer

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def host_ms(fn, iters: int = 5) -> float:
        """Median host-clock ms of fn() ending in a synchronise."""
        fn()
        sync()
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t)
        return 1e3 * float(np.median(times))

    hyps = {}
    for name, path in (("default", DEFAULT_HYP), ("paper", PAPER_HYP)):
        with open(path) as f:
            hyps[name] = yaml.safe_load(f)
    route_hyps = {"matmul": hyps["default"], "affine3": hyps["paper"],
                  "gather": dict(hyps["default"], perspective=0.0005)}
    # no scale, translation, rotation or shear: every warp an integer translation
    int_hyp = dict(hyps["default"], translate=0.0, scale=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                   fliplr=0.0)
    kern = {"tal_select": tal_cuda.select_kernel, "tal_assign": tal_cuda.assign_kernel,
            "tal_norm": tal_cuda.norm_kernel}
    saved_counts = {k: f.launches for k, f in kern.items()}
    patches = []

    def patch(obj, name, new):
        patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    root = tempfile.mkdtemp(prefix="cerberus_data_")
    try:
        t0 = time.perf_counter()
        for t in ("t1", "t2"):
            bench_loader.make_dataset(Path(root) / t, n_images, imgsz)
        img_dir = os.path.join(root, "t1", "images", "train")
        packs = os.path.join(root, "packs")
        os.makedirs(packs)
        first = DetectionDataset(img_dir, imgsz=imgsz, augment=True, hyp=hyps["default"],
                                 cache_images="disk", cache_dir=packs, task="t1")
        log(f"[data] bench_train_e2e's set: {n_images} seeded noise JPEGs of {imgsz} px a task "
            f"(2 tasks), the packed cache of one task {first._pack[0].nbytes / 1e6:.1f} MB "
            f"({first._pack[0].shape}); in {time.perf_counter() - t0:.2f} s")

        def dataset(hyp, pixel=(0.1, 0.1, 0.01)):
            ds = DetectionDataset(img_dir, imgsz=imgsz, augment=True, hyp=hyp,
                                  cache_images="disk", cache_dir=packs, task="t1")
            ds._pixel_aug = PixelAugment(*pixel)
            return ds

        pack = torch.from_numpy(np.array(first._pack[0])).to(dev)

        # ---- each warp route on one batch: card == CPU, resident == shipped
        route_ms = {}
        for route, hyp in route_hyps.items():
            ds = dataset(hyp)
            loader = DataLoader(ds, batch, device_augment=True, device=dev)
            if loader.warp_route != route:
                raise AssertionError(f"the loader routes the {route} hyp to {loader.warp_route}")
            kw = {"matmul": dict(axis_aligned=True), "gather": {},
                  "affine3": dict(shear_pad=loader._affine_pad)}[route]
            loader.close()
            plans = [da.plan_sample(ds, i) for i in range(batch)]
            collate_ms = host_ms(lambda: da.collate_device(ds, plans, 60))
            shipped = da.collate_device(ds, plans, 60)
            indexed = da.collate_device(ds, plans, 60, as_indices=True)
            n_slots = shipped["tiles"].shape[1]
            aug_cpu = {k: torch.from_numpy(v) for k, v in shipped["aug"].items()}
            aug = {k: v.to(dev) for k, v in aug_cpu.items()}
            tiles_cpu = torch.from_numpy(shipped["tiles"])
            tiles = tiles_cpu.to(dev)
            tidx = torch.from_numpy(indexed["tile_idx"]).to(dev)
            fn_s = da.make_augment_fn(imgsz, n_slots, **kw)
            fn_r = da.make_augment_fn(imgsz, n_slots, resident=True, **kw)
            out_s, out_r = fn_s(tiles, aug), fn_r(pack, tidx, aug)
            if not torch.equal(out_s, out_r):
                raise AssertionError(f"{route}: the resident form differs from the shipped form")
            t = time.perf_counter()
            cpu = fn_s(tiles_cpu, aug_cpu)
            cpu_s = time.perf_counter() - t
            worst, share = aug_diff(out_s, cpu, f"{route}: card vs CPU")
            res_ms = cuda_ms(lambda: fn_r(pack, tidx, aug), iters=5)
            ship_ms = cuda_ms(lambda: fn_s(tiles, aug), iters=5)
            copy_ms = host_ms(lambda: tiles_cpu.to(dev))
            route_ms[route] = (res_ms, ship_ms, copy_ms)
            log(f"[data] {route} route (K {kw.get('shear_pad', 0)}), batch {batch} x {n_slots} "
                f"slots: card == CPU within max|diff| {worst} on {100 * share:.4f}% of values "
                f"(bound {AUG_MAX_DIFF} on < {100 * AUG_MAX_SHARE}%), resident == shipped bit for "
                f"bit; device ms a batch resident {res_ms:.3f}, shipped {ship_ms:.3f} (CUDA "
                f"events, mean of 5), + the shipped tiles' copy from pageable host memory "
                f"({shipped['tiles'].nbytes / 1e6:.1f} MB) {copy_ms:.3f} ms and their collate "
                f"{collate_ms:.3f} ms (host clock, median of 5); the same batch on the host's "
                f"CPU {cpu_s:.2f} s  [{card}]")
            del tiles, out_s, out_r, cpu

        # the one-sample blur and median variants, on the default hyp's first sample
        ds = dataset(hyps["default"])
        one = da.collate_device(ds, [da.plan_sample(ds, 0)], 60)
        aug_cpu = {k: torch.from_numpy(v) for k, v in one["aug"].items()}
        aug = {k: v.to(dev) for k, v in aug_cpu.items()}
        tiles_cpu = torch.from_numpy(one["tiles"])
        tiles = tiles_cpu.to(dev)
        variants = []
        for ops in ((3, 0), (7, 0), (0, 3), (0, 7), (5, 5)):
            fn = da.make_augment_fn(imgsz, tiles.shape[1], axis_aligned=True, pixel_ops=ops)
            worst, share = aug_diff(fn(tiles, aug), fn(tiles_cpu, aug_cpu), f"pixel_ops {ops}")
            variants.append(f"{ops} {cuda_ms(lambda: fn(tiles, aug), iters=3):.3f} ms "
                            f"(max|diff| {worst})")
        log(f"[data] one-sample (blur_k, median_k) variants, matmul route, card vs CPU within "
            f"the bound: {', '.join(variants)}  [{card}]")

        # integer translations: the host cv2 items, bit for bit, on every route
        ds = dataset(int_hyp, pixel=(0.0, 0.0, 0.0))
        plans = [da.plan_sample(ds, i) for i in range(batch)]
        shipped = da.collate_device(ds, plans, 60)
        aug = {k: torch.from_numpy(v).to(dev) for k, v in shipped["aug"].items()}
        tiles = torch.from_numpy(shipped["tiles"]).to(dev)
        host = torch.from_numpy(np.stack([ds[i][0] for i in range(batch)]))
        for route, kw in (("gather", {}), ("matmul", dict(axis_aligned=True)),
                          ("affine3", dict(shear_pad=6))):
            got = da.make_augment_fn(imgsz, tiles.shape[1], **kw)(tiles, aug)
            if not torch.equal(got.cpu(), host):
                raise AssertionError(f"{route}: an integer-translation warp differs from the "
                                     f"host cv2 items")
        log(f"[data] integer-translation hyp (no scale, translate, rotation or shear): gather, "
            f"matmul and affine3 on the card == the host cv2 items, bit for bit, {batch} images")
        del pack, tiles

        # ---- the pool's batches == the threads' (decoding, the paper's hyps)
        kw = dict(imgsz=imgsz, batch_size=batch, hyp=hyps["paper"], augment=True, task="t1",
                  cache_dir=packs, seed=0)
        _, pooled = create_dataloader(img_dir, num_workers=procs[0], **kw)
        _, threaded = create_dataloader(img_dir, **kw)
        n_cmp = min(4, len(threaded))
        try:
            for i, (a, b) in enumerate(zip(pooled, threaded)):
                if i == n_cmp:
                    break
                if batch_digest(a) != batch_digest(b) or label_digest(a) != label_digest(b):
                    raise AssertionError(f"batch {i}: the pool's batch differs from the threads'")
        finally:
            pooled.close()
        log(f"[data] {procs[0]} worker processes (spawned) == 8 decode threads on {n_cmp} "
            f"batches of {batch} (sha1 of img and labels), the paper's hyps, JPEG decode")

        # ---- bench_loader: threads against processes, and the card
        rates = {}
        for label, kw in [("8 threads", dict(threads=8)), ("4 threads", dict(threads=4))] + [
                (f"{p} processes", dict(threads=8, num_workers=p)) for p in procs] + [
                ("device-augment, 8 threads", dict(threads=8, augment_device=True,
                                                   device=str(dev)))]:
            t = time.perf_counter()
            rates[label] = bench_loader.run(imgsz, loader_images, augment=True,
                                            batch=loader_batch, **kw)
            log(f"[data] bench_loader {label}: {rates[label]:.1f} img/s ({loader_images} images "
                f"of {imgsz} px, batch {loader_batch}, bench_loader's hyp; the run "
                f"{time.perf_counter() - t:.1f} s)  [{card}]")

        # ---- bench_train_e2e, host and device, both hyps
        probe = {"labels": [], "enter": [], "profile": None, "prof": None, "result": None,
                 "capture": False}
        real_step = MultiTaskTrainer.step

        def step(self, state, batches, lrs, momentum, freeze_shared=False):
            i = len(probe["enter"])
            probe["enter"].append(time.perf_counter())
            probe["labels"].append({t: label_digest(b) for t, b in batches.items()})
            if probe["profile"] == i:
                from torch.profiler import ProfilerActivity, profile

                sync()
                prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                           else ProfilerActivity.CPU])
                prof.__enter__()
                probe["prof"] = (prof, time.perf_counter(), i)
            out = real_step(self, state, batches, lrs, momentum, freeze_shared)
            if probe["prof"] is not None and i == probe["prof"][2] + PROFILED_STEPS - 1:
                sync()
                prof, t_enter, _ = probe["prof"]
                wall = time.perf_counter() - t_enter
                prof.__exit__(None, None, None)
                busy = sum(e.device_time_total for e in prof.key_averages()) / 1e3
                probe["result"] = (busy, 1e3 * wall)
                probe["prof"] = None
            return out

        patch(MultiTaskTrainer, "step", step)
        captured = {}
        real_assign = loss_mod.task_aligned_assign

        def assign(*a, **kw):
            if probe["capture"] and "tal" not in captured:  # a device-augmented batch's
                captured["tal"] = ([v.detach().clone() for v in a[:6]], kw["num_classes"])
            return real_assign(*a, **kw)

        patch(loss_mod, "task_aligned_assign", assign)
        e2e, labels_by_run, launches = {}, {}, {}
        for hyp_name, hyp_path in (("default", DEFAULT_HYP), ("paper", PAPER_HYP)):
            args = bench_train_e2e.parse_opt(["--cfg", cfg, "--hyp", hyp_path, "--imgsz",
                                              str(imgsz), "--batch", str(batch), "--n",
                                              str(n_images), "--device", str(dev)])
            for device_aug in (False, True):
                mode = "device" if device_aug else "host"
                for f in kern.values():
                    f.launches = 0
                probe.update(labels=[], enter=[], profile=None, result=None, capture=device_aug)
                t = time.perf_counter()
                out, loop = bench_train_e2e.run_mode(device_aug, args, Path(root))
                counts = {k: f.launches for k, f in kern.items()}
                nb = loop.nb
                if len(probe["labels"]) != 2 * nb:
                    raise AssertionError(f"{hyp_name} {mode}: {len(probe['labels'])} steps in 2 "
                                         f"epochs of {nb}")
                tasks_stepped = sum(len(x) for x in probe["labels"])
                if device_aug:
                    launches[hyp_name] = counts
                    if on_card and counts != {k: tasks_stepped for k in kern}:
                        raise AssertionError(f"{hyp_name} device: TAL launches {counts}, "
                                             f"expected {tasks_stepped} each")
                    routes = {t: ld.warp_route for t, ld in loop.train_loaders.items()}
                    resident = {t: ld._resident for t, ld in loop.train_loaders.items()}
                labels_by_run[(hyp_name, mode)] = list(probe["labels"])
                waits = [1e3 * x["data_s"] for x in loop.timings[nb:]]
                # the profiler over 3 steps of a third epoch, after 2 warm-up steps
                probe["profile"] = 2 * nb + min(2, max(0, nb - PROFILED_STEPS))
                loop.train_epoch(2)
                busy, wall = probe["result"] if probe["result"] else (float("nan"),) * 2
                e2e[(hyp_name, mode)] = out
                log(f"[data] bench_train_e2e {hyp_name} hyp, {mode}: {out['imgs_per_sec']} img/s "
                    f"({out['imgs']} images in {out['sec_per_epoch']} s, the timed epoch); the "
                    f"host in the loaders a step (TrainLoop's data_s"
                    + ("; with the augmentation's enqueue, whose copies from pageable memory "
                       "wait for the card's queue" if device_aug else "")
                    + f") median {np.median(waits):.2f} ms, max {max(waits):.2f} ms; the loop busy {busy:.2f} of {wall:.2f} ms over "
                    f"{PROFILED_STEPS} steps ({100 * busy / wall:.1f}%, profiler, not "
                    f"synchronised)"
                    + (f"; warp routes {routes}, resident packs {resident}; TAL launches "
                       f"{counts} for {tasks_stepped} task steps" if device_aug else "")
                    + f"; the run {time.perf_counter() - t:.1f} s  [{card}]")
                for ld in loop.train_loaders.values():
                    ld.close()
                del loop
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
            host_l, dev_l = labels_by_run[(hyp_name, "host")], labels_by_run[(hyp_name, "device")]
            if host_l != dev_l:
                bad = sum(a != b for a, b in zip(host_l, dev_l))
                raise AssertionError(f"{hyp_name}: {bad} of {len(host_l)} device-augmented steps "
                                     f"got other labels than the host loader's")
            log(f"[data] {hyp_name} hyp: the device-augmented steps got the disk-cached host "
                f"loader's labels, {len(host_l)} steps x 2 tasks (sha1 of cls, prob, bboxes, "
                f"mask)")
        log(f"[data] e2e img/s host / device: default "
            f"{e2e[('default', 'host')]['imgs_per_sec']} / "
            f"{e2e[('default', 'device')]['imgs_per_sec']}, paper "
            f"{e2e[('paper', 'host')]['imgs_per_sec']} / {e2e[('paper', 'device')]['imgs_per_sec']}"
            f"; one augmentation batch (ms, resident / shipped + copy) "
            + ", ".join(f"{r} {a:.3f} / {b:.3f} + {c:.3f}" for r, (a, b, c) in route_ms.items())
            + f"; bench_loader img/s {', '.join(f'{k} {v:.1f}' for k, v in rates.items())}  "
            f"[{card}]")
        args, nc = captured["tal"]
        total = {k: sum(c[k] for c in launches.values()) for k in kern}
        return tal_entries(args, nc, total, "data phase: device-augmented batches", card,
                           {k: {"launches_by_hyp": {h: c[k] for h, c in launches.items()}}
                            for k in TAL_KERNELS})
    finally:
        for obj, name, orig in reversed(patches):
            setattr(obj, name, orig)
        for k, f in kern.items():
            f.launches = saved_counts[k]
        shutil.rmtree(root, ignore_errors=True)


# ---- phase 11: int8 carried between the blocks

# the int8 routes conv_s8 does not take, on the card against the CPU:
# (what, Ci, Co, k, stride, groups, B, H, W)
SUMS_CASES = [
    ("GhostConv's 5x5 depthwise half, 160 channels at 80x80", 160, 160, 5, 1, 160, 8, 80, 80),
    ("DWConv c2 = 2 c1, 3x3 s2, 320 -> 640 at 40x40", 320, 640, 3, 2, 320, 8, 40, 40),
    ("a grouped bottleneck conv, groups 4, 3x3, 256 at 20x20", 256, 256, 3, 1, 4, 8, 20, 20),
    ("a 5x5 conv, groups 1, 64 -> 32 at 15x20", 64, 32, 5, 1, 1, 2, 15, 20),
    ("a 5x5 conv, groups 1, 256 -> 256 at 40x40", 256, 256, 5, 1, 1, 2, 40, 40),
]
# the int8 max pools: (shape, k); the flagship's SPPF input at batch 8 first
POOL_CASES = [((8, 320, 20, 20), 5), ((2, 64, 2, 2), 13), ((1, 3, 15, 20), 9),
              ((4, 160, 40, 40), 9)]
# device-time categories of a forward, by kernel-name fragment (the first match wins)
FORWARD_KERNELS = (("conv_s8", ("conv_s8_kernel",)), ("quant_pack_s8", ("quant_pack",)),
                   ("quant_s8", ("quant_nchw_kernel",)),
                   ("concat", ("CatArrayBatchedCopy",)), ("max pool", ("max_pool",)),
                   ("cuDNN / cuBLAS conv", ("fprop", "implicit_gemm", "convolve", "conv2d",
                                            "nvjet")))


def forward_breakdown(prof, n: int):
    """{category: (ms, launches)} a forward, from the CUDA profiler's key
    averages over n forwards; the rest under "other"."""
    out = {name: [0.0, 0] for name, _ in FORWARD_KERNELS}
    out["other"] = [0.0, 0]
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        name = next((c for c, frags in FORWARD_KERNELS if any(f in e.key for f in frags)),
                    "other")
        out[name][0] += e.device_time_total / 1e3 / n
        out[name][1] += e.count / n
    return out


def propagation(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640, batches=(1, 8),
                bench_batches=(REFERENCE_BATCH, HEADLINE_BATCH), iters: int = 10,
                sums_cases=SUMS_CASES, pool_cases=POOL_CASES, zoo_imgsz: int = 64):
    """Phase 11: the int8 serving graph as the JAX package runs it
    (quant/ptq.py:propagate_act_quant; CerberusDetInference propagates
    whenever it quantizes). The flagship in bf16 + int8 "all" served at
    batch 1 and 8 (3 requests each, replayed) beside a copy of the same
    model with its annotations cleared: every response, and every replay's
    packed outputs, identical; conv_s8 and quant_pack_s8 once per quantized
    Conv and request, conv_s8 requantizing once per annotated block whose
    last Conv is int8 (check_requant) plus the SPPF / C3 Convs that write
    int8 for their blocks' concats; every annotated block's output (int8)
    equal to the CPU's quantize_act of the unannotated block's; conv_s8
    against its plain version at every distinct conv shape and mode of a
    propagated forward. The headline forward (bench.build, seeded,
    calibrated in float64) at each batch of `bench_batches` with and
    without the annotations, each captured and replayed (HonestLoop), the
    conv-node guard and check_requant on each: ms, img/s, the profiler's
    conv_s8 / quant_pack_s8 / concat / pool shares and the graph pool. The
    int8 routes conv_s8 does not take and the int8 pools on the card against
    the CPU, and the zoo model (every block of the main registry) served on
    the card in int8 "all", propagated and not, identical. Returns the
    kernels-line entry of conv_s8's requantizing mode."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import yaml
    from torch.profiler import ProfilerActivity, profile

    from cerberusdet_tpu_torch import bench
    from cerberusdet_tpu_torch.infer import CerberusDetInference, CerberusPreprocessor
    from cerberusdet_tpu_torch.infer.inference import pack_outputs
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.nn import layers as L
    from cerberusdet_tpu_torch.nn.module import conv2d_int8, quantize_act
    from cerberusdet_tpu_torch.ops import conv_int8_cuda as ci
    from cerberusdet_tpu_torch.ops import nms_cuda
    from cerberusdet_tpu_torch.quant import (
        act_quant_annotations,
        clear_act_quant,
        propagate_act_quant,
    )
    from cerberusdet_tpu_torch.testing import ZOO_CFG
    from cerberusdet_tpu_torch.utils.profiling import (
        HonestLoop,
        check_convs,
        check_requant,
        model_convs,
        requant_convs,
    )

    on_card = dev.type == "cuda"
    wrappers = (ci.conv_s8, ci.quant_pack_s8, nms_cuda.greedy_nms_cuda, ci.quant_s8)
    saved = [w.launches for w in wrappers]
    names = {t: [f"{t}_{i}" for i in range(n)] for t, n in zip(TASKS, NCS)}
    t0 = time.perf_counter()
    model = CerberusModel(cfg, TASKS, NCS, device=dev).init(seed=0)
    distinct_heads(model, seed=1)
    inf = CerberusDetInference(model=model, names=names, conf_thres=CONF, img_size=imgsz,
                               dtype=torch.bfloat16, device=dev, int8="all")
    plain = CerberusDetInference(model=copy.deepcopy(inf.model), names=names, conf_thres=CONF,
                                 img_size=imgsz, dtype=torch.bfloat16, device=dev)
    clear_act_quant(plain.model)
    ann = act_quant_annotations(inf.model)
    n_q = len(inf.int8_convs)
    fused_blocks = requant_convs(inf.model)
    if not ann or act_quant_annotations(plain.model) or len(plain.int8_convs) != n_q:
        raise AssertionError("propagation: the two models are not the annotated and the "
                             "unannotated form of one quantized model")
    log(f"[propagation] {os.path.basename(cfg)} bf16 + int8 all: {n_q} int8 Convs, "
        f"{sum(k == 'q_out' for _, k in ann)} blocks annotated q_out "
        f"({len(fused_blocks)} of them end in an int8 Conv on conv_s8), "
        f"{sum(k == 'q_in' for _, k in ann)} Concat / Upsample q_in; built in "
        f"{time.perf_counter() - t0:.1f} s")

    # the main path: the first request of each batch size captures, then 3 + 3 replayed
    pre = CerberusPreprocessor(img_size=imgsz, device=dev)
    rng = np.random.default_rng(31)
    frames = {bs: [list(rng.integers(0, 256, (bs, 480, 640, 3), dtype=np.uint8))
                   for _ in range(3)] for bs in batches}
    for bs in batches:
        for server in (inf, plain):
            server.predict(*pre.preprocess(frames[bs][0]))
    for w in wrappers:
        w.launches = 0
    served = []
    for bs in batches:
        for imgs in frames[bs]:
            batch, shapes = pre.preprocess(imgs)
            served.append((batch, shapes, inf.predict(batch, original_shape=shapes)))
    got = [w.launches for w in wrappers]
    n_req = len(served)
    x8 = served[-1][0].permute(0, 3, 1, 2).to(torch.bfloat16)
    before = [w.launches for w in wrappers]
    quant_calls = []
    real_quant = ci.quant_s8

    def recording_quant_s8(x, s_x, out=None):
        quant_calls.append((x, s_x, out is not None))
        return real_quant(x, s_x, out)

    requant_convs_seen = []

    def count_requant(mod, args, out):  # a Conv on conv_s8 that wrote int8 requantized
        if mod.int8 and mod.s8_kernel and out.dtype == torch.int8:
            requant_convs_seen.append(mod)

    # the kernel counts its launches under its module's name, the recorder's here
    recording_quant_s8.launches = 0
    mod_quant = sys.modules["cerberusdet_tpu_torch.nn.module"]
    ci.quant_s8 = mod_quant.quant_s8 = recording_quant_s8
    handles = [m.register_forward_hook(count_requant) for m in inf.model.modules()
               if isinstance(m, L.Conv)]
    try:
        inf.model(x8)  # one eager forward: each kernel's launches a forward, quant_s8's inputs
    finally:
        ci.quant_s8 = mod_quant.quant_s8 = real_quant
        for h in handles:
            h.remove()
    real_quant.launches += recording_quant_s8.launches
    per_forward = [w.launches - n for w, n in zip(wrappers, before)]
    for w, n in zip(wrappers, before):
        w.launches = n
    requant_per_forward, quant_per_forward = len(requant_convs_seen), per_forward[3]
    n_blocks = check_requant(inf.model, inf.model, x8, "propagation")
    log(f"[propagation] {n_req} requests: conv_s8 {got[0]}, quant_pack_s8 {got[1]} launches "
        f"(expected {n_q} x {n_req}); of a forward's {per_forward[0]} conv_s8 launches "
        f"{requant_per_forward} requantize in the epilogue (Conv hooks: the {n_blocks} "
        f"annotated blocks' last Convs and the Convs that write int8 for their blocks' "
        f"concats); quant_s8 {got[3]} ({quant_per_forward} a forward: the concats' and "
        f"upsamples' float inputs); NMS {got[2]}")
    if on_card and (got[:2] != [n_q * n_req] * 2 or per_forward[0] != n_q
                    or requant_per_forward < n_blocks or got[2] != len(TASKS) * n_req
                    or got[3] != quant_per_forward * n_req or quant_per_forward == 0):
        raise AssertionError(f"propagation: launches {got} on {n_req} requests")
    main_launches = got

    # quant_s8 against its plain version on every input the forward gave it, and at
    # edge cases, into a new tensor and into a channel slice at an odd offset
    quant_err, seen = 0, set()

    def quant_compare(x, s_x, what):
        ref = ci.quant_s8_plain(x, s_x)
        buf = torch.zeros((x.shape[0], x.shape[1] + 4, x.shape[2], x.shape[3]),
                          dtype=torch.int8, device=x.device)
        for got_q in (ci.quant_s8(x, s_x), ci.quant_s8(x, s_x, buf[:, 3:3 + x.shape[1]])):
            if not torch.equal(got_q, ref):
                log(f"[quant_s8 vs plain] {what}: {int((got_q != ref).sum())} of "
                    f"{ref.numel()} codes differ")
                raise AssertionError("quant_s8 disagrees with its plain version")
        if buf[:, :3].any() or buf[:, 3 + x.shape[1]:].any():
            raise AssertionError(f"quant_s8 wrote outside its channel slice: {what}")
        return int((ci.quant_s8(x, s_x).int() - ref.int()).abs().max())

    before = [w.launches for w in wrappers]
    for x, s_x, _ in quant_calls:
        key = (tuple(x.shape), x.dtype, x.stride())
        if key not in seen:
            seen.add(key)
            quant_err = max(quant_err, quant_compare(x, s_x, f"{key}"))
    s_e = torch.tensor(0.029, device=dev)
    gen_e = torch.Generator(device=dev).manual_seed(13)
    for name, shape, view in PACK_EDGE_CASES:
        base = torch.randn(shape, generator=gen_e, device=dev) * 2.5
        for xt in (base.to(torch.bfloat16), base, quantize_act(base, s_e)):
            quant_err = max(quant_err, quant_compare(view(xt), s_e, name))
    log(f"[quant_s8 vs plain] the {len(quant_calls)} quantizes of a propagated batch-"
        f"{x8.shape[0]} forward ({len(seen)} distinct inputs) and the edge cases of "
        f"quant_pack_s8 (misaligned planes, odd channel slices, channels-last views, HW 1; "
        f"bf16, float32, int8), each into a new tensor and into a channel slice at offset 3: "
        f"identical, nothing written outside the slice")
    big = max(quant_calls, key=lambda c: (c[0].dtype != torch.int8, c[0].numel()))
    xb, sb_ = big[0], big[1]
    q_ms, q_how = kernel_ms(lambda: ci.quant_s8(xb, sb_), 20, "quant_nchw") if on_card else (
        0.0, "the CPU")
    qp_ms = cuda_ms(lambda: ci.quant_s8_plain(xb, sb_), iters=5)
    q_bytes = xb.numel() * (xb.element_size() + 1)
    for w, n in zip(wrappers, before):
        w.launches = n
    log(f"[quant_s8 at main-path shapes] x {tuple(xb.shape)} {xb.dtype} -> int8: kernel "
        f"{q_ms:.4f} ms ({q_how}), bound {q_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"({100 * q_bytes / HBM_BYTES_PER_S * 1e3 / max(q_ms, 1e-9):.1f}%); plain (5 PyTorch "
        f"ops) {qp_ms:.3f} ms  [{card}]")
    quant_entry = {
        "name": "quant_s8",
        "route": "cuda",
        "source": "cerberusdet_tpu_torch/csrc/conv_int8.cu",
        "replaces": "cerberusdet_tpu/nn/module.py:162 (quantize_act where the propagated "
                    "graph quantizes outside a conv; XLA fuses it, no Pallas kernel)",
        "shape": f"{tuple(xb.shape)} {str(xb.dtype).split('.')[-1]}",
        "launches": main_launches[3],
        "max_abs_err": quant_err,
        "ms": q_ms,
        "plain_ms": qp_ms,
        "bound_ms": q_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,  # torch.quantize_per_tensor divides and clamps to [-128, 127]
        "ms_source": q_how,
    }
    del quant_calls, big, xb

    # the same requests unannotated: identical responses and device outputs
    args = (CONF, 0.45, 0.8, False, 300)
    for batch, shapes, out in served:
        same_results(out, plain.predict(batch, original_shape=shapes), score_rtol=0.0)
        xb = torch.as_tensor(batch)
        a = inf.programs[inf.program_key(xb, *args)].run(xb) if on_card else pack_outputs(
            *inf.predict_device(xb.to(dev), *args))
        b = plain.programs[plain.program_key(xb, *args)].run(xb) if on_card else pack_outputs(
            *plain.predict_device(xb.to(dev), *args))
        if not torch.equal(a, b):
            raise AssertionError("propagation: a propagated request differs from the same "
                                 "request unannotated")
    if on_card:
        for server in (inf, plain):
            if len(server.programs) != len(batches) or \
                    sum(p.replays for p in server.programs.values()) < n_req:
                raise AssertionError("propagation: the requests did not replay their graphs")
    n_det = sum(len(r) for _, _, out in served for r in out)
    log(f"[propagation] batch {' and '.join(map(str, batches))}, {n_req} replayed requests: "
        f"propagated == unannotated, responses and packed device outputs bit for bit "
        f"({n_det} detections)")

    # each annotated block's int8 output against the CPU's quantize_act of the unannotated one
    outs = {"p": {}, "u": {}}

    def keep(tag, uid):
        def hook(mod, a, out):
            outs[tag][uid] = out
        return hook

    hooks = []
    for uid, _ in ann:
        hooks.append(inf.model.block(uid).register_forward_hook(keep("p", uid)))
        hooks.append(plain.model.block(uid).register_forward_hook(keep("u", uid)))
    before = [w.launches for w in wrappers]
    inf.model(x8)
    plain.model(x8)
    for h in hooks:
        h.remove()
    n_bytes = [0, 0]
    for (uid, name), scale in ann.items():
        p_out, u_out = outs["p"][uid], outs["u"][uid]
        ref = quantize_act(u_out.cpu(), torch.tensor(scale, dtype=torch.float32))
        if p_out.dtype != torch.int8 or not torch.equal(p_out.cpu(), ref):
            raise AssertionError(f"propagation: block {uid} ({name}) hands on other int8 than "
                                 f"the CPU's quantize_act of the unannotated block's output")
        n_bytes[0] += p_out.numel() * p_out.element_size()
        n_bytes[1] += u_out.numel() * u_out.element_size()
    log(f"[propagation] the {len(ann)} annotated blocks' outputs of a batch-{x8.shape[0]} "
        f"forward: int8, each equal to the CPU's quantize_act of the unannotated block's bf16 "
        f"output; "
        f"{n_bytes[0] / 2**20:.1f} MiB handed on instead of {n_bytes[1] / 2**20:.1f} MiB")

    # conv_s8 against its plain version at every distinct conv shape and mode of the forward
    checked, calls = {}, {}
    val_batch_convs(inf.model, x8, None, checked, calls)
    for w, n in zip(wrappers, before):
        w.launches = n
    req_keys = [k for k in checked if k[-1]]
    log(f"[conv_s8 vs plain] the propagated forward's {len(checked)} distinct (B, Ci, Co, k, s, "
        f"H, W, requantizing) conv calls, {len(req_keys)} of them requantizing bf16(y) with "
        f"the consumer's scale: identical, as quant_pack_s8 on their inputs (int8 or bf16)")
    key = max(req_keys, key=lambda c: c[0] * c[1] * c[2] * c[3] ** 2 * c[5] * c[6] // c[4] ** 2)
    b, c_in, c_out, k, st, h, w, _ = key
    ho, wo = (h + 2 * (k // 2) - k) // st + 1, (w + 2 * (k // 2) - k) // st + 1
    kmacs = b * ho * wo * c_out * c_in * k * k
    ci16 = ci.padded_channels(c_in)
    nbytes = b * h * w * ci16 + c_out * k * k * ci16 + 12 * c_out + b * c_out * ho * wo
    ops_ms, bytes_ms = 2 * kmacs / INT8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    k_ms, p_ms = checked[key][4], checked[key][0]
    log(f"[conv_s8 requantizing at main-path shapes] {k}x{k} s{st} {c_in}->{c_out} at {h}x{w}, "
        f"batch {b}, int8 of bf16(y) out: kernel {k_ms:.4f} ms (CUDA events, mean of 5), bound "
        f"{max(ops_ms, bytes_ms):.4f} ms ({100 * max(ops_ms, bytes_ms) / max(k_ms, 1e-9):.1f}%); "
        f"plain "
        f"{p_ms:.3f} ms  [{card}]")
    entry = {
        "name": "conv_s8 (int8 of bf16(y), the propagated graph's requantize)",
        "route": "cuda",
        "source": "cerberusdet_tpu_torch/csrc/conv_int8.cu",
        "replaces": "cerberusdet_tpu/ops/conv_int8_pallas.py:65 (q_out, :120-123; here of the "
                    "bf16-rounded value, cerberusdet_tpu/models/cerberus.py:226-234)",
        "shape": f"{k}x{k} s{st} {c_in}->{c_out} at {h}x{w}, batch {b}",
        "launches": requant_per_forward * n_req,  # of conv_s8's, by the Conv hooks
        "max_abs_err": max(checked[q][2] for q in req_keys),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,  # no PyTorch call computes an int8 convolution and requantizes
    }
    del inf, plain, served, outs, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the headline forward with and without the annotations
    t0 = time.perf_counter()
    hmodel = bench.build(cfg, dev, True, imgsz)
    ann_h = act_quant_annotations(hmodel)
    n_convs, n_int8 = model_convs(hmodel)
    counted = (ci.quant_pack_s8, ci.conv_s8)
    log(f"[propagation headline] bench.build: {n_int8} int8 Convs, {len(ann_h)} annotations, "
        f"in {time.perf_counter() - t0:.1f} s")
    rows = {}
    for bs, order in zip(bench_batches, ((True, False), (False, True))):
        img = bench.make_input(bs, imgsz, dev)
        for prop in order:
            if prop:
                propagate_act_quant(hmodel)
                if act_quant_annotations(hmodel) != ann_h:
                    raise AssertionError("propagation: re-annotating gave other annotations")
            else:
                clear_act_quant(hmodel)
            label = f"batch {bs} {'propagated' if prop else 'unannotated'}"
            fn = bench.forward_fn(hmodel)
            n_blocks = check_requant(hmodel, fn, img, label)
            with HonestLoop(fn, img, counted) as loop:
                nodes = loop.conv_nodes()
                if nodes is not None:
                    check_convs(nodes, n_convs, n_int8, label)
                per_replay = (dict(zip(("quant_pack_s8", "conv_s8"),
                                       loop.prog.launches)) if loop.prog is not None else {})
                ms, host_ms = loop.time(iters)
                acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
                with profile(activities=acts) as prof:
                    loop.step(2)
                    if on_card:
                        torch.cuda.synchronize()
                parts = forward_breakdown(prof, 2)
                pool = loop.pool_mib()
            ms = ms if ms is not None else host_ms
            total = sum(v[0] for v in parts.values())
            rows[(bs, prop)] = (ms, parts, pool)
            share = ", ".join(f"{k} {v[0]:.3f} ms ({100 * v[0] / max(total, 1e-9):.1f}%, "
                              f"{v[1]:.0f} launches)" for k, v in parts.items())
            log(f"[propagation headline] {label}: {ms:.3f} ms a forward (CUDA events, best of 3 "
                f"rounds of {iters} replays), {bs / ms * 1e3:.1f} img/s, host {host_ms:.3f} ms; "
                f"graph: {nodes['kernels'] if nodes else '-'} kernel nodes, launches a replay "
                f"{per_replay}, {n_blocks} blocks requantized in conv_s8, pool "
                f"{pool if pool is None else round(pool, 1)} MiB; device time of a replay "
                f"{total:.3f} ms: {share}  [{card}]")
    propagate_act_quant(hmodel)
    for bs in bench_batches:
        a, b = rows[(bs, True)][0], rows[(bs, False)][0]
        log(f"[propagation headline] batch {bs}: propagated {a:.3f} ms, unannotated {b:.3f} ms, "
            f"propagated / unannotated {a / b:.3f}  [{card}]")
    del hmodel
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the int8 routes conv_s8 does not take, and the int8 pools, on the card against the CPU
    if on_card:
        try:
            F.max_pool2d(torch.zeros((1, 1, 5, 5), dtype=torch.int8, device=dev), 5, 1, 2)
            native = "runs (max_pool takes its bf16 route on the card all the same)"
        except RuntimeError as e:
            native = f"raises ({str(e).splitlines()[0][:90]})"
        log(f"[int8 pools] torch's CUDA max_pool2d on int8: {native}")
    gen = torch.Generator().manual_seed(41)
    for shape, k in pool_cases:
        x = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
        x[0, 0] = -127
        got, ref = L.max_pool(x.to(dev), k).cpu(), L.max_pool(x, k)
        if got.dtype != torch.int8 or not torch.equal(got, ref):
            raise AssertionError(f"the int8 max pool on the card differs from the CPU's at "
                                 f"{shape} k {k}")
        p_ms = cuda_ms(lambda: L.max_pool(x.to(dev), k), iters=5) if on_card else 0.0
        log(f"[int8 pools] {shape} k {k}: card (bf16 route) == CPU (int8 pool); "
            f"{p_ms:.4f} ms on the card (events, with the copy of x)")
    for what, c_in, c_out, k, st, g, b, h, w in sums_cases:
        cg = c_in // g
        xq = torch.randint(-127, 128, (b, c_in, h, w), generator=gen, dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, k, cg, c_out), generator=gen, dtype=torch.int8)
        p = {"w_q": ci.pack_weight(wq), "s_x": torch.tensor(0.01),
             "s_w": torch.rand(c_out, generator=gen) * 1e-3 + 1e-4,
             "b": torch.randn(c_out, generator=gen)}
        pd = {key: v.to(dev) for key, v in p.items()}
        sums = ci.conv_sums_s8(xq.to(dev), pd["w_q"], st, k // 2, 1, g).cpu()
        if not torch.equal(sums, ci.conv_sums_s8(xq, p["w_q"], st, k // 2, 1, g)):
            raise AssertionError(f"the int8 float64-conv route's sums on the card differ from "
                                 f"the CPU's: {what}")
        q = torch.tensor(0.02)
        worst = {}
        for dtype in (torch.float32, torch.bfloat16):
            kw = dict(act=True, out_dtype=dtype, groups=g)
            y_card = conv2d_int8(xq.to(dev), pd, st, **kw).cpu().double()
            y_cpu = conv2d_int8(xq, p, st, **kw).double()
            q_card = conv2d_int8(xq.to(dev), pd, st, q_out=q.to(dev), **kw).cpu().int()
            q_cpu = conv2d_int8(xq, p, st, q_out=q, **kw).int()
            rel = float(((y_card - y_cpu).abs() / y_cpu.abs().clamp(min=1e-30)).max())
            steps = int((q_card - q_cpu).abs().max())
            worst[str(dtype).split(".")[-1]] = (rel, steps)
            if rel > (2 ** -7 if dtype == torch.bfloat16 else 1e-6) or steps > 1:
                raise AssertionError(f"the int8 float64-conv route on the card is off the "
                                     f"CPU's: {what} {dtype}: {rel} relative, {steps} steps")
        xq_d = xq.to(dev)
        t_ms = cuda_ms(lambda: conv2d_int8(xq_d, pd, st, act=True, out_dtype=torch.bfloat16,
                                           groups=g), iters=5) if on_card else 0.0
        log(f"[int8 float64-conv route] {what}: int32 sums card == CPU; the epilogue (float32 "
            f"| bf16 out: largest relative difference, int8 out: largest step) {worst} (the "
            f"card's and the CPU's SiLU round apart); {t_ms:.3f} ms on the card in bf16  "
            f"[{card}]")

    # the zoo model: every block of the main registry, on the card, int8 all
    with tempfile.TemporaryDirectory() as tmp:
        zoo_path = os.path.join(tmp, "zoo.yaml")
        with open(zoo_path, "w") as f:
            yaml.safe_dump(ZOO_CFG, f)
        zoo = CerberusModel(zoo_path, ["a", "b"], [3, 5], device=dev).init(seed=4)
        distinct_heads(zoo, seed=5)
        zoo_names = {"a": ["c0", "c1", "c2"], "b": ["k0", "k1", "k2", "k3", "k4"]}
        zinf = CerberusDetInference(model=zoo, names=zoo_names, conf_thres=CONF,
                                    img_size=zoo_imgsz, dtype=torch.bfloat16, device=dev,
                                    int8="all")
        zplain = CerberusDetInference(model=copy.deepcopy(zinf.model), names=zoo_names,
                                      conf_thres=CONF, img_size=zoo_imgsz,
                                      dtype=torch.bfloat16, device=dev)
        clear_act_quant(zplain.model)
        convs = [m for m in zinf.model.modules() if isinstance(m, L.Conv)]
        n_sums = sum(m.int8 and not m.s8_kernel for m in convs)
        xs = np.random.default_rng(7).uniform(0, 1, (4, zoo_imgsz, zoo_imgsz, 3))
        for _ in range(2):  # the capture, then a replay
            a, b = zinf.predict(xs), zplain.predict(xs)
            same_results(a, b, score_rtol=0.0)
        xz = torch.as_tensor(xs, dtype=torch.float32)
        n_z = check_requant(zinf.model, zinf.model, xz.to(dev).permute(0, 3, 1, 2).to(
            torch.bfloat16), "zoo")
        kinds = sorted({type(zinf.model.block(u)).__name__ for u in zinf.model.block_nodes})
        log(f"[zoo] {len(convs)} Convs ({n_sums} on the int8 float64-conv route) of blocks "
            f"{kinds}, bf16 + int8 all at {zoo_imgsz} px on the card: propagated == unannotated "
            f"responses, identical, replayed; {len(act_quant_annotations(zinf.model))} "
            f"annotations, {n_z} blocks requantized in conv_s8; "
            f"{sum(map(len, a))} detections")
    for w, n in zip(wrappers, saved):
        w.launches = n
    return [entry, quant_entry]


# phase 12's cells: the evolver's generations over the train entry point's
# seeded set cut to 16 train / 8 val JPEGs a task and 1 epoch a generation
# (the time limit); the Ensemble's batch of 480x640 frames; bench_c2f_split's
# batch, with 10 replays a timed round
EVOLVE_TRAIN, EVOLVE_VAL, EVOLVE_GENERATIONS = 16, 8, 2
ENSEMBLE_BATCH, C2F_BATCH, C2F_ITERS = 8, 32, 10
OPTIONAL_PACKAGES = ("matplotlib", "mlflow", "ray", "orbax", "tensorstore")
GIB = 2 ** 30


def evolve_run(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640,
               n_train: int = EVOLVE_TRAIN, n_val: int = EVOLVE_VAL,
               batch: int = TRAIN_CLI_BATCH, generations: int = EVOLVE_GENERATIONS,
               workers=None):
    """The genetic evolver through cli/train.py's options (--evolve, 1 epoch
    a generation, --bf16, batch 8,8, the paper's hyps, the seeded flagship as
    --weights) with seed 0: cli_train.evolver's Yolov5Evolver, whose
    generations each train a TrainLoop (the captured step) with noval, then
    validate it per task, and close it. Gates: evolve.json holds the
    generations; the second generation's hyps lie inside DEFAULT_META's
    bounds, differ from the first's, and equal the mutation a fresh evolver
    with seed 0 replays on the host from the first's logged results; in each
    generation the TAL kernels launch once per task and step (and per val
    batch and task with losses), the NMS kernel once per val batch and task;
    a generation's peak memory does not grow by a step pool (2 GiB slack)
    and the memory held after each generation's close does not grow (1 GiB).
    Returns the TAL kernels' entries at the first generation's first batch."""
    import types

    import torch

    from cerberusdet_tpu_torch.cli import train as cli_train
    from cerberusdet_tpu_torch.evaluation import val as val_mod
    from cerberusdet_tpu_torch.evolve.base_evolver import DEFAULT_META
    from cerberusdet_tpu_torch.evolve.yolov5_evolver import Yolov5Evolver
    from cerberusdet_tpu_torch.ops import nms_cuda, tal_cuda
    from cerberusdet_tpu_torch.train import loss as loss_mod
    from cerberusdet_tpu_torch.train import trainer as trainer_mod
    from cerberusdet_tpu_torch.train.step import MultiTaskTrainer

    on_card = dev.type == "cuda"
    kern = {"nms": nms_cuda.greedy_nms_cuda, "tal_select": tal_cuda.select_kernel,
            "tal_assign": tal_cuda.assign_kernel, "tal_norm": tal_cuda.norm_kernel}
    saved_counts = {k: f.launches for k, f in kern.items()}
    patches = []

    def patch(obj, name, new):
        patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    root = tempfile.mkdtemp(prefix="cerberus_evolve_")
    try:
        t0 = time.perf_counter()
        data_yaml, weights = write_train_set(root, cfg, imgsz, dev, n_train, n_val)
        argv = ["--data", data_yaml, "--device", str(dev), "--cfg", cfg, "--hyp", PAPER_HYP,
                "--imgsz", str(imgsz), "--batch-size", f"{batch},{batch}", "--bf16",
                "--warmup-min-iters", "4", "--weights", weights, "--epochs", "1",
                "--project", os.path.join(root, "runs"), "--name", "E", "--seed", "0",
                "--evolve", str(generations)] + (["--workers", str(workers)] if workers else [])
        opt_ns, opt, hyp, data, device = cli_train.options(argv)
        ev = cli_train.evolver(opt, opt_ns, hyp, data, device, seed=0)
        log(f"[evolve] {n_train} train / {n_val} val JPEGs a task, the seeded "
            f"{os.path.basename(cfg)} as --weights, {type(ev).__name__} seed 0 in "
            f"{opt.project}/{opt.name}; set up in {time.perf_counter() - t0:.2f} s")

        probe = {"tasks_stepped": 0, "vals": []}
        real_step = MultiTaskTrainer.step

        def step(self, state, batches, *a, **kw):
            probe["tasks_stepped"] += len(batches)
            return real_step(self, state, batches, *a, **kw)

        patch(MultiTaskTrainer, "step", step)

        def counting(real):
            def run_task(model, task, loader, *a, **kw):
                probe["vals"].append((len(loader), kw.get("compute_loss") is not None))
                return real(model, task, loader, *a, **kw)
            return run_task

        patch(trainer_mod, "run_task", counting(trainer_mod.run_task))  # the loop's val
        patch(val_mod, "run_task", counting(val_mod.run_task))  # train_once's val
        captured = {}
        real_assign = loss_mod.task_aligned_assign

        def assign(*a, **kw):
            if "tal" not in captured:
                captured["tal"] = ([v.detach().clone() for v in a[:6]], kw["num_classes"])
            return real_assign(*a, **kw)

        patch(loss_mod, "task_aligned_assign", assign)

        gens = []
        real_once = ev.train_once

        def train_once(h):
            for f in kern.values():
                f.launches = 0
            probe.update(tasks_stepped=0, vals=[])
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = real_once(h)
            if on_card:
                torch.cuda.synchronize()
            gens.append({
                "s": time.perf_counter() - t, "counts": {k: f.launches for k, f in kern.items()},
                "tasks_stepped": probe["tasks_stepped"], "vals": list(probe["vals"]),
                "peak": torch.cuda.max_memory_allocated() / GIB if on_card else float("nan"),
                "held": torch.cuda.memory_allocated() / GIB if on_card else float("nan"),
                "reserved": torch.cuda.memory_reserved() / GIB if on_card else float("nan")})
            return out

        ev.train_once = train_once
        t0 = time.perf_counter()
        ev.run_evolution()
        wall = time.perf_counter() - t0

        for g, r in enumerate(gens):
            val_batches = sum(v[0] for v in r["vals"])
            loss_batches = sum(v[0] for v in r["vals"] if v[1])
            expect = {"nms": val_batches, **{k: r["tasks_stepped"] + loss_batches
                                             for k in TAL_KERNELS}}
            log(f"[evolve] generation {g + 1}: {r['s']:.1f} s; {r['tasks_stepped']} task steps, "
                f"{len(r['vals'])} task vals over {val_batches} batches ({loss_batches} with "
                f"losses); launches {r['counts']}, expected {expect}; peak memory "
                f"{r['peak']:.2f} GiB, after its close {r['held']:.2f} GiB allocated, "
                f"{r['reserved']:.2f} GiB reserved  [{card}]")
            if on_card and (r["counts"] != expect or not all(r["counts"].values())):
                raise AssertionError(f"evolve generation {g + 1}: kernel launches "
                                     f"{r['counts']} != {expect}")
        if len(gens) != generations:
            raise AssertionError(f"evolve: {len(gens)} generations ran, not {generations}")
        if on_card and (max(r["peak"] for r in gens) > gens[0]["peak"] + 2
                        or max(r["held"] for r in gens) > gens[0]["held"] + 1):
            raise AssertionError("evolve: a generation kept the memory of an earlier one "
                                 f"(peaks {[r['peak'] for r in gens]} GiB, held after close "
                                 f"{[r['held'] for r in gens]} GiB)")

        muts = ev.file_logger.read_mutations()
        if [m["step"] for m in muts] != list(range(generations)):
            raise AssertionError(f"evolve.json holds steps {[m['step'] for m in muts]}")
        first, second = muts[0]["hyps"], muts[1]["hyps"]
        out_of_bounds = [k for k, (_, lo, hi, _) in DEFAULT_META.items() if k in second and any(
            not lo <= v <= hi for v in (second[k] if isinstance(second[k], list)
                                        else [second[k]]))]
        if out_of_bounds or first == second:
            raise AssertionError(f"evolve: generation 2's hyps out of bounds at "
                                 f"{out_of_bounds} or equal to generation 1's")
        replay = Yolov5Evolver(types.SimpleNamespace(project=os.path.join(root, "replay"),
                                                     name="r", epochs=1), hyp, data,
                               generations=generations, seed=0)
        start = replay.bound_hyp_values(copy.deepcopy(hyp))
        replay.file_logger.append_mutation_to_file(first, muts[0]["results_per_task"], 1, 0)
        if start != first or replay.get_next_hyp(start) != second:
            raise AssertionError("evolve: the host's replay of the mutation from generation "
                                 "1's logged results differs from generation 2's hyps")
        changed = sorted(k for k in first if first[k] != second[k])
        log(f"[evolve] {generations} generations in {wall:.1f} s: evolve.json has them, "
            f"generation 2 mutated {len(changed)} hyps ({', '.join(changed[:6])}, ...) inside "
            f"DEFAULT_META's bounds, and a fresh Yolov5Evolver(seed=0) replaying the mutation "
            f"from generation 1's logged results on the host gives generation 2's hyps exactly; "
            f"fitness {[round(sum(0.1 * r[2] + 0.9 * r[3] for r in m['results_per_task'].values()) / len(TASKS), 5) for m in muts]}"
            f"  [{card}]")
        args, nc = captured["tal"]
        total = {k: sum(r["counts"][k] for r in gens) for k in TAL_KERNELS}
        return tal_entries(args, nc, total, "evolver: a generation's augmented batch", card,
                           {k: {"launches_by_generation": [r["counts"][k] for r in gens]}
                            for k in TAL_KERNELS})
    finally:
        for obj, name, orig in reversed(patches):
            setattr(obj, name, orig)
        for k, f in kern.items():
            f.launches = saved_counts[k]
        shutil.rmtree(root, ignore_errors=True)


def ensemble_run(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640,
                 batch: int = ENSEMBLE_BATCH):
    """The checkpoint Ensemble: two seeded flagship checkpoints (seeds 0 and
    1, box biases re-drawn, BatchNorm statistics from the batch) through
    manager/attempt_load.py:attempt_load([a, b]) on `dev`, a batch of seeded
    480x640 frames letterboxed by the preprocessor through the Ensemble's
    eval forward (each task's candidates the two members' concatenated:
    16800 at 640 px) and per-task NMS (ops/nms.py, the kernel route on the
    card, which takes the 16384 best-scoring). Gates: the detections equal
    the plain NMS loop's on the card with max_nms 16384, bit for bit; the NMS
    kernel launches once per task; its input holds at most 16384 candidates.
    Returns the NMS kernel's entry at this traffic."""
    import numpy as np
    import torch

    from cerberusdet_tpu_torch.evaluation.val import eval_flags
    from cerberusdet_tpu_torch.infer import CerberusPreprocessor
    from cerberusdet_tpu_torch.manager.attempt_load import Ensemble, attempt_load
    from cerberusdet_tpu_torch.manager.checkpoint import save_checkpoint
    from cerberusdet_tpu_torch.manager.weights import export_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.ops import nms as nms_mod
    from cerberusdet_tpu_torch.ops import nms_cuda
    from cerberusdet_tpu_torch.ops.nms import non_max_suppression
    from cerberusdet_tpu_torch.testing import calibrate_bn

    nms = nms_cuda.greedy_nms_cuda
    saved = nms.launches
    real_nms = nms_mod.greedy_nms_cuda
    root = tempfile.mkdtemp(prefix="cerberus_ensemble_")
    try:
        t0 = time.perf_counter()
        rng = np.random.default_rng(8)
        frames = list(rng.integers(0, 256, (batch, 480, 640, 3), dtype=np.uint8))
        bt, _ = CerberusPreprocessor(img_size=imgsz, device=dev).preprocess(frames)
        x = torch.as_tensor(bt).to(dev).permute(0, 3, 1, 2).float()
        names = [[f"{t}_{i}" for i in range(n)] for t, n in zip(TASKS, NCS)]
        paths = []
        for seed in (0, 1):
            m = CerberusModel(cfg, TASKS, NCS, device=dev).init(seed)
            distinct_heads(m, seed=seed + 1)
            calibrate_bn(m, x)
            paths.append(os.path.join(root, f"member{seed}.ckpt.npz"))
            save_checkpoint(paths[-1], export_jax_params(m), {
                "cfg": cfg, "task_ids": TASKS, "nc": NCS, "names": names}, half=False)
            del m
        ens, meta = attempt_load(paths, device=dev)
        if not isinstance(ens, Ensemble) or len(ens.members) != 2:
            raise AssertionError("attempt_load of two weights did not return an Ensemble")
        ens.eval()
        log(f"[ensemble] 2 seeded {os.path.basename(cfg)} checkpoints loaded by "
            f"attempt_load, fused, float32, in {time.perf_counter() - t0:.1f} s")

        inputs = {}

        def counting_nms(boxes, scores, iou_thres, max_det):
            inputs.setdefault("first", (boxes.clone(), scores.clone(), iou_thres, max_det))
            inputs.setdefault("k", []).append(scores.shape[1])
            return real_nms(boxes, scores, iou_thres, max_det)

        nms_mod.greedy_nms_cuda = counting_nms
        nms.launches = 0
        with torch.no_grad(), eval_flags():
            t = time.perf_counter()
            preds = ens(x)
            out = {t_: non_max_suppression(preds[t_], nc=nc, conf_thres=CONF, iou_thres=0.45,
                                           max_det=300) for t_, nc in zip(TASKS, NCS)}
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = nms.launches
            plain = {t_: non_max_suppression(preds[t_], nc=nc, conf_thres=CONF, iou_thres=0.45,
                                             max_det=300, max_nms=nms_cuda.MAX_K,
                                             use_kernel=False) for t_, nc in zip(TASKS, NCS)}
        nms_mod.greedy_nms_cuda = real_nms
        n_cand = {t_: preds[t_].shape[1] for t_ in TASKS}
        for t_ in TASKS:
            (d, c), (dp, cp) = out[t_], plain[t_]
            if not (torch.equal(d, dp) and torch.equal(c, cp)):
                raise AssertionError(f"ensemble {t_}: the kernel's detections differ from the "
                                     f"plain NMS loop's")
            if int(c.sum()) == 0:
                raise AssertionError(f"ensemble {t_}: no detections")
        on_card = dev.type == "cuda"
        if on_card and (launches != len(TASKS) or max(inputs["k"]) > nms_cuda.MAX_K):
            raise AssertionError(f"ensemble: {launches} NMS launches for {len(TASKS)} tasks, "
                                 f"K {inputs['k']}")
        log(f"[ensemble] a batch of {batch} 480x640 frames (letterboxed to {tuple(x.shape[2:])}): "
            f"{n_cand} candidates a task (2 members concatenated), the NMS kernel's K "
            f"{inputs.get('k')} (max_nms clamped to {nms_cuda.MAX_K}); {launches} NMS launches; "
            f"forward + NMS {1e3 * wall:.1f} ms (host clock); detections "
            f"{[int(out[t_][1].sum()) for t_ in TASKS]} equal to the plain loop's on the card "
            f"with max_nms {nms_cuda.MAX_K}, bit for bit  [{card}]")
        if "first" not in inputs:  # the CPU takes the plain loop: no kernel input
            return []
        boxes, scores, iou, max_det = inputs["first"]
        return [nms_kernel_entry(boxes, scores, iou, max_det,
                                 "Ensemble traffic: 2 members, 16800 candidates clamped",
                                 launches, card)]
    finally:
        nms_mod.greedy_nms_cuda = real_nms
        nms.launches = saved
        shutil.rmtree(root, ignore_errors=True)


def c2f_split_run(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640,
                  batch: int = C2F_BATCH, iters: int = C2F_ITERS, check_imgsz: int = 128):
    """tools/bench_c2f_split.py's measurement on the flagship at `batch`,
    bf16 and int8 "all" (propagated): the split against the concat route
    (float32 within 1e-4 at check_imgsz; int8 bit for bit), then each
    variant timed with the headline's method and the split's own conv-node
    guard. In int8 the split's eager forward launches conv_s8 once per conv
    the concat forward has plus 1 + n per C2f (int32 mode a chunk), and its
    timed loop launches conv_s8; conv_s8 in int32 mode equals its plain
    version at the split's largest chunk conv (every mode), and
    torch._int_mm's sums there. Returns conv_s8's entry in the split."""
    import torch

    from cerberusdet_tpu_torch.ops import conv_int8_cuda as ci
    from cerberusdet_tpu_torch.tools import bench_c2f_split as tool

    on_card = dev.type == "cuda"
    counters = (ci.conv_s8, ci.quant_pack_s8, ci.quant_s8)
    saved = [c.launches for c in counters]
    results = {}
    try:
        for int8 in (False, True):
            tag = "_int8" if int8 else ""
            t0 = time.perf_counter()
            model = tool.build(cfg, NCS, dev, int8, imgsz)
            err = tool.check_equal(model, int8, check_imgsz)
            img = tool.make_input(batch, imgsz, dev)
            n_convs, n_int8 = tool.split_convs(model)
            base = tool.model_convs(model)
            log(f"[c2f split] {'int8 all, propagated' if int8 else 'bf16'}: the split equals "
                f"the concat route at {check_imgsz} px "
                f"{'bit for bit' if int8 else f'in float32 within {err:.3g} of each tensor (limit 1e-4)'}"
                f" (every C2f output and the predictions); "
                f"convs a forward {base[0]} -> {n_convs}, on conv_s8 {base[1]} -> {n_int8}; "
                f"built in {time.perf_counter() - t0:.1f} s")
            if int8:
                n_concat = tool.conv_s8_launches(model, img)
                calls = []
                real = tool.conv_s8

                def recording(*a, **kw):
                    calls.append(a)
                    return real(*a, **kw)

                tool.conv_s8 = recording
                try:
                    with tool.split_c2f(model):
                        n_split = tool.conv_s8_launches(model, img)
                finally:
                    tool.conv_s8 = real
                log(f"[c2f split] conv_s8 launches of one eager forward: concat {n_concat}, "
                    f"split {n_split} ({len(calls)} of them int32-mode chunk convs)")
                if on_card and (n_concat, n_split) != (base[1], n_int8):
                    raise AssertionError(f"c2f split: conv_s8 launches {n_concat} / {n_split}, "
                                         f"not {base[1]} / {n_int8}")
            for name, run in ((f"baseline_concat{tag}", tool.time_forward),
                              (f"c2f_sumsplit{tag}", tool.time_split)):
                for c in counters:
                    c.launches = 0
                r = run(model, img, iters)
                counts = [c.launches for c in counters]
                ms = r["ms"] if r["ms"] is not None else r["host_ms"]
                results[name] = {"ms_per_batch": ms, "img_per_s": batch / ms * 1e3,
                                 "pool_mib": r["pool_mib"], "launches": counts}
                log(f"[c2f split] {name}: {ms:.3f} ms a batch of {batch}, "
                    f"{batch / ms * 1e3:.1f} img/s (device, best of 3 rounds of {iters} "
                    f"replays), graph pool {r['pool_mib']} MiB, conv nodes {r['conv_nodes']}, "
                    f"launches (conv_s8, quant_pack_s8, quant_s8) {counts}  [{card}]")
                if on_card and int8 and not counts[0]:
                    raise AssertionError(f"c2f split: {name} launched no conv_s8")
            if not int8:
                del model
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
        split_launches = results["c2f_sumsplit_int8"]["launches"][0]
        print(json.dumps({k: {"ms_per_batch": round(v["ms_per_batch"], 2),
                              "img_per_s": round(v["img_per_s"], 1)}
                          for k, v in results.items()}), flush=True)

        # conv_s8 in int32 mode at the split's largest chunk conv
        xq, w, s_x, s_w, b = max(calls, key=lambda a: a[0].numel() * a[1].shape[0])[:5]
        max_err = conv_s8_compare(xq, w, s_x, s_w, b, 1, False) if on_card else 0.0
        call = (xq, w, s_x, s_w, b, 1, 0, False, torch.int32)
        k_ms, how = kernel_ms(lambda: ci.conv_s8(*call), 10, "conv_s8_kernel")
        p_ms = cuda_ms(lambda: ci.conv_s8_plain(*call), iters=3, warmup=1)
        bsz, h, wd, ci16 = xq.shape
        co = w.shape[0]
        macs = bsz * h * wd * co * ci16
        lib_ms = None
        if on_card:
            a2, b2 = xq.reshape(-1, ci16), w.reshape(co, -1).t()
            if not torch.equal(torch._int_mm(a2, b2).reshape(bsz, h, wd, co).permute(0, 3, 1, 2),
                               ci.conv_s8(*call)):
                raise AssertionError("torch._int_mm disagrees with conv_s8's int32 sums")
            lib_ms = cuda_ms(lambda: torch._int_mm(a2, b2), iters=10)
        ops_ms = 2 * macs / INT8_OPS_PER_S * 1e3
        bytes_ms = (xq.numel() + w.numel() + 8 * co + 4 * bsz * h * wd * co) / HBM_BYTES_PER_S * 1e3
        log(f"[conv_s8 at the split's shapes] 1x1 {ci16}->{co} at {h}x{wd}, batch {bsz}, int32 "
            f"out: kernel {k_ms:.4f} ms ({how}), bound {max(ops_ms, bytes_ms):.4f} ms, plain "
            f"{p_ms:.3f} ms, torch._int_mm {lib_ms} ms; identical in every mode  [{card}]")
        return [{
            "name": f"conv_s8 (c2f split: int32 mode a chunk, 1x1 {ci16}->{co} at {h}x{wd}, "
                    f"batch {bsz})",
            "route": "cuda",
            "source": "cerberusdet_tpu_torch/csrc/conv_int8.cu",
            "replaces": "cerberusdet_tpu/ops/conv_int8_pallas.py:65",
            "launches": split_launches,
            "launches_per_forward": {"concat": base[1], "split": n_int8},
            "max_abs_err": max_err,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms,
        }]
    finally:
        for c, n in zip(counters, saved):
            c.launches = n


def user_surface(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640, evolve_kw=None,
                 ensemble_kw=None, c2f_kw=None):
    """Phase 12: ROADMAP item 9's user surface on the card (the plots are
    checked in phase 7's run A): the evolver, the Ensemble and
    bench_c2f_split, each timed. Logs which optional packages the machine
    has (matplotlib draws the figures; mlflow, ray and tensorstore back
    --mlflow-url, the Ray evolver and the orbax reader). Returns the
    kernels-line entries."""
    import importlib.util

    import torch

    found = {p: importlib.util.find_spec(p) is not None for p in OPTIONAL_PACKAGES}
    log(f"[user surface] optional packages: {found}")
    entries = []
    for name, fn, kw in (("evolve", evolve_run, evolve_kw), ("ensemble", ensemble_run,
                                                             ensemble_kw),
                         ("c2f split", c2f_split_run, c2f_kw)):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        torch.set_grad_enabled(name == "evolve")
        t0 = time.perf_counter()
        entries.extend(fn(card, dev, cfg=cfg, imgsz=imgsz, **(kw or {})))
        log(f"[user surface] {name} in {time.perf_counter() - t0:.1f} s")
    return entries


# phase 13: the data-parallel cell: a batch of 8 served over two replicas on
# the one card, the step's global per-task batch of 8 over an NCCL group of
# one and over two Gloo ranks (4 rows each), and the val set of phase 6 cut
# to 32 images a task, validated by two ranks at batch 8 (two rect batches
# each)
DP_BATCH, DP_STEPS, DP_VAL_IMAGES, DP_VAL_BATCH = 8, 3, 32, 8
# an NCCL group of one computes the group-less step's arithmetic (its
# all-reduces of one rank copy), so its steps equal the group-less steps bit for
# bit. Two Gloo ranks (float32) take their BatchNorm and weight-gradient sums
# over 4 rows and then over the ranks, where one process sums the 8 rows. Each
# of their steps, from the same state, is held against one process's step: the
# losses within DP_LOSS_RTOL (about 10x the largest gap measured on an H100,
# PERF.md), each state tensor within DP_STATE_FRAC of its change that step (or
# 2 float32 ulps), or within twice its gap in one process's step over the rows
# reversed: the same sums in another order, which measures the step's rounding
# (past the first step, a rounding of the assigner's discrete choices moves
# single tensors by up to 0.2 of their change on an H100, the reversed rows as
# far as the ranks). Run freely from step to step, the two drift apart (the
# seeded net amplifies the first step's rounding); that drift is printed
DP_STATE_FRAC, DP_LOSS_RTOL = 0.1, 1e-3
# bf16 serving over the mesh's replicas against one replica: the share of one
# replica's detections matched (batch-4 kernels may round otherwise than
# batch-8 ones), and the matched detections' largest score and box differences
DP_SERVE_MATCH, DP_SERVE_SCORE, DP_SERVE_BOX = 0.99, 1e-3, 1.0
# the ranks' merged val statistics are the one process's, concatenated in rank
# order: AP then equals the one process's over the same order exactly, and over
# its own order within this (average precision ranks detections by confidence,
# and a tie between two of them keeps whichever order it is given)
DP_VAL_TIE_TOL = 1e-2


def state_copy(state):
    """CPU copies of every tensor of a TrainState (parameters, BatchNorm
    statistics, optimizer buffers, EMA), by train/step.py:state_tensors'
    names."""
    from cerberusdet_tpu_torch.train.step import state_tensors

    return {n: t.detach().cpu().clone() for n, t in state_tensors(state)}


def close_states(ours, ref, init, frac: float, what: str = "", rounding=None) -> float:
    """close_updates for float32 states: with `what`, raise unless each
    tensor of `ours` is within frac of its largest change ref - init, or
    within 2 float32 ulps of its largest value (a tensor that barely moves
    differs by rounding alone), or, given `rounding` (the same step's state
    from the same sums in another order), within twice that state's
    difference from ref. Returns (the worst share of its change, the floor /
    frac counted as change, that a tensor differs by; that tensor's name)."""
    worst, name = 0.0, ""
    for k, r in ref.items():
        r = r.double()
        change = float((r - init[k].double()).abs().max())
        diff = float((ours[k].cpu().double() - r).abs().max())
        floor = 2 * 2.0 ** -23 * float(r.abs().max()) if r.numel() else 0.0
        allowed = frac * change + floor
        if rounding is not None:
            allowed = max(allowed, 2 * float((rounding[k].double() - r).abs().max()))
        if what and diff > allowed:
            raise AssertionError(f"{what}: {k} differs by {diff}, {diff / max(change, 1e-30):.3g}"
                                 f" of its change")
        share = diff / (change + floor / frac) if diff else 0.0
        if share > worst:
            worst, name = share, k
    return worst, name


def dp_val_set(root: str, cfg: str, imgsz: int, dev, n_images: int, batch: int):
    """Phase 6's val cell cut to n_images a task (its first images: the same
    seeds), labelled with the seeded model's own bf16 detections at conf >=
    LABEL_CONF; the seeded model (BatchNorm statistics from 8 of the images)
    as seeded.ckpt.npz. Returns (data yaml, checkpoint, {task: image dir})."""
    import numpy as np
    import torch
    import yaml

    from cerberusdet_tpu_torch.cli import val as cli
    from cerberusdet_tpu_torch.data.loaders import create_dataloader
    from cerberusdet_tpu_torch.evaluation.val import run_task
    from cerberusdet_tpu_torch.manager.checkpoint import save_checkpoint
    from cerberusdet_tpu_torch.manager.weights import export_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.testing import calibrate_bn, write_labels, write_val_set

    names = {t: [f"{t}_{i}" for i in range(n)] for t, n in zip(TASKS, NCS)}
    dirs = {t: write_val_set(os.path.join(root, t), n_images, VAL_SIZES, seed=20 + i)
            for i, t in enumerate(TASKS)}
    data_yaml = os.path.join(root, "data.yaml")
    with open(data_yaml, "w") as f:
        yaml.safe_dump({"task_ids": TASKS, "nc": NCS, "names": [names[t] for t in TASKS],
                        "train": [dirs[t] for t in TASKS], "val": [dirs[t] for t in TASKS]}, f)
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
    bf16 = cli.load_model_for_eval(ckpt, "", dev).to(torch.bfloat16)
    for ti, t in enumerate(TASKS):
        _, loader = create_dataloader(dirs[t], imgsz, batch, rect=True, pad=0.5,
                                      classnames=names[t], task=f"{t}_val")
        dets = run_task(bf16, t, loader, NCS[ti], return_dets=True)["dets"]
        if not write_labels({p: d[d[:, 4] >= LABEL_CONF] for p, d in dets.items()}):
            raise AssertionError(f"{t}: the seeded model detects nothing at conf >= "
                                 f"{LABEL_CONF}")
        lab = os.path.join(root, t, "labels", "val")
        for f in os.listdir(lab):  # the labels changed: drop the label cache
            if f.endswith(".cache.npy"):
                os.remove(os.path.join(lab, f))
    return data_yaml, ckpt, dirs


def det_diffs(a, b):
    """(largest |score difference|, largest box coordinate difference) over
    the detections of result lists `a` and `b` that match (same image, task
    and label, the best IoU)."""
    score, box = 0.0, 0
    for ra, rb in zip(a, b):
        for x in ra:
            best, pick = -1.0, None
            for y in rb:
                if (x["task"], x["label"]) != (y["task"], y["label"]):
                    continue
                ix = max(0, min(x["box"][2], y["box"][2]) - max(x["box"][0], y["box"][0]))
                iy = max(0, min(x["box"][3], y["box"][3]) - max(x["box"][1], y["box"][1]))
                area = [(d["box"][2] - d["box"][0]) * (d["box"][3] - d["box"][1])
                        for d in (x, y)]
                iou = ix * iy / max(area[0] + area[1] - ix * iy, 1e-9)
                if iou > best:
                    best, pick = iou, y
            if pick is not None and best >= 0.5:
                score = max(score, abs(x["score"] - pick["score"]))
                box = max(box, max(abs(u - v) for u, v in zip(x["box"], pick["box"])))
    return score, box


def dp_serving(card: str, dev, ckpt: str, imgsz: int, batch: int, requests: int):
    """(a) CerberusDetInference over a mesh of two replicas on the one card
    against one replica of the same weights, bf16 and int8 "all"; then
    cli.serve --mesh against cli.serve. Returns the kernels-line entries."""
    import threading
    import urllib.request

    import cv2
    import numpy as np
    import torch

    from cerberusdet_tpu_torch.cli import serve as serve_cli
    from cerberusdet_tpu_torch.infer import CerberusDetInference, CerberusPreprocessor
    from cerberusdet_tpu_torch.ops import conv_int8_cuda as ci
    from cerberusdet_tpu_torch.ops import nms_cuda
    from cerberusdet_tpu_torch.parallel import make_mesh

    nms = nms_cuda.greedy_nms_cuda
    rng = np.random.default_rng(13)
    frames = [list(rng.integers(0, 256, (batch, 480, 640, 3), dtype=np.uint8))
              for _ in range(requests)]
    pre = CerberusPreprocessor(img_size=imgsz, device=dev)
    served = [pre.preprocess(f) for f in frames]
    mesh = make_mesh([dev, dev])
    nc_by_task = dict(zip(TASKS, NCS))
    entries, saved = [], (nms.launches, ci.conv_s8.launches, ci.quant_pack_s8.launches)
    for label, int8 in (("bf16", "off"), ("int8", "all")):
        one = CerberusDetInference(weights=ckpt, conf_thres=CONF, img_size=imgsz,
                                   dtype=torch.bfloat16, device=dev, int8=int8)
        # the mesh replicates the same weights: a copy of the one-replica model,
        # fused (and quantized) once
        two = CerberusDetInference(model=copy.deepcopy(one.model), names=one.names,
                                   conf_thres=CONF, img_size=imgsz, dtype=torch.bfloat16,
                                   mesh=mesh)
        n_q = [len(c) for c in two._int8_convs]
        ref = [one.predict(b, original_shape=s) for b, s in served]
        two.predict(*served[0])  # the first request of the key captures each replica's
        nms.launches = ci.conv_s8.launches = ci.quant_pack_s8.launches = 0
        out = [two.predict(b, original_shape=s) for b, s in served]
        launches = (nms.launches, ci.conv_s8.launches, ci.quant_pack_s8.launches)
        want = (len(TASKS) * len(mesh) * requests, sum(n_q) * requests, sum(n_q) * requests)
        if launches != want or (dev.type == "cuda" and len(two.programs) != len(mesh)):
            raise AssertionError(f"mesh {label}: launches (nms, conv_s8, quant_pack_s8) "
                                 f"{launches}, expected {want}; {len(two.programs)} programs")
        n_ref = sum(len(r) for o in ref for r in o)
        if not all(any(d["task"] == t for o in ref for r in o for d in r) for t in TASKS):
            raise AssertionError(f"mesh {label}: one replica detects nothing in a task")
        if int8 != "off":
            if out != ref:
                raise AssertionError("int8 over the mesh differs from one replica")
            verdict = "identical with one replica"
        else:
            matched = sum(matched_detections(a, b) for a, b in zip(out, ref))
            score, box = det_diffs(sum(out, []), sum(ref, []))
            if matched < DP_SERVE_MATCH * n_ref or score > DP_SERVE_SCORE or box > DP_SERVE_BOX:
                raise AssertionError(f"bf16 over the mesh: {matched} of {n_ref} detections "
                                     f"match one replica's (limit {DP_SERVE_MATCH}), scores up "
                                     f"to {score} apart (limit {DP_SERVE_SCORE}), boxes {box} px "
                                     f"(limit {DP_SERVE_BOX})")
            verdict = (f"{matched} of {n_ref} detections match one replica's (IoU >= 0.5, "
                       f"same task and label; limit {DP_SERVE_MATCH}); largest score "
                       f"difference {score:.3g}, box {box} px (limits {DP_SERVE_SCORE}, "
                       f"{DP_SERVE_BOX})")
        t_one, t_two = [], []
        for _ in range(5):
            for inf, times in ((one, t_one), (two, t_two)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                inf.predict(served[0][0])
                times.append(1e3 * (time.perf_counter() - t))
        log(f"[mesh serving {label}] a batch of {batch} over 2 replicas on one card "
            f"({sum(n_q)} int8 convs, {n_q[0]} a replica): {requests} requests {verdict}; "
            f"launches NMS {launches[0]}, conv_s8 {launches[1]}, quant_pack_s8 {launches[2]} "
            f"(one a task, a quantized Conv, and a replica); a replayed request "
            f"{float(np.median(t_two)):.2f} ms over the 2 replicas against "
            f"{float(np.median(t_one)):.2f} ms on one (host clock, median of 5)  [{card}]")
        half = served[0][0][:batch // 2]
        if int8 == "off":
            entries.append(nms_entry(two, half, nc_by_task, CONF,
                                     f"mesh serving: a replica's {batch // 2} rows of a bf16 "
                                     f"batch of {batch}", launches[0], card))
        else:
            checked, calls = {}, {}
            x = torch.as_tensor(half).to(dev).permute(0, 3, 1, 2).to(torch.bfloat16)
            val_batch_convs(two.replicas[1], x, None, checked, calls)
            (k_conv, k_pack, p_conv, p_pack, b_conv, b_pack, n_calls, conv_err,
             pack_err) = conv_totals(checked, calls)
            log(f"[mesh serving int8] replica 1's forward of {batch // 2} rows: conv_s8 and "
                f"quant_pack_s8 identical with their plain versions at its {len(checked)} "
                f"shapes; {n_calls} launches each: conv_s8 {k_conv:.3f} ms (plain "
                f"{p_conv:.3f}, bound {b_conv:.4f}), quant_pack_s8 {k_pack:.3f} ms (plain "
                f"{p_pack:.3f}, bound {b_pack:.4f})  [{card}]")
            common = {"route": "cuda", "source": "cerberusdet_tpu_torch/csrc/conv_int8.cu"}
            entries += [{
                "name": f"conv_s8 (mesh serving: a replica's forward of {batch // 2} rows, all "
                        f"{n_calls} launches summed)", **common,
                "replaces": "cerberusdet_tpu/ops/conv_int8_pallas.py:65",
                "launches": launches[1], "max_abs_err": conv_err, "ms": k_conv,
                "plain_ms": p_conv, "bound_ms": b_conv, "bound_by": "operations",
                "library_ms": None}, {
                "name": f"quant_pack_s8 (mesh serving: a replica's forward of {batch // 2} "
                        f"rows, all {n_calls} launches summed)", **common,
                "replaces": "cerberusdet_tpu/nn/module.py:162 (quantize_act, no Pallas "
                            "kernel; part of conv_s8's redesign)",
                "launches": launches[2], "max_abs_err": pack_err, "ms": k_pack,
                "plain_ms": p_pack, "bound_ms": b_pack, "bound_by": "bytes",
                "library_ms": None}]
        del one, two
        gc.collect()
        torch.cuda.empty_cache()

    # cli.serve --mesh (the visible cards: one here) against cli.serve
    bodies = [cv2.imencode(".jpg", np.ascontiguousarray(f[::-1]))[1].tobytes()
              for f in frames[0]]
    answers = {}
    for label, extra in (("--mesh", ["--mesh"]), ("", [])):
        opt = serve_cli.parse_opt(["--weights", ckpt, "--imgsz", str(imgsz), "--bf16",
                                   "--conf-thres", str(CONF), "--max-batch", str(batch),
                                   "--host", "127.0.0.1", "--port", "0", "--device", str(dev)]
                                  + extra)
        inference, engine, server = serve_cli.build(opt)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"
        try:
            got = []
            for data in bodies:
                req = urllib.request.Request(url, data=data, method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    got.append((r.status, json.loads(r.read())))
            answers[label] = (got, len(inference.replicas), len(inference.programs))
        finally:
            server.shutdown()
            server.server_close()
            engine.stop()
            thread.join(timeout=30)
        del inference
    (mesh_got, n_rep, n_prog), (plain_got, _, _) = answers["--mesh"], answers[""]
    n_det = sum(len(b["detections"]) for _, b in plain_got)
    if mesh_got != plain_got or any(s != 200 for s, _ in mesh_got) or not n_det:
        raise AssertionError("cli.serve --mesh answered otherwise than cli.serve")
    log(f"[mesh serving] cli.serve --mesh over the {n_rep} visible card(s), one program a "
        f"replica ({n_prog}): {len(bodies)} requests answered as cli.serve answers them "
        f"({n_det} detections)")
    nms.launches, ci.conv_s8.launches, ci.quant_pack_s8.launches = saved
    return entries


def dp_nccl_step(card: str, dev, cfg: str, imgsz: int, batch: int, n_labels: int,
                 steps: int):
    """(b) The captured train step in an NCCL group of one (phase 4's cell):
    the graph's NCCL nodes, `steps` replays == raw_steps bit for bit, the
    first step and the state after all steps == the group-less step's bit
    for bit, the replay's time against the group-less replay's. Returns the
    TAL kernels' kernels-line entries."""
    import torch
    import torch.distributed as dist

    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.ops import tal_cuda
    from cerberusdet_tpu_torch.parallel import init_distributed
    from cerberusdet_tpu_torch.testing import train_batches
    from cerberusdet_tpu_torch.train import loss as loss_mod
    from cerberusdet_tpu_torch.train.loss import DetectionLoss
    from cerberusdet_tpu_torch.train.schedules import warmup_lrs
    from cerberusdet_tpu_torch.train.step import MultiTaskTrainer, init_train_state
    from cerberusdet_tpu_torch.utils.profiling import graph_kernel_names

    group = init_distributed(device=dev)
    if dist.get_backend(group) != "nccl" or dist.get_world_size(group) != 1:
        raise AssertionError(f"expected an NCCL group of one, got {dist.get_backend(group)} "
                             f"of {dist.get_world_size(group)}")
    tal = {"tal_select": tal_cuda.select_kernel, "tal_assign": tal_cuda.assign_kernel,
           "tal_norm": tal_cuda.norm_kernel}
    saved = {k: f.launches for k, f in tal.items()}
    first = {}
    real_assign = loss_mod.task_aligned_assign
    real_all_reduce = dist.all_reduce
    captured = [0]

    def assign(*a, **kw):  # the first inputs the grouped step gives the TAL kernels
        if "args" not in first:
            first["args"] = ([v.detach().clone() for v in a[:6]], kw["num_classes"])
        return real_assign(*a, **kw)

    def all_reduce(*a, **kw):  # the collectives recorded into a graph
        captured[0] += torch.cuda.is_current_stream_capturing()
        return real_all_reduce(*a, **kw)

    try:
        batches = {t: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                   for t, b in train_batches(TASKS, NCS, batch, imgsz, n_labels, TRAIN_REAL,
                                             seed=0).items()}
        runs = {}
        torch.backends.cudnn.deterministic = True
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(True, warn_only=True)
            for label, grp in (("nccl", group), ("none", None)):
                model = CerberusModel(cfg, TASKS, NCS, device=dev).init(seed=0)
                losses = {t: DetectionLoss(nc=nc, strides=model.strides)
                          for t, nc in zip(TASKS, NCS)}
                trainer = MultiTaskTrainer(model, losses, compute_dtype=torch.bfloat16,
                                           device=dev, group=grp)
                state = init_train_state(model)
                for f in tal.values():
                    f.launches = 0
                loss_mod.task_aligned_assign = assign
                dist.all_reduce, captured[0] = all_reduce, 0
                try:
                    _, it = trainer.step(state, batches, *warmup_lrs(0, 100, 0.0, 0.01, 1.0))
                finally:
                    loss_mod.task_aligned_assign = real_assign
                    dist.all_reduce = real_all_reduce
                snap = snapshot(state)
                first_step = ({t: [float(v) for v in x] for t, x in it.items()},
                              state_copy(state))
                items = []
                for i in range(1, steps + 1):
                    _, it = trainer.step(state, batches, *warmup_lrs(i, 100, 0.0, 0.01, 1.0))
                    items.append({t: [float(v) for v in x] for t, x in it.items()})
                torch.cuda.synchronize()
                counts = {k: f.launches for k, f in tal.items()}
                replayed = state_copy(state)
                prog = trainer.programs[trainer.step_key(batches)]
                replay_ms = [cuda_ms(prog.graph.replay, iters=3, warmup=1) for _ in range(3)]
                nodes = graph_kernel_names(prog.graph)
                if label == "nccl":
                    restore(state, snap)
                    for i in range(1, steps + 1):
                        trainer.raw_step(state, batches, *warmup_lrs(i, 100, 0.0, 0.01, 1.0))
                    if any(not torch.equal(replayed[k], v)
                           for k, v in state_copy(state).items()):
                        raise AssertionError(f"NCCL group of one: {steps} replays differ from "
                                             f"{steps} raw_steps")
                    from torch.profiler import ProfilerActivity, profile

                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        prog.graph.replay()
                        torch.cuda.synchronize()
                    traced = sum(e.count for e in prof.key_averages() if "nccl" in e.key.lower())
                    n_bn = sum(len(model._batch_norms(s.uid)) for t in TASKS
                               for s in model.plan([t]))
                    runs[label] = (items, replayed, counts, replay_ms, nodes, first_step,
                                   traced, n_bn, captured[0])
                else:
                    runs[label] = (items, replayed, counts, replay_ms, nodes, first_step)
                del trainer, state, model, snap, prog
                gc.collect()
                torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        items_g, state_g, counts, ms_g, nodes_g, first_g, traced, n_bn, n_coll = runs["nccl"]
        items_p, state_p, _, ms_p, nodes_p, first_p = runs["none"]
        nccl_nodes = [n for n in nodes_g if "nccl" in n.lower()]
        # 4 a BatchNorm a task forward runs (its sums and its centred squares,
        # forward and backward), 2 a task's loss (its normalisers, its items), 1
        # the gradients
        want_collectives = 4 * n_bn + 2 * len(TASKS) + 1
        if n_coll != want_collectives:
            raise AssertionError(f"the capture recorded {n_coll} NCCL all-reduces, not "
                                 f"{want_collectives}")
        if any(v != len(TASKS) * (steps + 1) for v in counts.values()):
            raise AssertionError(f"TAL launches {counts}: not once per task and step")
        # a group of one: the group-less step's arithmetic, bit for bit
        if first_g[0] != first_p[0] or items_g != items_p:
            raise AssertionError(f"NCCL group of one: losses {first_g[0]}, {items_g} against "
                                 f"the group-less step's {first_p[0]}, {items_p}")
        for what, a, b in (("the first step", first_g[1], first_p[1]),
                           (f"after {steps + 1} steps", state_g, state_p)):
            differ = [k for k in b if not torch.equal(a[k], b[k])]
            if differ:
                raise AssertionError(f"NCCL group of one, {what}: {len(differ)} of {len(b)} "
                                     f"tensors differ from the group-less step's: {differ[:3]}")
        log(f"[nccl step] an NCCL group of one ({dist.Backend.NCCL} "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))}), {os.path.basename(cfg)} bf16, "
            f"per-task batch {batch}: the capture recorded {n_coll} NCCL all-reduces (4 a "
            f"BatchNorm of the {n_bn} that the task forwards run, 2 a task's loss, 1 the "
            f"gradients); NCCL kernel nodes in the graph {len(nccl_nodes)} of {len(nodes_g)} "
            f"kernel nodes, {traced} in the profiler's trace of a replay (a group of one "
            f"reduces in place: no kernel); {steps} replays == "
            f"{steps} raw_steps bit for bit; TAL launches {counts}; the first step and the "
            f"{len(state_g)} state tensors after {steps + 1} steps identical with the "
            f"group-less step's, losses too ({items_g[-1]}); a replay "
            f"{min(ms_g):.2f} ms against {min(ms_p):.2f} ms "
            f"group-less ({len(nodes_g)} vs {len(nodes_p)} kernel nodes; CUDA events, best "
            f"of 3 x 3 replays)  [{card}]")
        args, nc = first["args"]
        return tal_entries(args, nc, {k: v for k, v in counts.items()},
                           "NCCL group of one, captured", card)
    finally:
        loss_mod.task_aligned_assign = real_assign
        for k, f in tal.items():
            f.launches = saved[k]
        dist.destroy_process_group()


def dp_rank(rank: int, world: int, init: str, job_path: str, out_path: str) -> None:
    """One of the Gloo ranks of (c) and (d), in a process of its own on
    cuda:0: `steps` eager float32 steps of its rows of the global batch, the
    captured step's refusal, then cli.val's main on its shard. Pickles what
    the parent checks."""
    import hashlib
    import pickle

    import torch

    from cerberusdet_tpu_torch.cli import val as cli_val
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.ops import nms_cuda, tal_cuda
    from cerberusdet_tpu_torch.parallel import init_distributed, replicate, shard_task_batches
    from cerberusdet_tpu_torch.testing import train_batches
    from cerberusdet_tpu_torch.train.loss import DetectionLoss
    from cerberusdet_tpu_torch.train.schedules import warmup_lrs
    from cerberusdet_tpu_torch.train.step import (
        MultiTaskTrainer,
        init_train_state,
        state_tensors,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dev = torch.device(job["device"])  # cuda:0 (the CPU where the phase is rehearsed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    group = init_distributed(backend="gloo", device=dev, init_method=f"file://{init}",
                             rank=rank, world_size=world)
    tal = (tal_cuda.select_kernel, tal_cuda.assign_kernel, tal_cuda.norm_kernel)
    model = CerberusModel(job["cfg"], TASKS, NCS, device=dev).init(seed=0)
    losses = {t: DetectionLoss(nc=nc, strides=model.strides) for t, nc in zip(TASKS, NCS)}
    trainer = MultiTaskTrainer(model, losses, device=dev, group=group)
    state = replicate(init_train_state(model), group)
    batches = shard_task_batches(train_batches(TASKS, NCS, job["batch"], job["imgsz"],
                                               job["n_labels"], TRAIN_REAL, seed=0),
                                 world, index=rank)
    for f in tal:
        f.launches = 0
    items, times = [], []
    for i in range(job["steps"]):
        sync()
        t = time.perf_counter()
        _, it = trainer.raw_step(state, batches, *warmup_lrs(i, 100, 0.0, 0.01, 1.0))
        sync()
        times.append(time.perf_counter() - t)
        items.append({t: [float(v) for v in x] for t, x in it.items()})
        if rank == 0:  # every step's state, for the parent's one-process steps
            torch.save((state_copy(state), state.n_updates), f"{job['state_path']}.{i + 1}")
    out = {"items": items, "step_s": times, "tal": [f.launches for f in tal],
           "hashes": [(n, hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest())
                      for n, t in state_tensors(state)]}
    try:
        trainer.step(state, batches, *warmup_lrs(job["steps"], 100, 0.0, 0.01, 1.0))
    except RuntimeError as err:  # the refusal this phase checks for
        out["refusal"] = str(err)
    del trainer, state, model
    nms = nms_cuda.greedy_nms_cuda
    nms.launches = 0
    t = time.perf_counter()
    res = cli_val.main(job["val_argv"])
    out["val"] = {k: (list(v["results"][:4]), v["seen"], len(v["times"])) for k, v in
                  res.items()}
    out["val_s"], out["val_nms"] = time.perf_counter() - t, nms.launches
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def dp_nccl_two_ranks(rank: int, init: str, out_path: str) -> None:
    """Two NCCL ranks on cuda:0: NCCL refuses them; pickles what it said."""
    import pickle

    from cerberusdet_tpu_torch.parallel import init_distributed

    try:
        init_distributed(backend="nccl", device="cuda:0", init_method=f"file://{init}",
                         rank=rank, world_size=2)
        said = None
    except Exception as err:  # noqa: BLE001 (NCCL's error, recorded for the parent)
        said = f"{type(err).__name__}: {err}"
    with open(out_path, "wb") as f:
        pickle.dump(said, f)


def start_ranks(fn: str, args_of, world: int):
    """Start chip_smoke.fn(*args_of(rank)) in `world` processes from the
    repository root; wait_ranks collects them."""
    import subprocess

    procs = []
    for rank in range(world):
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                f"chip_smoke.{fn}(*{args_of(rank)!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return fn, procs


def wait_ranks(started, timeout: float):
    """Wait for start_ranks's processes, kill what outlives `timeout` and
    raise if any failed. Returns each process's output."""
    fn, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise AssertionError(f"{fn} rank {rank} failed ({p.returncode}):\n{out[-4000:]}")
    return logs


def dp_ranks(card: str, dev, cfg: str, imgsz: int, batch: int, n_labels: int,
             root: str, data_yaml: str, ckpt: str, val_batch: int, steps: int = 2):
    """(c) and (d): NCCL refuses two ranks on one card; two Gloo ranks on
    cuda:0 step float32 eagerly and equal each other bit for bit, and each of
    their steps equals one process's step over the 8 rows from the same
    state within DP_STATE_FRAC; the captured step refuses Gloo; each rank
    validates its shard through cli.val and reports the one-process val's
    metrics. Returns the TAL kernels' kernels-line entries."""
    import pickle

    import numpy as np
    import torch

    from cerberusdet_tpu_torch.cli import val as cli_val
    from cerberusdet_tpu_torch.evaluation.metrics import DetMetrics
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.ops import nms_cuda
    from cerberusdet_tpu_torch.testing import train_batches
    from cerberusdet_tpu_torch.train import loss as loss_mod
    from cerberusdet_tpu_torch.train.loss import DetectionLoss
    from cerberusdet_tpu_torch.train.schedules import warmup_lrs
    from cerberusdet_tpu_torch.train.step import (
        MultiTaskTrainer,
        init_train_state,
        state_tensors,
    )

    val_argv = ["--weights", ckpt, "--data", data_yaml, "--device", str(dev), "--imgsz",
                str(imgsz), "--batch-size", str(val_batch), "--project",
                os.path.join(root, "runs"), "--exist-ok", "--workers", "4"]
    on_card = dev.type == "cuda"
    if on_card:  # NCCL's answer to two ranks on one card, while this process works
        said = [os.path.join(root, f"nccl{rank}.pkl") for rank in range(2)]
        refusal = start_ranks("dp_nccl_two_ranks",
                              lambda r: (r, os.path.join(root, "nccl.init"), said[r]), 2)
    try:
        # the one-process val first: its loaders write the label caches the ranks read
        nms = nms_cuda.greedy_nms_cuda
        saved_nms = nms.launches
        t = time.perf_counter()
        one_val = cli_val.main(val_argv)
        one_val_s = time.perf_counter() - t
        # the same statistics in the ranks' order (rank 0's batches, then rank 1's):
        # AP sorts by confidence, and tied confidences keep their order
        in_rank_order = {}
        for k, v in one_val.items():
            stats = v["metrics"].stats  # one entry an image, in the loader's order
            m = DetMetrics(v["metrics"].nc, v["metrics"].names)
            m.stats = [x for r in range(2) for i, x in enumerate(stats)
                       if (i // val_batch) % 2 == r]
            m.process()
            in_rank_order[k] = list(m.mean_results())
        one_val = {k: (list(v["results"][:4]), v["seen"], len(v["times"])) for k, v in
                   one_val.items()}
        nms.launches = saved_nms

        # one process over the 8 rows: the reference of the ranks' steps
        first = {}
        real_assign = loss_mod.task_aligned_assign

        def assign(*a, **kw):
            if "args" not in first:
                first["args"] = ([v.detach().clone() for v in a[:6]], kw["num_classes"])
            return real_assign(*a, **kw)

        model = CerberusModel(cfg, TASKS, NCS, device=dev).init(seed=0)
        trainer = MultiTaskTrainer(model, {t: DetectionLoss(nc=nc, strides=model.strides)
                                           for t, nc in zip(TASKS, NCS)}, device=dev)
        state = init_train_state(model)
        init_sd = state_copy(state)
        batches = train_batches(TASKS, NCS, batch, imgsz, n_labels, TRAIN_REAL, seed=0)
        ref_items, ref_states = [], []  # one process run freely over the steps
        loss_mod.task_aligned_assign = assign
        try:
            for i in range(steps):
                _, it = trainer.raw_step(state, batches, *warmup_lrs(i, 100, 0.0, 0.01, 1.0))
                ref_items.append({t: [float(v) for v in x] for t, x in it.items()})
                ref_states.append(state_copy(state))
        finally:
            loss_mod.task_aligned_assign = real_assign
        del trainer, state, model
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    except BaseException:
        for p in (refusal[1] if on_card else ()):  # stop what was started
            p.kill()
        raise
    if on_card:
        wait_ranks(refusal, timeout=180)
        refusals = []
        for path in said:
            with open(path, "rb") as f:
                refusals.append(pickle.load(f))
        if any(r is None for r in refusals):
            raise AssertionError("NCCL took two ranks on one card")
        log(f"[two ranks] NCCL refuses two ranks on one card: {refusals[0][:300]}")

    # two Gloo ranks on cuda:0
    job = dict(cfg=cfg, imgsz=imgsz, batch=batch, n_labels=n_labels, steps=steps,
               val_argv=val_argv, state_path=os.path.join(root, "rank0_state.pt"),
               device="cuda:0" if on_card else "cpu")
    job_path = os.path.join(root, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    outs = [os.path.join(root, f"rank{r}.pkl") for r in range(2)]
    t = time.perf_counter()
    wait_ranks(start_ranks("dp_rank", lambda r: (r, 2, os.path.join(root, "gloo.init"),
                                                 job_path, outs[r]), 2), timeout=600)
    ranks_s = time.perf_counter() - t
    ranks = []
    for path in outs:
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
    r0, r1 = ranks
    if r0["hashes"] != r1["hashes"] or r0["items"] != r1["items"]:
        raise AssertionError("the two Gloo ranks' states differ")
    # each rank step against one process's step from the state the ranks held
    # before it (the initial state, then rank 0's), and, as the rounding's
    # measure, one process's step over the same rows in reverse order (the
    # same sums in another order)
    model = CerberusModel(cfg, TASKS, NCS, device=dev).init(seed=0)
    trainer = MultiTaskTrainer(model, {t: DetectionLoss(nc=nc, strides=model.strides)
                                       for t, nc in zip(TASKS, NCS)}, device=dev)
    state = init_train_state(model)
    reversed_rows = {t: {k: v[::-1].copy() for k, v in b.items()} for t, b in batches.items()}
    def loss_gap(a, b):  # the largest relative difference of two steps' loss items
        return max(abs(x / y - 1) for t in TASKS for x, y in zip(a[t], b[t]) if y)

    before, before_n, worst, noise, gaps = init_sd, 0, [], [], []
    for i in range(steps):
        after, after_n = torch.load(f"{job['state_path']}.{i + 1}")
        runs = []
        for rows in (batches, reversed_rows):
            with torch.no_grad():
                for n, t in state_tensors(state):
                    t.copy_(before[n])
            state.n_updates = before_n
            _, it = trainer.raw_step(state, rows, *warmup_lrs(i, 100, 0.0, 0.01, 1.0))
            runs.append((state_copy(state), {t: [float(v) for v in x] for t, x in it.items()}))
        (ref, ref_it), (rev, rev_it) = runs
        gaps.append((loss_gap(r0["items"][i], ref_it), loss_gap(rev_it, ref_it)))
        noise.append(close_states(rev, ref, before, DP_STATE_FRAC))
        worst.append(close_states(after, ref, before, DP_STATE_FRAC,
                                  f"two Gloo ranks' step {i + 1} against one process's",
                                  rounding=rev))
        before, before_n = after, after_n
    # what a batch of 4 rounds otherwise than a batch of 8 (the kernels a shape
    # picks): the eval forward of the 8 rows at once against 4 + 4, and against
    # the 8 rows reversed
    with torch.no_grad():
        model.eval()
        img = torch.as_tensor(batches[TASKS[0]]["img"]).to(dev).permute(0, 3, 1, 2)
        x = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()

        def preds(v):
            return model(v, tasks=[TASKS[0]])[TASKS[0]][0].float()

        whole = preds(x)
        top = float(whole.abs().max())
        halves = torch.cat([preds(x[:batch // 2]), preds(x[batch // 2:])])
        split_gap = float((halves - whole).abs().max()) / top
        order_gap = float((preds(x.flip(0)).flip(0) - whole).abs().max()) / top
    del trainer, state, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    drift = close_states(before, ref_states[-1], init_sd, DP_STATE_FRAC)
    want_tal = [len(TASKS) * steps] * 3
    for r in ranks:
        if on_card and r["tal"] != want_tal:
            raise AssertionError(f"a rank launched the TAL kernels {r['tal']} times, not once "
                                 "per task and step")
        if on_card and "CUDA graph cannot capture" not in r.get("refusal", ""):
            raise AssertionError(f"the captured step did not refuse a Gloo group: "
                                 f"{r.get('refusal')}")
    log(f"[two ranks] 2 Gloo ranks on one card, {os.path.basename(cfg)} float32 (TF32 off), "
        f"global per-task batch {batch} ({batch // 2} a rank), {steps} eager steps: the ranks' "
        f"states identical (sha1 of {len(r0['hashes'])} tensors) and their losses too; against "
        f"one process's step over the {batch} rows from the same state (and, the rounding's "
        f"measure, one process's step over the rows reversed), step by step: "
        + "; ".join(f"step {i + 1}: losses within {g:.3g} [{gr:.3g}], state tensors within "
                    f"{w:.3g} of that step's change ({n}) [{wr:.3g} ({nr})]"
                    for i, ((g, gr), (w, n), (wr, nr)) in enumerate(zip(gaps, worst, noise)))
        + f" (limits rtol {DP_LOSS_RTOL}, {DP_STATE_FRAC}); an eval forward of the {batch} rows "
        f"against {batch // 2} + {batch // 2}: outputs up to {split_gap:.3g} of their largest "
        f"value apart, against the rows reversed {order_gap:.3g}; run freely over {steps} steps, one "
        f"process's state up to {drift[0]:.3g} of the change apart ({drift[1]}), losses "
        f"within {loss_gap(r0['items'][-1], ref_items[-1]):.3g}; a step "
        f"{1e3 * float(np.median(r0['step_s'])):.0f} "
        f"ms on a rank (host clock, synchronised; the Gloo collectives go through the host); "
        f"TAL launches a rank {r0['tal']}; the captured step refused: "
        f"\"{r0.get('refusal', '')[:120]}...\"; both processes {ranks_s:.1f} s  [{card}]")

    for i, (g, _) in enumerate(gaps):
        if g > DP_LOSS_RTOL:
            raise AssertionError(f"two Gloo ranks' step {i + 1}: losses {r0['items'][i]} "
                                 f"differ from one process's by {g:.3g} (limit {DP_LOSS_RTOL})")

    # (d) the ranks' distributed val against the one process's
    tie_diff = 0.0
    for t in TASKS:
        one, (res0, seen0, nb0), (res1, seen1, nb1) = one_val[t], r0["val"][t], r1["val"][t]
        if seen0 != one[1] or seen1 != one[1] or nb0 + nb1 != one[2]:
            raise AssertionError(f"{t}: the ranks saw {seen0} / {seen1} images in {nb0} + {nb1} "
                                 f"batches, one process {one[1]} in {one[2]}")
        tie_diff = max(tie_diff, max(abs(a - b) for a, b in zip(res0, one[0])))
        if res0 != res1 or res0 != in_rank_order[t] or tie_diff > DP_VAL_TIE_TOL:
            raise AssertionError(f"{t}: distributed val {res0} / {res1}, one process "
                                 f"{in_rank_order[t]} in the ranks' order, {one[0]} in its own")
    n_nms = [r["val_nms"] for r in ranks]
    if on_card and n_nms != [sum(r["val"][t][2] for t in TASKS) for r in ranks]:
        raise AssertionError(f"the ranks' val launched NMS {n_nms} times, not once per batch "
                             "and task")
    log(f"[two ranks] distributed cli.val over the 2 ranks ({one_val[TASKS[0]][1]} images a "
        f"task, batch {val_batch}, rect, batches {r0['val'][TASKS[0]][2]} / "
        f"{r1['val'][TASKS[0]][2]} a rank): every rank reports the one-process metrics "
        f"(P, R, mAP50, mAP) {r0['val']} exactly, taken over the one process's statistics in "
        f"the ranks' order; in the one process's own order {one_val}, at most {tie_diff:.3g} "
        f"away (tied confidences, limit {DP_VAL_TIE_TOL}); NMS launches a rank {n_nms} (one a "
        f"batch and task of its shard); a rank's val {r0['val_s']:.1f} s, one process "
        f"{one_val_s:.1f} s  [{card}]")
    args, nc = first["args"]
    rank_args = [a[: a.shape[0] // 2] if a.dim() and a.shape[0] == batch else a for a in args]
    return tal_entries(rank_args, nc, {k: r0["tal"][i] for i, k in enumerate(TAL_KERNELS)},
                       "a Gloo rank's 4 rows, eager float32", card)


def data_parallel(card: str, dev, cfg: str = FLAGSHIP, imgsz: int = 640, batch: int = DP_BATCH,
                  n_labels: int = TRAIN_LABELS, steps: int = DP_STEPS,
                  val_images: int = DP_VAL_IMAGES, val_batch: int = DP_VAL_BATCH,
                  requests: int = 3):
    """Phase 13: data parallelism (parallel/mesh.py and its callers) on the
    one card. Returns the kernels-line entries of the mesh paths."""
    import tempfile

    import torch

    root = tempfile.mkdtemp(prefix="cerberus_dp_")
    entries = []
    try:
        t0 = time.perf_counter()
        torch.set_grad_enabled(False)
        data_yaml, ckpt, _ = dp_val_set(root, cfg, imgsz, dev, val_images, val_batch)
        log(f"[data parallel] phase 6's val cell cut to {val_images} JPEGs a task, labelled, "
            f"and its seeded checkpoint in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entries += dp_serving(card, dev, ckpt, imgsz, batch, requests)
        log(f"[data parallel] (a) mesh serving in {time.perf_counter() - t0:.1f} s")
        torch.set_grad_enabled(True)
        t0 = time.perf_counter()
        entries += dp_nccl_step(card, dev, cfg, imgsz, batch, n_labels, steps)
        log(f"[data parallel] (b) the NCCL group's captured step in "
            f"{time.perf_counter() - t0:.1f} s")
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        entries += dp_ranks(card, dev, cfg, imgsz, batch, n_labels, root, data_yaml, ckpt,
                            val_batch)
        log(f"[data parallel] (c, d) two ranks in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return entries


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
    from cerberusdet_tpu_torch.train.step import (
        MultiTaskTrainer,
        init_train_state,
        state_tensors,
    )
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
    kernels.extend(train_step(card, dev, tal_err))
    log(f"[train] phase in {time.perf_counter() - t0:.1f} s")

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

    # ---- 10. the training data path's routes at full width
    gc.collect()
    torch.cuda.empty_cache()
    torch.set_grad_enabled(True)
    t0 = time.perf_counter()
    kernels.extend(data_path(card, dev))
    log(f"[data] phase in {time.perf_counter() - t0:.1f} s")

    # ---- 11. int8 carried between the blocks
    gc.collect()
    torch.cuda.empty_cache()
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    kernels.extend(propagation(card, dev))
    log(f"[propagation] phase in {time.perf_counter() - t0:.1f} s")

    # ---- 12. the user surface: the evolvers, the Ensemble, bench_c2f_split
    t0 = time.perf_counter()
    kernels.extend(user_surface(card, dev))
    log(f"[user surface] phase in {time.perf_counter() - t0:.1f} s")

    # ---- 13. data parallelism: mesh serving, an NCCL group's step, two ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.extend(data_parallel(card, dev))
    log(f"[data parallel] phase in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
