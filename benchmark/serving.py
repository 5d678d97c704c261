"""What the serving cells share: the seeded weights and frames, the port's
serving objects built from them, and the check of every answer against the
reference. The weights and the reference come from the cell's model family
(families/).

The program is the port: its model (CerberusModel) takes the benchmark's
weights by load_state_dict, and CerberusDetInference fuses, casts and (int8)
calibrates and quantizes it on the benchmark's calibration frames, as a
deployment does; CerberusPreprocessor letterboxes the frames on the device.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.compare import as_arrays, share, tasks_of, unmatched
from benchmark.reference.detect import detections, letterbox
from benchmark.weights import frames

REF_BLOCK = 8  # frames a reference forward
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the share of answers kept for the check, drawn from the seed: the client
# holds no more than that, so that what it keeps does not grow the heap the
# collector scans in the window
CHECKED = 0.25


@contextlib.contextmanager
def no_tf32():
    """float32 as float32 on the card: TF32 off for matmuls and convolutions."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def program_peak(device: torch.device) -> None:
    """From here the device's peak memory is the program's: the benchmark's own
    set-up (weights and frames made, statistics taken) is left out of it."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def names_of(config: dict) -> Dict[str, List[str]]:
    return dict(zip(config["tasks"], config["names"]))


class ServingSession:
    """Set-up of a serving cell: weights, frames, the program, its warm-up
    (the driver's `warm`). `answers` collects (frame index, served list) for
    a share CHECKED of the window's requests, drawn from the seed."""

    def __init__(self, cell, seed: int, device: torch.device, tracer, program: bool = True):
        self.cell, self.seed, self.device, self.tracer = cell, seed, device, tracer
        tr, cfg = cell.traffic, cell.config
        self.tasks, self.ncs = list(cfg["tasks"]), list(cfg["nc"])
        self.size = int(tr["img_size"])
        gen = torch.Generator(device=device).manual_seed(int(seed))
        fh, fw = tr["frame"]
        self.calib = letterbox(frames(gen, int(tr["calib_frames"]), fh, fw, device), self.size)
        self.pool_dev = frames(gen, int(tr["pool"]), fh, fw, device)
        served = lambda: (letterbox(self.pool_dev[i:i + REF_BLOCK], self.size)
                          for i in range(0, len(self.pool_dev), REF_BLOCK))
        with no_tf32():
            self.weights = cell.family.make_weights(cfg["model"], self.tasks, self.ncs, gen,
                                                    self.calib, served)
        self.pool_dev = self.pool_dev.cpu()
        self.pool = list(self.pool_dev.numpy())  # the clients' frames
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        self.answers: List[Tuple[int, list]] = []
        self.rng = np.random.default_rng(int(seed))
        if program:
            program_peak(device)
            self.build()
            self.warm()

    def build(self) -> None:
        from cerberusdet_tpu_torch.infer.inference import CerberusDetInference
        from cerberusdet_tpu_torch.infer.preprocessor import CerberusPreprocessor
        from cerberusdet_tpu_torch.models.cerberus import CerberusModel

        tr = self.cell.traffic
        model = CerberusModel(self.cell.config["model"], self.tasks, self.ncs, device=self.device)
        model.load_state_dict(self.weights)
        self.inference = CerberusDetInference(
            model=model, names=names_of(self.cell.config), conf_thres=tr["conf"],
            iou_thres=tr["iou"], iou_thres_between_tasks=tr["iou_between"],
            img_size=self.size, max_det=tr["max_det"], dtype=torch.bfloat16, device=self.device,
            int8="all" if tr["precision"] == "int8" else "off",
            calib_batches=[self.calib.permute(0, 2, 3, 1)])
        self.pre = CerberusPreprocessor(img_size=self.size, stride=self.inference.stride,
                                        device=self.device)

    def captures(self) -> int:
        """CUDA graphs captured so far (serving programs and letterboxes)."""
        return len(self.inference.programs) + len(self.pre._programs)

    def counters(self) -> Dict[str, int]:
        """The port's launch counters of its hand-written kernels."""
        from cerberusdet_tpu_torch.ops.conv_int8_cuda import conv_s8, quant_pack_s8, quant_s8
        from cerberusdet_tpu_torch.ops.nms_cuda import greedy_nms_cuda
        return {"conv_s8_kernel": conv_s8.launches, "quant_pack_s8": quant_pack_s8.launches,
                "quant_nchw_kernel": quant_s8.launches, "nms_kernel": greedy_nms_cuda.launches}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("engine", "inference", "pre"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_lists(self, spec=None) -> List[tuple]:
        """The reference's (boxes, scores, labels) for every pool frame.
        spec (the limits file's "reference", or a control's): quant_bits, the
        reference's Convs quantized to that many bits and calibrated on the
        calibration frames, in calib_dtype where given (the dtype the
        program's float model calibrates in); act_dtype, the activations
        rounded to that dtype at each Conv's input and output, as the
        program stores them between its int8 Convs."""
        spec = spec or {}
        tr, cfg = self.cell.traffic, self.cell.config["model"]
        bits = spec.get("quant_bits")
        Reference = self.cell.family.Reference
        w = {k: v.to(self.device) for k, v in self.weights.items()}
        ref = Reference(cfg, self.tasks, self.ncs, w, torch.float32, quant_bits=bits,
                        act_dtype=DTYPES.get(spec.get("act_dtype")))
        out = []
        with no_tf32():
            if bits:
                cal = ref
                if spec.get("calib_dtype"):
                    cal = Reference(cfg, self.tasks, self.ncs, w, DTYPES[spec["calib_dtype"]])
                cal.calibrate([self.calib])
                ref.amax = cal.amax
                del cal
            for i in range(0, len(self.pool), REF_BLOCK):
                x = letterbox(self.pool_dev[i:i + REF_BLOCK].to(self.device), self.size)
                preds = {t: p.float().cpu().numpy() for t, p in ref.forward(x).items()}
                for j in range(x.shape[0]):
                    b, s, c, _ = detections({t: preds[t][j] for t in self.tasks}, self.ncs,
                                            self.pool[i + j].shape[:2], self.size, tr["conf"],
                                            tr["iou"], tr["iou_between"], tr["max_det"])
                    out.append((np.round(b), s, c))
        del w, ref
        return out

    def check(self, spec=None) -> Dict[str, float]:
        """Every kept answer of the window against the reference's list of its
        frame; spec: the reference (the limits file's by default)."""
        ref = self.reference_lists(self.cell.limits.get("reference") if spec is None else spec)
        task_of = tasks_of(self.ncs)
        counts = sum((unmatched(as_arrays(dets), ref[i], task_of) for i, dets in self.answers),
                     np.zeros(4, np.int64))
        self.confident = int(counts[3])
        return {"unmatched_share": share(counts)}

    def control(self, spec: dict, reference=None) -> Dict[str, float]:
        """The control's reading: the reference with its Convs quantized to
        spec["quant_bits"] put in the program's place, over every pool frame,
        against the compared reference (the limits file's by default)."""
        reference = self.cell.limits.get("reference") if reference is None else reference
        ref = self.reference_lists(reference)
        low = self.reference_lists({**(reference or {}), **spec})
        task_of = tasks_of(self.ncs)
        counts = sum((unmatched(a, b, task_of) for a, b in zip(low, ref)), np.zeros(4, np.int64))
        return {"unmatched_share": share(counts)}
