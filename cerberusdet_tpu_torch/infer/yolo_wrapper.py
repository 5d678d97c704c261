"""Single-task YOLOv8 inference from plain state-dict checkpoints.

Counterpart of cerberusdet_tpu/infer/yolo_wrapper.py, whose parity target is
cerberusdet/yolo_wrapper.py:125-260 (YOLOV8ForObjectDetection.from_pretrained
/ predict): load a bare yolov8 state_dict (no ultralytics dependency: the
importer and the port's model replace it), run single-task detection, return
per-image box/score/label dicts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from cerberusdet_tpu_torch.infer.inference import CerberusDetInference
from cerberusdet_tpu_torch.infer.preprocessor import CerberusPreprocessor


class YOLOV8ForObjectDetection:
    """Single-task wrapper over the multi-task stack (one head, task 'detect')."""

    def __init__(self, inference: CerberusDetInference, preprocessor: CerberusPreprocessor):
        self.inference = inference
        self.preprocessor = preprocessor
        self.names = inference.all_class_names

    @classmethod
    def from_pretrained(
        cls,
        weights: str,
        cfg: str = "configs/models/yolov8x.yaml",
        names: Optional[Sequence[str]] = None,
        nc: Optional[int] = None,
        img_size: int = 640,
        conf_thres: float = 0.25,
        iou_thres: float = 0.45,
        half: bool = True,
        device=None,
    ) -> "YOLOV8ForObjectDetection":
        """A .ckpt.npz of either package, or a .pt (a bare YOLOv8 state dict
        or any layout manager/pt_import.py reads), which needs `nc` or
        `names`. `device` None means the card."""
        if weights.endswith(".pt"):
            from cerberusdet_tpu_torch.manager.pt_import import import_pt
            from cerberusdet_tpu_torch.models.cerberus import CerberusModel

            if nc is None and names is not None:
                nc = len(names)
            if nc is None:
                raise ValueError("nc or names required for .pt weights")
            names = list(names) if names else [str(i) for i in range(nc)]
            model = import_pt(CerberusModel(cfg, ["detect"], [nc], device=device).init(0),
                              weights)
            inference = CerberusDetInference(
                model=model, names={"detect": names}, conf_thres=conf_thres,
                iou_thres=iou_thres, img_size=img_size, half=half, device=device,
            )
        else:
            inference = CerberusDetInference(
                weights=weights, conf_thres=conf_thres, iou_thres=iou_thres,
                img_size=img_size, half=half, device=device,
            )
        pre = CerberusPreprocessor(img_size=img_size, stride=inference.stride, device=device)
        return cls(inference, pre)

    def predict(self, images: Union[np.ndarray, List[np.ndarray]],
                conf_thres: Optional[float] = None,
                iou_thres: Optional[float] = None) -> List[List[Dict]]:
        """images: one or a list of HWC BGR uint8 arrays. Returns per image a
        list of {box, score, label, label_name} dicts."""
        if isinstance(images, np.ndarray):
            images = [images]
        batch, shapes = self.preprocessor.preprocess(images)
        out = self.inference.predict(batch, original_shape=shapes,
                                     conf_thres=conf_thres, iou_thres=iou_thres)
        for image_results in out:
            for det in image_results:
                det.pop("task", None)
        return out
