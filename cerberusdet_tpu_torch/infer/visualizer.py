"""Detection drawing utilities.

A copy of cerberusdet_tpu/infer/visualizer.py (host code, cv2 and numpy
only), whose parity target is cerberusdet/cerberusdet_inference.py:189-306
(CerberusVisualizer) and cerberusdet/utils/plots.py:31-115 (color palette,
plot_one_box, label merge for identical boxes).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import cv2
import numpy as np

_HEX = (
    "FF3838", "FF9D97", "FF701F", "FFB21D", "CFD231", "48F90A", "92CC17",
    "3DDB86", "1A9334", "00D4BB", "2C99A8", "00C2FF", "344593", "6473FF",
    "0018EC", "8438FF", "520085", "CB38FF", "FF95C8", "FF37C7",
)


class Colors:
    """Deterministic per-class palette (plots.py:31-55)."""

    def __init__(self):
        self.palette = [self._hex2rgb(f"#{c}") for c in _HEX]
        self.n = len(self.palette)

    @staticmethod
    def _hex2rgb(h: str) -> Tuple[int, int, int]:
        return tuple(int(h[1 + i : 1 + i + 2], 16) for i in (0, 2, 4))

    def __call__(self, i: int, bgr: bool = False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()


class CerberusVisualizer:
    def __init__(self, line_thickness: int = 3, text_scale: float = 0.6):
        # 0 = auto: scale with image size per box (plots.py:100)
        self.lw = line_thickness
        self.ts = text_scale

    def _lw(self, im: np.ndarray) -> int:
        return self.lw or max(round(sum(im.shape) / 2 * 0.003), 2)

    def draw_box(self, im: np.ndarray, box: Sequence[float], label: str = "",
                 color: Tuple[int, int, int] = (128, 128, 128)) -> np.ndarray:
        lw = self._lw(im)
        p1 = (int(box[0]), int(box[1]))
        p2 = (int(box[2]), int(box[3]))
        cv2.rectangle(im, p1, p2, color, lw, cv2.LINE_AA)
        if label:
            tf = max(lw - 1, 1)
            wh, _ = cv2.getTextSize(label, 0, self.ts, tf)
            outside = p1[1] - wh[1] - 3 >= 0
            p2t = (p1[0] + wh[0], p1[1] - wh[1] - 3 if outside else p1[1] + wh[1] + 3)
            cv2.rectangle(im, p1, p2t, color, -1, cv2.LINE_AA)
            cv2.putText(im, label, (p1[0], p1[1] - 2 if outside else p1[1] + wh[1] + 2),
                        0, self.ts, (255, 255, 255), tf, cv2.LINE_AA)
        return im

    def draw_detections(self, image: np.ndarray, detections: List[Dict],
                        hide_labels: bool = False, hide_conf: bool = False,
                        hide_task: bool = True) -> np.ndarray:
        """image: HWC BGR. detections: CerberusDetInference.predict rows.
        Identical boxes from different tasks get one merged multi-part label;
        the hide_* switches mirror the reference's create_label
        (plots.py:81-95, detect.py:134-136 / 28-52)."""
        im = image.copy()
        groups: Dict[tuple, List[Dict]] = {}
        for det in detections:
            groups.setdefault(tuple(det["box"]), []).append(det)
        for box, dets in groups.items():
            if hide_labels:
                label = None
            else:
                parts = []
                for d in dets:
                    p = d["label_name"]
                    if not hide_conf:
                        p += f" {d['score']:.2f}"
                    if not hide_task:
                        p += f" {d['task']}"
                    parts.append(p)
                label = " | ".join(parts)
            self.draw_box(im, box, label, colors(dets[0]["label"], bgr=True))
        return im
