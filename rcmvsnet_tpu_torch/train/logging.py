"""Metrics logging: running means + JSONL/CSV scalars (+ TensorBoard when
available). Replaces the reference's utils.py:70-122 without a hard torch
dependency."""
from __future__ import annotations

import json
import time
from pathlib import Path


class DictAverageMeter:
    """Running mean of scalar dicts (utils.py:103-122)."""

    def __init__(self):
        self.data = {}
        self.count = 0

    def update(self, new_input: dict):
        self.count += 1
        for k, v in new_input.items():
            self.data[k] = self.data.get(k, 0.0) + float(v)

    def mean(self):
        return {k: v / max(self.count, 1) for k, v in self.data.items()}


class MetricLogger:
    """Appends {mode, step, time, **scalars} lines to scalars.jsonl and
    mirrors to TensorBoard if tensorboardX/torch SummaryWriter importable."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.logdir / "scalars.jsonl", "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(str(self.logdir))
        except Exception:
            pass

    def log(self, mode: str, scalars: dict, step: int):
        rec = {"mode": mode, "step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{mode}/{k}", float(v), int(step))

    def log_images(self, mode: str, images: dict, step: int):
        """Depth/confidence/error image summaries, matching the reference's
        save_images (the reference's utils.py:83-100: first batch element,
        per-image min-max normalization). Mirrors to TensorBoard when
        available and always writes PNGs under logdir/images/."""
        import numpy as np

        img_dir = self.logdir / "images"
        img_dir.mkdir(exist_ok=True)
        for name, value in images.items():
            img = np.asarray(value, np.float32)
            if img.ndim == 4:        # [B, H, W, C] → first sample
                img = img[0]
            elif img.ndim == 3:      # [B, H, W] → first sample, grayscale
                img = img[0][..., None]
            lo, hi = float(img.min()), float(img.max())
            norm = (img - lo) / max(hi - lo, 1e-8)
            if self._tb is not None:
                self._tb.add_image(f"{mode}/{name}",
                                   norm.transpose(2, 0, 1), int(step))
            try:
                import cv2
                out = (norm[..., ::-1] if norm.shape[-1] == 3
                       else norm[..., 0])
                cv2.imwrite(str(img_dir / f"{mode}_{name}_{step:08d}.png"),
                            (out * 255).astype(np.uint8))
            except Exception:
                pass

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()
