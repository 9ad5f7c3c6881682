"""Scalar logging (port of genpose2_tpu/utils/logging.py): one JSON record per
call appended to ``<log_dir>/<name>_metrics.jsonl`` (the file is open only
while a record is written), and TensorBoard event files under
``<log_dir>/tb/<name>`` when ``torch.utils.tensorboard`` imports."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional; the JSONL sink is not
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(os.path.join(log_dir, "tb", name))

    def log(self, step: int, scalars: dict) -> None:
        """Write the scalars that convert to float (tensors included)."""
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
