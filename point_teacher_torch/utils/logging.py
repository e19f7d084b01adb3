"""Training logger (the port's copy of point_teacher_tpu/utils/logging.py):
averaged console lines and a JSON-lines file.

The counterpart of mmcv's LogBuffer + TextLoggerHook every 50 iterations
and of the json log that tools/analysis_tools/analyze_logs.py reads:
WORK_DIR/train_log.jsonl holds `mode: "train"` records, the metrics
averaged since the last record, written every `interval` iterations and at
each epoch's end, and `mode: "val"` records, written at once. The console
line is `Epoch [e] Iter [i] lr: ..., time: ...s/it, <losses>`. In a world of
ranks only rank 0 writes either (the metrics are the global batch's on
every rank).
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

from ..parallel import dist


class LogBuffer:
    def __init__(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def update(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self._sums[k] += float(v)
            self._counts[k] += 1

    def averages(self) -> Dict[str, float]:
        return {k: self._sums[k] / max(self._counts[k], 1) for k in self._sums}

    def clear(self):
        self._sums.clear()
        self._counts.clear()


class TrainLogger:
    def __init__(self, work_dir: Optional[str] = None, interval: int = 50):
        self.buffer = LogBuffer()
        self.interval = interval
        self.jsonl = None
        self.enabled = dist.rank() == 0
        if work_dir and self.enabled:
            os.makedirs(work_dir, exist_ok=True)
            self.jsonl = open(os.path.join(work_dir, "train_log.jsonl"), "a")
        self._t0 = time.time()

    def step(self, step: int, epoch: int, metrics: Dict[str, float], lr: float = 0.0):
        self.buffer.update(metrics)
        if step % self.interval == 0:
            self.emit(step, epoch, lr)

    def emit(self, step: int, epoch: int, lr: float = 0.0):
        """Write the averaged buffer now (the epoch's end); nothing when no
        metric came since the last write."""
        if not self.buffer._counts or not self.enabled:
            self.buffer.clear()
            return
        avg = self.buffer.averages()
        dt = time.time() - self._t0
        self._t0 = time.time()
        msg = ", ".join(f"{k}: {avg[k]:.4f}" for k in sorted(k for k in avg if "loss" in k))
        n = max(next(iter(self.buffer._counts.values()), 1), 1)
        print(f"Epoch [{epoch}] Iter [{step}] lr: {lr:.2e}, time: {dt / n:.3f}s/it, {msg}",
              flush=True)
        if self.jsonl:
            self._write(dict(mode="train", epoch=epoch, iter=step, lr=lr, **avg))
        self.buffer.clear()

    def val(self, step: int, epoch: int, metrics: Dict[str, float], lr: float = 0.0):
        """A mode="val" record, written at once (mmcv's EvalHook logs every
        evaluation whatever the iteration interval)."""
        if self.jsonl:
            self._write(dict(mode="val", epoch=epoch, iter=step, lr=lr,
                             **{k: float(v) for k, v in metrics.items()}))

    def _write(self, rec: dict):
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self):
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None
