"""The training CLI with the SODA-A config, on the CPU and without a card
(the rotated phase-2 step itself is held against JAX in
test_torch_rotated_train_step.py)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from point_teacher_torch.train.rsteps import build_rotated_train_step
from test_torch_rotated_train_step import _batch, _configs, _torch_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rotated_phase1_raises_not_implemented():
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="next slice"):
        build_rotated_train_step(tcfg)(None, _torch_batch(_batch(0)), phase1=True)


def test_rotated_cli_runs_on_cpu():
    cmd = [sys.executable, "-m", "point_teacher_torch.tools.train",
           os.path.join(REPO, "configs/point_teacher/sodaa_point_teacher_1x.py"),
           "--cpu", "--synthetic-data", "4", "--max-steps", "1", "--cfg-options",
           "pt.img_size=64", "pt.max_gt=6", "pt.burn_in_step=-1"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    records = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(records) == 1 and records[0]["step"] == 1
    for k in ("loss_cls", "loss_bbox", "loss_centerness", "total_loss",
              "stage0_loss_mil_bags", "coarse_bboxes_iou"):
        assert np.isfinite(records[0][k]), k


def test_rotated_cli_asks_for_cuda_without_a_card():
    """Without --cpu the CLI runs on the card, and raises where there is none."""
    from point_teacher_torch.tools.train import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(False).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(False)
