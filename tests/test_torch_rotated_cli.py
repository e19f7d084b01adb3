"""The training CLI with the SODA-A config, on the CPU and without a card
(the rotated step itself is held against JAX in
test_torch_rotated_train_step.py)."""
import numpy as np
import pytest
import torch

from test_torch_train_step import CLI_KEYS, run_cli_across_the_switch
from torch_port_env import port_test_module  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def cli_records():
    return run_cli_across_the_switch("sodaa_point_teacher_1x.py")


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("key", CLI_KEYS + ["coarse_bboxes_iou"])
def test_rotated_cli_runs_both_phases_on_cpu(cli_records, phase, key):
    """burn_in_step 0: step 1 runs phase 1, step 2 phase 2; each step has the
    same metric keys, and this one is finite."""
    r = cli_records[phase - 1]
    assert set(r) == set(cli_records[0])
    assert np.isfinite(r[key]), key


def test_rotated_cli_runs_on_cpu(cli_records):
    """The CLI's phase-2 step on the CPU (the second step of the run)."""
    assert cli_records[1]["step"] == 2
    for k in ("loss_cls", "loss_bbox", "loss_centerness", "total_loss",
              "stage0_loss_mil_bags", "coarse_bboxes_iou"):
        assert np.isfinite(cli_records[1][k]), k


def test_rotated_cli_asks_for_cuda_without_a_card():
    """Without --cpu the CLI runs on the card, and raises where there is none."""
    from point_teacher_torch.tools.train import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(False).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(False)
