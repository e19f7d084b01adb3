"""The port's training CLI (point_teacher_torch.tools.train) on the CPU at
64 px for the trainers and options beside the HBB Point-Teacher chain
(test_torch_cli_train.py): the fcos and rfla_fcos trainers, 2 steps each
with a validation, over an on-disk AI-TOD-v2 COCO set; the SODA-A
Point-Teacher, 2 steps (phase 1, then phase 2) over an on-disk divData
split; and `model.pretrained`, a torchvision-layout ResNet-50 .pth, through
the CLI's setup. In this process, on one torch thread."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from point_teacher_torch.config_io import load_config
from point_teacher_torch.tools import train as cli
from point_teacher_torch.utils import checkpoint as ckpt
from test_torch_cli_train import (FCOS, RFLA, SMALL, SODAA, _records, aitod,  # noqa: F401
                                  drop_checkpoints, run_main)
from test_torch_fcos_baseline import one_thread
from test_torch_train_loader import write_sodaa_patches


@pytest.mark.parametrize("config,keys", [
    (FCOS, {"loss_cls", "loss_bbox", "loss_centerness", "total_loss"}),
    (RFLA, {"loss_cls", "loss_bbox", "loss_centerness", "total_loss", "num_pos"})],
    ids=["fcos", "rfla_fcos"])
def test_baseline_trainers_run_from_disk(aitod, tmp_path, config, keys):
    _, out = run_main(cli.main, [config, "--cpu", "--work-dir", str(tmp_path), "--max-steps", "2",
                                 "--val-interval", "1", "--cfg-options", *SMALL, *aitod])
    records = _records(out)
    assert [r["step"] for r in records] == [1, 2]
    for r in records:
        assert set(r) == keys | {"step", "epoch", "step_ms"}
        assert all(np.isfinite(r[k]) for k in keys)
    assert "epoch 1: val mAP = " in out and (tmp_path / "best.pth").exists()
    drop_checkpoints(str(tmp_path))


def test_rotated_cli_trains_from_a_divdata_split(tmp_path):
    ann, img = write_sodaa_patches(str(tmp_path / "divData"), 5, seed=6)
    _, out = run_main(cli.main, [SODAA, "--cpu", "--work-dir", str(tmp_path / "run"),
                                 "--max-steps", "2", "--cfg-options", *SMALL,
                                 "pt.burn_in_step=0", f"dataset.train_ann={ann}",
                                 f"dataset.train_img_prefix={img}"])
    assert "dataset: 4 images, 9 classes" in out
    records = _records(out)
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in records)
    assert ckpt.load_meta(str(tmp_path / "run" / "latest.pth")) == dict(epoch=1, step=2,
                                                                          num_images=4)
    drop_checkpoints(str(tmp_path / "run"))




def test_pretrained_option_loads_the_backbone(tmp_path):
    """model.pretrained (a torchvision-layout ResNet-50 .pth) reaches the
    student and the teacher through the CLI's setup."""
    cfg = cli.apply_overrides(load_config(FCOS), [*SMALL])
    _, state, _ = one_thread(lambda: cli.setup(cfg, 4, 0, torch.device("cpu")))
    sd = {k: v + 1.0 for k, v in state.student.backbone.state_dict().items()}
    path = tmp_path / "r50.pth"
    torch.save(sd, path)
    cfg = cli.apply_overrides(load_config(FCOS), [*SMALL, f"model.pretrained={path}"])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        _, loaded, _ = one_thread(lambda: cli.setup(cfg, 4, 0, torch.device("cpu")))
    assert f"loaded pretrained backbone from {path}" in out.getvalue()
    for branch in (loaded.student, loaded.teacher):
        for k, v in branch.backbone.state_dict().items():
            assert torch.equal(v, sd[k]), k
