#!/usr/bin/env bash
# Data-parallel training of the PyTorch port over GPUS ranks of this host
# (the counterpart of tools/dist_train.sh): torchrun starts one process a
# rank, each on cuda:LOCAL_RANK over NCCL (gloo with --cpu).
#   point_teacher_torch/tools/dist_train.sh CONFIG GPUS [train.py flags]
CONFIG=$1
GPUS=$2
shift 2
cd "$(dirname "$0")/../.." || exit 1
exec torchrun --standalone --nproc_per_node="$GPUS" -m point_teacher_torch.tools.train \
    "$CONFIG" "$@"
