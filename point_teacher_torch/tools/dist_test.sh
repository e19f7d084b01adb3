#!/usr/bin/env bash
# Evaluation of the PyTorch port sharded over GPUS ranks of this host (the
# counterpart of tools/dist_test.sh): torchrun starts one process a rank,
# each on cuda:LOCAL_RANK over NCCL (gloo with --cpu).
#   point_teacher_torch/tools/dist_test.sh CONFIG CHECKPOINT GPUS [test.py flags]
CONFIG=$1
CKPT=$2
GPUS=$3
shift 3
cd "$(dirname "$0")/../.." || exit 1
exec torchrun --standalone --nproc_per_node="$GPUS" -m point_teacher_torch.tools.test \
    "$CONFIG" "$CKPT" "$@"
