#!/usr/bin/env bash
# Stage-2 training with the PyTorch port: the refine module on top of a
# base checkpoint_e{N}.pth (train_refine.sh's counterpart). Further flags
# go to the train CLI (--device cpu, --num-devices N, ...).
set -e
cd "$(dirname "$0")/.."
PRETRAINED=${1:?usage: train_refine_torch.sh <base_checkpoint.pth> [train CLI flags]}
shift
python -m siammask_tpu_torch.tools.train --config experiments/siammask_sharp/config.json \
    --task sharp_refine --epochs 20 --batch "${BATCH:-64}" \
    --save-dir snapshot_refine --pretrained "$PRETRAINED" --tb-dir board "$@"
