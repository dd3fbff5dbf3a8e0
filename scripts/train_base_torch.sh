#!/usr/bin/env bash
# Stage-1 training with the PyTorch port: SiamMask-base on the full dataset
# mix (train_base.sh's counterpart). Further flags go to the train CLI:
# --device cpu, --num-devices N, --fused-allreduce, ...
set -e
cd "$(dirname "$0")/.."
python -m siammask_tpu_torch.tools.train --config experiments/siammask_base/config.json \
    --task base --epochs 20 --batch "${BATCH:-64}" --save-dir snapshot \
    --tb-dir board "$@"
