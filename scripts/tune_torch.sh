#!/usr/bin/env bash
# Hyperparameter grid search with the PyTorch port; run N copies
# concurrently: the file-claim protocol shares the grid (tune.sh's
# counterpart). Further flags go to the tune CLI (--resume, --device cpu,
# ...).
set -e
cd "$(dirname "$0")/.."
python -m siammask_tpu_torch.tools.tune --config experiments/siammask_sharp/config_vot18.json \
    --dataset "${DATASET:-VOT2018}" "$@"
