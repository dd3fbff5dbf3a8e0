#!/usr/bin/env bash
# Sweep the PyTorch port's checkpoints (snapshot/checkpoint_e{N}.pth) over a
# dataset, then evaluate them (test_all.sh's counterpart). Further flags go
# to the test CLI (--device cpu, --dtype bfloat16, --data-dir, ...).
set -e
cd "$(dirname "$0")/.."
DATASET=${DATASET:-VOT2018}
CONFIG=${CONFIG:-experiments/siammask_sharp/config_vot18.json}
START=${START:-1}; END=${END:-20}
for e in $(seq "$START" "$END"); do
    ckpt="snapshot/checkpoint_e${e}.pth"
    [ -f "$ckpt" ] || continue
    python -m siammask_tpu_torch.tools.test --config "$CONFIG" --resume "$ckpt" \
        --mask --refine --dataset "$DATASET" \
        --tracker-name "ckpt_e${e}" "$@"
done
python -m siammask_tpu_torch.tools.eval --dataset "$DATASET" --result-dir test \
    --tracker-prefix ckpt_
