#!/usr/bin/env bash
# Retrain one registry model with the port on the card, on the reference
# recipe's dataset, and print its best test instance accuracy.
#
#   bash scripts/retrain_torch.sh [MODEL] [DTYPE] [EPOCHS] [OUT_ROOT]
#
# Builds the dataset with `cli generate --num-per-class 8000` under
# build/retrain/, trains with `cli train` (batch 24, the reference recipe)
# and copies history.json, config.json, the log and best.pt.json to
# OUT_ROOT/retrain_<MODEL>_<DTYPE>/ (OUT_ROOT defaults to build/retrain).
set -euo pipefail
MODEL=${1:-pointnet2_cls_ssg}
DTYPE=${2:-bfloat16}
EPOCHS=${3:-40}
EXP=retrain_${MODEL}_${DTYPE}
OUT=${4:-build/retrain}/$EXP
mkdir -p "$OUT" build/retrain
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
t0=$(date +%s)
python3 -m pointnet_like_pose_estimation_tpu_torch.cli generate --num-per-class 8000 \
  --out build/retrain/dataset.npz
t1=$(date +%s)
echo "generate seconds $((t1 - t0))"
python3 -m pointnet_like_pose_estimation_tpu_torch.cli train --model "$MODEL" --epochs "$EPOCHS" \
  --dtype "$DTYPE" --data build/retrain/dataset.npz --log-dir build/retrain/log --experiment "$EXP" \
  > "$OUT/train_stdout.txt" 2> "$OUT/train_stderr.txt"
t2=$(date +%s)
echo "train seconds $((t2 - t1))"
TASK=$([[ $MODEL == *cls* ]] && echo classification || echo pose)
EXP_DIR=build/retrain/log/$TASK/$EXP
cp "$EXP_DIR/history.json" "$EXP_DIR/config.json" "$EXP_DIR"/logs/*.log "$OUT/"
cp "$EXP_DIR/checkpoints/best.pt.json" "$OUT/"
python3 - "$OUT/history.json" <<'PY'
import json, statistics, sys
h = json.load(open(sys.argv[1]))
key = "test_instance_acc" if "test_instance_acc" in h[0] else "test_mean_err"
pick = max if key == "test_instance_acc" else min
best = pick(h, key=lambda r: r[key])
print(f"epochs {len(h)}; best {key} {best[key]} at epoch {best['epoch']}; last {h[-1][key]}; "
      f"median seconds an epoch {statistics.median(r['seconds'] for r in h)} (first {h[0]['seconds']})")
PY
