#!/usr/bin/env bash
# Stage 1 on the PyTorch port (ladine_tpu_torch): the backbone fine-tune,
# then the mapping MLPs, as scripts/stage1.sh runs them with the JAX package.
# MODEL_ARCH picks the stage-1 backbone (vit, deit, deit_distilled, convit,
# efficientnetv2, resnet18, resnet50); the mapping stage taps the ViT only,
# so it runs for MODEL_ARCH=vit.
set -euo pipefail

DATASET="${DATASET:-ChestXRay}"
DATA_DIR="${DATA_DIR:?set DATA_DIR to the dataset root}"
OUT="${OUT:-./models}"
NUM_MEMBERS="${NUM_MEMBERS:-5}"
MODEL_ARCH="${MODEL_ARCH:-vit}"
DEVICE="${DEVICE:-cuda}"
# PER_MLP=1: one mapping MLP per invocation; PER_MLP=0 (default): all K
# together (five MLPs' fp32 Adam state fit on one 80 GB card)
PER_MLP="${PER_MLP:-0}"

python -m ladine_tpu_torch.cli.train_transformer \
  --dataset "$DATASET" --dataroot "$DATA_DIR" --out "$OUT" --model_arch "$MODEL_ARCH" --device "$DEVICE"

[[ "$MODEL_ARCH" == "vit" ]] || exit 0
if [[ "$PER_MLP" == "1" ]]; then
  for k in $(seq 0 $((NUM_MEMBERS - 1))); do
    python -m ladine_tpu_torch.cli.train_mapping \
      --dataset "$DATASET" --dataroot "$DATA_DIR" --out "$OUT" --device "$DEVICE" \
      --vit_ckpt "$OUT/vit_${DATASET}" --num_members "$NUM_MEMBERS" --mlp_idx "$k"
  done
else
  python -m ladine_tpu_torch.cli.train_mapping \
    --dataset "$DATASET" --dataroot "$DATA_DIR" --out "$OUT" --device "$DEVICE" \
    --vit_ckpt "$OUT/vit_${DATASET}" --num_members "$NUM_MEMBERS"
fi
