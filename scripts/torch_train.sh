#!/usr/bin/env bash
# Stage-3 diffusion training on the PyTorch port (ladine_tpu_torch): all
# members in one invocation, as scripts/train.sh runs the JAX package.
# NO_CAT_F_PHI=1 trains members that condition on y_t alone (the reference's
# --no_cat_f_phi).
set -euo pipefail

DATASET="${DATASET:-ChestXRay}"            # ChestXRay | ISICSkinCancer
DATA_DIR="${DATA_DIR:?set DATA_DIR to the dataset root}"
SEED="${SEED:-4444}"
TMP_NAME="${TMP_NAME:-run0}"
CONFIG="${CONFIG:-}"
GUIDANCE_CKPT="${GUIDANCE_CKPT:-}"
DEVICE="${DEVICE:-cuda}"
VIT_CKPT="${VIT_CKPT:-./models/vit_${DATASET}}"
MLP_CKPT_DIR="${MLP_CKPT_DIR:-./models/${DATASET}/MLPs}"

args=(
  --train
  --dataroot "$DATA_DIR"
  --seed "$SEED"
  --exp ./exp --doc "$TMP_NAME"
  --bf16
  --precompute_guidance
  --device "$DEVICE"
)
[[ -n "$CONFIG" ]] && args+=(--config "$CONFIG")
[[ -n "${NO_CAT_F_PHI:-}" ]] && args+=(--no_cat_f_phi)
if [[ -n "$GUIDANCE_CKPT" ]]; then
  args+=(--guidance_ckpt "$GUIDANCE_CKPT")
elif [[ -d "$VIT_CKPT" && -d "$MLP_CKPT_DIR" ]]; then
  args+=(--vit_ckpt "$VIT_CKPT" --mlp_ckpt_dir "$MLP_CKPT_DIR")
else
  echo "warning: no stage-1 checkpoints at $VIT_CKPT / $MLP_CKPT_DIR and no" \
       "GUIDANCE_CKPT set; training against a randomly-initialized guidance" >&2
fi

python -m ladine_tpu_torch.cli.main "${args[@]}"
