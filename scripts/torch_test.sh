#!/usr/bin/env bash
# Robust nested-ensemble evaluation on the PyTorch port (ladine_tpu_torch),
# with scripts/test.sh's environment variables: NOISE_PERTURBATION, LOW_RES,
# BRIGHTNESS, CONTRAST, COVERED_K, COVERED_N, CROP, ATTACK_NAME, EPSILON, DDIM.
set -euo pipefail

DATASET="${DATASET:-ChestXRay}"
DATA_DIR="${DATA_DIR:?set DATA_DIR to the dataset root}"
SEED="${SEED:-4444}"
TMP_NAME="${TMP_NAME:-test0}"
NOISE_PERTURBATION="${NOISE_PERTURBATION:-0.0}"
LOW_RES="${LOW_RES:-1}"
BRIGHTNESS="${BRIGHTNESS:-0.0}"
CONTRAST="${CONTRAST:-1.0}"
COVERED_K="${COVERED_K:-0.0}"
COVERED_N="${COVERED_N:-0}"
CROP="${CROP:-0.0}"
ATTACK_NAME="${ATTACK_NAME:-}"
EPSILON="${EPSILON:-0.03}"
DDIM="${DDIM:-0}"
DEVICE="${DEVICE:-cuda}"

args=(
  --test
  --dataroot "$DATA_DIR"
  --seed "$SEED"
  --exp ./exp --doc "$TMP_NAME"
  --noise_perturbation "$NOISE_PERTURBATION"
  --low_resolution "$LOW_RES"
  --brightness "$BRIGHTNESS"
  --contrast "$CONTRAST"
  --covered "$COVERED_K" "$COVERED_N"
  --crop "$CROP"
  --ddim "$DDIM"
  --bf16
  --device "$DEVICE"
)
[[ -n "$ATTACK_NAME" ]] && args+=(--attack_name "$ATTACK_NAME" --epsilon "$EPSILON")
# DIFFUSION_CKPT: one training checkpoint (exp/logs/<run>/diffu_all*), or K
# per-member checkpoints (cli/convert.py's member_{k})
[[ -n "${DIFFUSION_CKPT:-}" ]] && args+=(--diffusion_ckpt $DIFFUSION_CKPT)
[[ -n "${GUIDANCE_CKPT:-}" ]] && args+=(--guidance_ckpt "$GUIDANCE_CKPT")
[[ -n "${VIT_CKPT:-}" ]] && args+=(--vit_ckpt "$VIT_CKPT" --mlp_ckpt_dir "${MLP_CKPT_DIR:?}")
[[ -n "${EVAL_EMA:-}" ]] && args+=(--eval_ema)

python -m ladine_tpu_torch.cli.main "${args[@]}"
