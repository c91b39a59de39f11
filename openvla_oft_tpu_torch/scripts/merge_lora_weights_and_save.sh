#!/bin/bash
# Offline LoRA-merge launcher: the port's copy of
# vla_scripts/merge_lora_weights_and_save.sh (reference
# vla-scripts/merge_lora_weights_and_save.sh:12-16).
#   1 BASE_CHECKPOINT   2 LORA_FINETUNED_CHECKPOINT_DIR
# Further flags (e.g. --device cpu, --lora_rank R) are passed through.
set -euo pipefail

BASE_CHECKPOINT="$1"
LORA_FINETUNED_CHECKPOINT_DIR="$2"   # the finetune run dir holding ckpt/<step>.pt
shift 2

REPO_ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$REPO_ROOT${PYTHONPATH:+:$PYTHONPATH}"

python -m openvla_oft_tpu_torch.scripts.merge_lora_weights_and_save \
    --base_checkpoint "$BASE_CHECKPOINT" \
    --finetune_run_dir "$LORA_FINETUNED_CHECKPOINT_DIR" \
    "$@"
