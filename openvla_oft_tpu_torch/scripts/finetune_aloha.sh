#!/bin/bash
# ALOHA OFT+ fine-tuning launcher: the port's copy of vla_scripts/finetune_aloha.sh
# (reference ALOHA.md:59-84 recipe: FiLM on, 3 camera images, proprio, 100K
# steps with decay at 50K). --mesh_fsdp 8 shards the run over 8 GPUs, one
# process each, started by torchrun. Further flags are passed through.
set -euo pipefail

VLA_PATH=${VLA_PATH:-/checkpoints/openvla-7b}
DATA_ROOT=${DATA_ROOT:-/data/rlds}

REPO_ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$REPO_ROOT${PYTHONPATH:+:$PYTHONPATH}"

torchrun --nproc-per-node 8 -m openvla_oft_tpu_torch.training.finetune \
  --vla_path "$VLA_PATH" \
  --data_root_dir "$DATA_ROOT" \
  --recipe oft-plus-aloha_scoop_x_into_bowl \
  --mesh_fsdp 8 \
  "$@"
