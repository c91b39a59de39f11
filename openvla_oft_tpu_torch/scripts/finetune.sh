#!/bin/bash
# OFT LoRA fine-tuning launcher on NVIDIA GPUs: the port's copy of
# vla_scripts/finetune.sh (reference vla-scripts/finetune.sh:1-45), over
# `python -m openvla_oft_tpu_torch.training.finetune`.
#
# Positional args mirror the reference launcher:
#   1 CKPT_FOLDER   2 RUN_ID_NOTE   3 RESUME   4 RESUME_STEP
#   5 RUN_ROOT_DIR  6 DATASET_NAME
#
# One process drives one GPU. With MESH_FSDP x MESH_TP = 1 the run is one
# plain process; above 1 it starts through
#   torchrun --nproc-per-node $((MESH_FSDP * MESH_TP))
# one process per rank (parallel/mesh.py), and MULTIHOST=true makes each
# rank join the process group from torchrun's environment.
set -euo pipefail

CKPT_FOLDER="${1:-openvla/openvla-7b}"
RUN_ID_NOTE="${2:-parallel_dec--8_acts_chunk--continuous_acts--L1_regression--3rd_person_img-gripper_img}"
RESUME="${3:-false}"
RESUME_STEP="${4:-0}"
RUN_ROOT_DIR="${5:-runs}"
DATASET_NAME="${6:-ur5e_pick_place}"

DATA_ROOT_DIR="${DATA_ROOT_DIR:-datasets/rlds}"
MULTIHOST="${MULTIHOST:-false}"
MESH_FSDP="${MESH_FSDP:-1}"
MESH_TP="${MESH_TP:-1}"

# The package resolves from any working directory; relative paths stay the
# caller's.
REPO_ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$REPO_ROOT${PYTHONPATH:+:$PYTHONPATH}"

RESUME_ARGS=()
if [ "$RESUME" = "true" ]; then
    RESUME_ARGS=(--resume true --resume_step "$RESUME_STEP")
fi

NPROC=$((MESH_FSDP * MESH_TP))
if [ "$NPROC" -gt 1 ]; then
    LAUNCH=(torchrun --nproc-per-node "$NPROC")
else
    LAUNCH=(python)
fi

"${LAUNCH[@]}" -m openvla_oft_tpu_torch.training.finetune \
    --vla_path "$CKPT_FOLDER" \
    --data_root_dir "$DATA_ROOT_DIR" \
    --dataset_name "$DATASET_NAME" \
    --run_root_dir "$RUN_ROOT_DIR" \
    --use_l1_regression true \
    --use_diffusion false \
    --use_film false \
    --num_images_in_input 2 \
    --use_proprio true \
    --batch_size 8 \
    --learning_rate 5e-4 \
    --num_steps_before_decay 100000 \
    --max_steps 224686 \
    --save_freq 5000 \
    --save_latest_checkpoint_only false \
    --image_aug true \
    --lora_rank 32 \
    --mesh_fsdp "$MESH_FSDP" \
    --mesh_tp "$MESH_TP" \
    --multihost "$MULTIHOST" \
    --run_id_note "$RUN_ID_NOTE" \
    "${RESUME_ARGS[@]}" \
    ${EXTRA_ARGS:-}
# EXTRA_ARGS: optional extra --flag value pairs appended last; the CLI lets
# later flags win, so e.g. EXTRA_ARGS="--device cpu --batch_size 2
# --max_steps 2" gives a smoke run without editing this file
# (word-splitting is intentional).
