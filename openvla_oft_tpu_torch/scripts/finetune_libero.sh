#!/bin/bash
# LIBERO fine-tuning launcher: the port's copy of vla_scripts/finetune_libero.sh
# (reference vla-scripts/finetune_libero.sh:1-50, a multi-node torchrun
# wrapper). It delegates to finetune.sh, which starts one process per GPU.
#
# Positional args mirror the reference launcher:
#   1 CKPT_FOLDER   2 RUN_ID_NOTE   3 RESUME   4 RESUME_STEP
#   5 RUN_ROOT_DIR  6 DATASET_NAME (e.g. libero_spatial_no_noops)
set -euo pipefail

CKPT_FOLDER="${1:-openvla/openvla-7b}"
RUN_ID_NOTE="${2:-parallel_dec--8_acts_chunk--continuous_acts--L1_regression--3rd_person_img-gripper_img}"
RESUME="${3:-false}"
RESUME_STEP="${4:-0}"
RUN_ROOT_DIR="${5:-runs}"
DATASET_NAME="${6:-libero_spatial_no_noops}"

DATA_ROOT_DIR="${DATA_ROOT_DIR:-datasets/rlds/libero}" \
MULTIHOST="${MULTIHOST:-false}" \
exec bash "$(dirname "$0")/finetune.sh" \
    "$CKPT_FOLDER" "$RUN_ID_NOTE" "$RESUME" "$RESUME_STEP" \
    "$RUN_ROOT_DIR" "$DATASET_NAME"
