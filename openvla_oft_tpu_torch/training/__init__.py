"""Training: LoRA, the train step, checkpoints and the fine-tuning CLI."""
