"""Port of `experiments/robot/aloha/`."""
