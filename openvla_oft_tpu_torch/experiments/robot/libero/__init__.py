"""Port of `experiments/robot/libero/`."""
