"""Port of `experiments/robot/bridge/`."""
