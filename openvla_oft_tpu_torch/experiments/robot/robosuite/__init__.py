"""Port of `experiments/robot/robosuite/`."""
