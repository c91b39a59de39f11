"""Port of `experiments/robot/robosuite/collect_data/`."""
