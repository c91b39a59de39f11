"""The robot eval clients on the port (the port's copy of `experiments/`)."""
