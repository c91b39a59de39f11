"""Training data: the batch transform and the dummy dataset."""
