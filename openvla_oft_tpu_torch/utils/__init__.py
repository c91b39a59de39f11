"""Host utilities: the CLI parser and CUDA-event timing."""
