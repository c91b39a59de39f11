"""Host utilities: the CLI parser."""
