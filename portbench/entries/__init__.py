"""One module per entry point that a window drives; a workload names it."""
