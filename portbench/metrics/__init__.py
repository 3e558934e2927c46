"""One reader per per-layer metric, metrics/<metric name>.py, loaded by path."""
