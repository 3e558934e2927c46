"""Runtime: streaming sessions and the pool server (runtime/stream.py)."""
