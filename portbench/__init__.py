"""The benchmark of grail_tpu_torch, the PyTorch and CUDA port (see README.md)."""
