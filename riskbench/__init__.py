"""The benchmark of the PyTorch and CUDA port of the risk engine (see README.md)."""
