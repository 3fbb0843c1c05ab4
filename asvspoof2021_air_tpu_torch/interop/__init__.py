"""interop of the PyTorch/CUDA port."""
