"""losses of the PyTorch/CUDA port."""
