"""metrics of the PyTorch/CUDA port."""
