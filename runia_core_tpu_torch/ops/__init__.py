"""Numerical ops of the PyTorch port; ``*_cuda`` modules wrap the CUDA kernels."""
