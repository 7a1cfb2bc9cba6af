"""Tensor ops of the port: features, convs, the GRU layer and its CUDA
kernel."""
