"""Tensor operations of the PyTorch port: selector matching, the dense and
tiled reachability solves, the hand-written CUDA kernels and their plain
PyTorch versions, and packed-word helpers."""
