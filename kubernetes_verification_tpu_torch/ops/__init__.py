"""Tensor operations of the PyTorch port: selector matching, the dense and
tiled reachability solves, the hand-written CUDA kernels and their plain
PyTorch versions, and packed-word helpers.

The solve and kernel modules (``tiled``, ``closure``, ``kernels``) are
imported by their full path; only the lightweight batched-probe entry
points are re-exported here, as in the JAX package."""
from .batched import batched_any_port, batched_reach_rows

__all__ = ["batched_any_port", "batched_reach_rows"]
