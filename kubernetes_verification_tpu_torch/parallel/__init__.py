"""Multi-owner geometry of the PyTorch port.

Only ``stripes`` (the contiguous pod-range stripe geometry the stripe
fleet of ``serve/stripes.py`` routes by) is ported so far; the sharded
paths of the JAX package's ``parallel`` come later.
"""
from .stripes import parse_stripe, stripe_bounds, stripe_of, stripe_table

__all__ = ["stripe_bounds", "stripe_of", "stripe_table", "parse_stripe"]
