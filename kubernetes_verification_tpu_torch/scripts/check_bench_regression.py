"""Bench-history regression gate of the port — thin shim over
``kubernetes_verification_tpu_torch/analysis/bench_gate.py``, the
counterpart of the root ``scripts/check_bench_regression.py``, with its
flags and exit codes::

    python -m kubernetes_verification_tpu_torch.scripts.check_bench_regression [PATHS] [--dry-run]

With no ``PATHS`` it gates the port's own ``bench_history.jsonl`` (or the
file ``KVTPU_BENCH_HISTORY`` names), and with none of those it gates no
run: the committed ``BENCH_r*.json`` are the JAX bench's runs on a TPU and
are read only when named.
"""
from __future__ import annotations

import sys

from ..analysis.bench_gate import main

__all__ = ["main"]

if __name__ == "__main__":
    sys.exit(main())
