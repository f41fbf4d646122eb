"""Headless entry point: ``python -m kubernetes_verification_tpu_torch.analysis``
runs the same lint driver as ``kv-tpu-torch lint`` (identical flags,
identical exit codes) without importing the CLI, torch or any backend."""
from __future__ import annotations

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
