"""First-dispatch detection + operand accounting for dispatch sites.

The port's copy of ``kubernetes_verification_tpu.observe.jit``. In the JAX
package a new abstract signature (shapes/dtypes of array operands plus
static arguments) is an XLA recompile; the port compiles nothing per call,
so ``kvtpu_jit_recompiles_total{engine=...,fn=...}`` keeps the meaning it
can have here: the first dispatch of ``fn`` at a signature never seen
before in this process. ``DispatchTracker`` hashes the abstract shape of
every operand at each dispatch, as the JAX package's does.

This is deliberately framework-free: it walks shapes via duck typing
(``.shape``/``.dtype``), so torch tensors, NumPy arrays and the host
oracles' operands all use the same tracker.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Set, Tuple

from .events import log_event
from .metrics import JIT_RECOMPILES

__all__ = ["DispatchTracker", "abstract_signature", "tree_nbytes"]


def abstract_signature(tree) -> Tuple:
    """Hashable (shape, dtype) skeleton of a pytree-ish value: arrays become
    ``("a", shape, dtype)``; containers/dataclasses recurse; scalars pass
    through (they are usually static or weakly-typed constants)."""
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return ("a", tuple(tree.shape), str(tree.dtype))
    if isinstance(tree, (list, tuple)):
        return tuple(abstract_signature(x) for x in tree)
    if isinstance(tree, dict):
        return tuple(
            (k, abstract_signature(tree[k])) for k in sorted(tree)
        )
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return tuple(
            abstract_signature(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
        )
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return type(tree).__name__


def tree_nbytes(tree) -> int:
    """Total array bytes in a pytree-ish value (same walk as above)."""
    if hasattr(tree, "nbytes") and hasattr(tree, "shape"):
        return int(tree.nbytes)
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(
            tree_nbytes(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
        )
    return 0


class DispatchTracker:
    """Per-module first-dispatch counter. One tracker per engine/backend
    module (the JAX package's jit caches are per function and process-wide,
    and the port keeps the same accounting, so instance-level tracking
    would double-count across engine instances)."""

    def __init__(self, engine: str) -> None:
        self.engine = engine
        self._seen: Dict[str, Set[Tuple]] = {}

    def track(
        self,
        fn: str,
        *operands,
        static: Tuple = (),
        cost: Optional[Callable[[], object]] = None,
    ) -> bool:
        """Record one dispatch of ``fn``; returns True (and bumps the
        counter) when this abstract signature is new.

        ``cost`` is an optional zero-arg closure returning the dispatch's
        analytic operation and byte counts (``observe/introspect.py``'s
        ``publish_compiled``), evaluated only when the signature is new AND
        introspection is enabled. It stands where the JAX package passes a
        ``lower=`` closure for XLA's cost analysis."""
        sig = (tuple(static), abstract_signature(operands))
        seen = self._seen.setdefault(fn, set())
        if sig in seen:
            return False
        seen.add(sig)
        JIT_RECOMPILES.labels(engine=self.engine, fn=fn).inc()
        log_event(
            "jit_recompile",
            engine=self.engine,
            fn=fn,
            signatures=len(seen),
        )
        if cost is not None:
            from .introspect import publish_compiled

            publish_compiled(self.engine, fn, cost, signature=sig)
        return True

    def signatures(self, fn: str) -> int:
        return len(self._seen.get(fn, ()))
