"""Generation-keyed device residency for the serving query plane.

The port of the packed half of ``kubernetes_verification_tpu.ops.
device_state`` (the dense half waits for the dense engine, ROADMAP §1 item 7):

* **Residency** — a ``DeviceQueryState`` snapshots the device operands the
  packed query twins (``ops/batched.py``) read for one engine generation.
  A packed state aliases the ``PackedIncrementalVerifier``'s resident maps
  and transfers nothing host→device.

* **Double-buffering** — ``DeviceStateCache`` keeps a *front* state (what
  query dispatches read) and one *retired* state (the previous front, kept
  for readers that grabbed it just before a flip). ``publish()`` flips a new
  state in with one attribute assignment; only when a state ages out of the
  retired slot are its *owned* buffers released.

The aliasing rule differs from the JAX package's. JAX donates the engine's
buffers on every mutation, so a stale generation's aliases are deleted and
raise when read. This engine updates its tensors IN PLACE, so an aliased
packed state sees every later diff: it is valid only for its own
generation, and the serving layer must order mutations and query dispatches
(one stream, one lock). The owned reach words (``with_reach_words``) are a
copy and keep their generation's values.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..resilience.errors import ServeError

__all__ = ["DeviceQueryState", "DeviceStateCache", "packed_query_state"]


@dataclass(frozen=True)
class DeviceQueryState:
    """Device operands for one engine generation.

    ``arrays`` maps operand names to tensors; ``owned`` names the subset this
    state made itself (released on retirement — everything else aliases
    live engine state)."""

    generation: int
    kind: str  # "packed"
    n: int  # real pod count (rows/cols beyond this are padding)
    arrays: Dict[str, Any]
    owned: Tuple[str, ...] = ()
    meta: Dict[str, Any] = field(default_factory=dict)

    def release(self) -> None:
        """Drop the owned tensors, so the caching allocator can reuse their
        memory once no reader holds them. Aliased engine tensors are left
        alone; a second release is harmless."""
        for name in self.owned:
            self.arrays.pop(name, None)


class DeviceStateCache:
    """Front/retired double buffer of :class:`DeviceQueryState`.

    Readers call :meth:`get` (one attribute read) and use the returned state
    for the whole batch. Writers build a shadow state and :meth:`publish`
    it; the flip retires the old front and releases the state that ages out
    of the retired slot, two flips after it stopped being current."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._front: Optional[DeviceQueryState] = None
        self._retired: Optional[DeviceQueryState] = None

    def get(self, generation: int) -> Optional[DeviceQueryState]:
        front = self._front  # single read — atomic under the GIL
        if front is not None and front.generation == generation:
            return front
        return None

    def peek(self) -> Optional[DeviceQueryState]:
        return self._front

    def retired(self) -> Optional[DeviceQueryState]:
        """The previous front (None before the second publish). Valid until
        the next :meth:`publish` ages it out — its owned reach words are the
        outgoing generation's, so the double buffer doubles as the
        generation-over-generation diff window."""
        return self._retired

    def publish(self, state: DeviceQueryState) -> DeviceQueryState:
        """Flip ``state`` in as the new front; returns it for chaining."""
        with self._lock:
            aged_out = self._retired
            self._retired = self._front
            self._front = state  # the atomic flip readers race against
        if aged_out is not None:
            aged_out.release()
        return state

    def clear(self) -> None:
        with self._lock:
            front, retired = self._front, self._retired
            self._front = None
            self._retired = None
        for state in (retired, front):
            if state is not None:
                state.release()


def packed_query_state(
    engine, generation: int, with_reach_words: bool = False
) -> DeviceQueryState:
    """Snapshot a ``PackedIncrementalVerifier``'s query operands.

    The six per-policy maps and counts, the column mask and the row validity
    are device-resident engine state: the snapshot aliases them all and
    transfers nothing. They follow the engine's later in-place diffs, so the
    state is valid for ``generation`` only.

    With ``with_reach_words`` the state also *owns* a device copy of the
    engine's packed words, which keeps this generation's values after later
    diffs (the posture diff window) — the one deliberate device→device copy.
    A matrix-free engine has no words: ``ServeError``."""
    (
        sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt,
    ) = engine._maps
    arrays = {
        "sel_ing8": sel_ing8,
        "sel_eg8": sel_eg8,
        "ing_by_pol": ing_by_pol,
        "eg_by_pol": eg_by_pol,
        "ing_cnt": ing_cnt,
        "eg_cnt": eg_cnt,
        "col_mask": engine._col_mask,
        "row_valid": engine._row_valid,
    }
    owned: Tuple[str, ...] = ()
    if with_reach_words:
        if engine._packed is None:
            raise ServeError(
                "packed engine is matrix-free (keep_matrix=False): no "
                "reach words to snapshot for posture"
            )
        arrays["reach_words"] = engine._packed.clone()
        owned = ("reach_words",)
    return DeviceQueryState(
        generation=generation,
        kind="packed",
        n=int(engine.n_pods),
        arrays=arrays,
        owned=owned,
        meta={
            "h2d_bytes": 0,
            "n_padded": int(engine._n_padded),
            "flags": dict(engine._flags),
        },
    )
