"""Generation-keyed device residency for the serving query plane.

The port of ``kubernetes_verification_tpu.ops.device_state``, both halves:

* **Residency** — a ``DeviceQueryState`` snapshots the device operands the
  query twins (``ops/batched.py``) read for one engine generation. A
  *dense* state (``dense_query_state``) aliases the ``IncrementalVerifier``'s
  count matrices and owns freshly uploaded int32 isolation vectors (the
  engine keeps those on the host: the one host→device transfer). A
  *packed* state (``packed_query_state``) aliases the
  ``PackedIncrementalVerifier``'s resident maps and transfers nothing.
  Either may also own a packed copy of the generation's reach words for the
  posture diffs (``with_reach_words``).

* **Double-buffering** — ``DeviceStateCache`` keeps a *front* state (what
  query dispatches read) and one *retired* state (the previous front, kept
  for readers that grabbed it just before a flip). ``publish()`` flips a new
  state in with one attribute assignment; only when a state ages out of the
  retired slot are its *owned* buffers released.

The aliasing rule differs from the JAX package's. JAX donates the engines'
buffers on every mutation, so a stale generation's aliases are deleted and
raise when read. This package's engines update their tensors IN PLACE — the
dense engine its count matrices, the packed engine its maps and words — so
an aliased state sees every later diff: it is valid only for its own
generation, and the serving layer must order mutations and query dispatches
(one stream, one lock). The owned isolation vectors and reach words are
copies and keep their generation's values.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..observe.metrics import DEVICE_STATE_FLIPS_TOTAL, QUERY_H2D_BYTES_TOTAL
from ..resilience.errors import ServeError
from ..resilience.retry import retry_transient
from .batched import _reach_rows_kernel
from .bits import pack_bool_cols

__all__ = [
    "DeviceQueryState",
    "DeviceStateCache",
    "dense_query_state",
    "packed_query_state",
]

#: source rows per block of the dense reach words (bounds the pack's int32
#: temporaries: 2,048 rows × 32,768 pods is 268 MB)
_WORD_ROWS = 2048


@dataclass(frozen=True)
class DeviceQueryState:
    """Device operands for one engine generation.

    ``arrays`` maps operand names to tensors; ``owned`` names the subset this
    state made itself (released on retirement — everything else aliases
    live engine state)."""

    generation: int
    kind: str  # "dense" | "packed"
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
        DEVICE_STATE_FLIPS_TOTAL.labels(kind=state.kind).inc()
        return state

    def clear(self) -> None:
        with self._lock:
            front, retired = self._front, self._retired
            self._front = None
            self._retired = None
        for state in (retired, front):
            if state is not None:
                state.release()


def _upload_i32(vec, device) -> Tuple[torch.Tensor, int]:
    """Host int vector → int32 tensor on ``device``; returns (tensor, h2d
    bytes)."""
    host = np.asarray(vec, dtype=np.int32)
    return torch.as_tensor(host, device=device), host.nbytes


def _dense_reach_words(engine, ing_iso, eg_iso) -> torch.Tensor:
    """The dense engine's reach as int32 words ``[n, ceil32(n)]`` (the
    reference's little bit order; bits past column n zero), derived from the
    count matrices and the int32 isolation counts ``ing_iso``/``eg_iso`` on
    the engine's device, a block of rows at a time, and packed there. The
    JAX package derives the bool matrix, copies it to the host and packs it
    there; the words are the same, and no [N, N] bool matrix crosses the
    bus."""
    counts = (engine._ing_count, engine._eg_count)
    n = int(counts[0].shape[0])
    width = max(1, -(-n // 32)) * 32
    dev = counts[0].device
    flags = dict(
        self_traffic=engine.config.self_traffic,
        default_allow_unselected=engine.config.default_allow_unselected,
    )
    out = torch.empty((n, width // 32), dtype=torch.int32, device=dev)
    for r0 in range(0, n, _WORD_ROWS):
        src = torch.arange(r0, min(n, r0 + _WORD_ROWS), device=dev)
        rows = _reach_rows_kernel(*counts, ing_iso, eg_iso, src, **flags)
        out[r0 : r0 + src.shape[0]] = pack_bool_cols(F.pad(rows, (0, width - n)))
    return out


def dense_query_state(
    engine, generation: int, with_reach_words: bool = False
) -> DeviceQueryState:
    """Snapshot a dense ``IncrementalVerifier``'s query operands.

    The count matrices already live on the device: the snapshot aliases
    them, and they follow the engine's later in-place diffs, so the state is
    valid for ``generation`` only. The isolation vectors are host state of
    the dense engine: they are uploaded once here and owned.

    With ``with_reach_words`` the state also owns the generation's reach as
    packed words (``_dense_reach_words``), so the retired slot of the double
    buffer holds the previous generation's exact posture; the engine adopts
    the same words as its clean reach (``adopt_reach_words``), as the JAX
    package's engine holds the reach it derived for them."""
    h2d = 0
    ing_iso, nb = _upload_i32(engine._ing_iso, engine.device)
    h2d += nb
    eg_iso, nb = _upload_i32(engine._eg_iso, engine.device)
    h2d += nb
    arrays = {
        "ing_count": engine._ing_count,
        "eg_count": engine._eg_count,
        "ing_iso": ing_iso,
        "eg_iso": eg_iso,
    }
    owned = ["ing_iso", "eg_iso"]
    if with_reach_words:
        # the JAX package's words come from the engine's retried
        # derivation: a fault here is classified and retried the same way
        arrays["reach_words"] = retry_transient(
            lambda: _dense_reach_words(engine, ing_iso, eg_iso),
            policy=engine.retry_policy,
            backend="dense",
        )
        owned.append("reach_words")
        engine.adopt_reach_words(arrays["reach_words"])
    if h2d:
        QUERY_H2D_BYTES_TOTAL.labels(kind="dense").inc(h2d)
    return DeviceQueryState(
        generation=generation,
        kind="dense",
        n=int(engine._ing_count.shape[0]),
        arrays=arrays,
        owned=tuple(owned),
        meta={"h2d_bytes": h2d},
    )


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
