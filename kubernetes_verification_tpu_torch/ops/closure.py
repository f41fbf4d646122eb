"""Transitive closure, bounded path queries and popcounts over reachability.

The port of ``kubernetes_verification_tpu.ops.closure``. The dense closure
squares a bool ``[N, N]`` matrix ⌈log₂N⌉ times. The packed forms keep the
matrix as int32 words ``[N, N/32]`` (the reference's uint32 bit pattern)
throughout: each squaring runs as (dst stripe × row tile) int8 products
whose operands are unpacked transiently from the words, and the host loop
stops as soon as a squaring adds no pair.

Every product is an int8 ``torch._int_mm`` (``bool_dot``) with int32 counts,
exact for 0/1 operands. The JAX package computes the same products as XLA
dots outside any Pallas kernel, so no hand-written kernel belongs here.

torch has no popcount: a 256-entry byte table is gathered over a ``uint8``
view of the int32 words, a block of rows at a time so the gathered bytes
stay small at 100k pods. Per-row counts are int32 (a row holds < 2³¹ bits);
the total is summed in int64, exact at 100k² pairs.

Entry points compute on the device of the tensor they are given; host
(numpy) words go to ``device`` (default ``"cuda"``; raises without one).
``packed_closure``'s checkpoint/resume knobs commit and read closure pass
checkpoints through ``serve/durability.py``. Every loop drives a
``ProgressTicker`` (``observe/progress.py``) at its pass, round or level
boundaries and counts them in ``kvtpu_closure_iterations_total``,
``kvtpu_delta_closure_rounds_total`` and
``kvtpu_closure_bounded_levels_total``, as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..observe.introspect import maybe_publish
from ..observe.metrics import (
    CLOSURE_BOUNDED_LEVELS,
    CLOSURE_ITERATIONS,
    DELTA_CLOSURE_ROUNDS,
)
from ..observe.progress import ProgressTicker
from ..resilience.errors import ConfigError
from ..runtime import resolve_device
from .bits import (
    pack_bool_cols,
    to_host_words,
    unpack_cols,
    unpack_words_i8,
    unpack_words_t_i8,
)

__all__ = [
    "bool_dot",
    "transitive_closure",
    "path_upto",
    "packed_closure",
    "packed_closure_delta",
    "bounded_packed_closure",
    "bounded_closure_rows",
    "packed_row_counts",
    "packed_pair_total",
]

_I8 = torch.int8
_I32 = torch.int32

#: rows per popcount gather block: 4096 rows × 12,800 bytes ≈ 52 MB of
#: indices at 100k pods
_ROWS_PER_BLOCK = 4096

#: lhs rows unpacked at once by a frontier product (the K = N seeds of
#: ``path_upto`` on a packed 100k matrix would be 10 GB unpacked whole)
_ROW_BLOCK = 7168


# ---------------------------------------------------------------------------
# popcounts
# ---------------------------------------------------------------------------


def _byte_popcounts(device) -> torch.Tensor:
    """uint8 [256]: set bits of each byte value."""
    v = torch.arange(256, dtype=torch.int32, device=device)
    bits = (v[:, None] >> torch.arange(8, dtype=torch.int32, device=device)) & 1
    return bits.sum(dim=1).to(torch.uint8)


def packed_row_counts(
    packed: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """int32 [R]: set bits per row of an int32 [R, W] packed matrix; with
    ``mask`` (int32 [W]), of each row ANDed with the mask, a block of rows
    at a time (no masked copy of the whole matrix)."""
    table = _byte_popcounts(packed.device)
    out = torch.empty(packed.shape[0], dtype=torch.int32, device=packed.device)
    for r0 in range(0, packed.shape[0], _ROWS_PER_BLOCK):
        block = packed[r0 : r0 + _ROWS_PER_BLOCK]
        block = block.contiguous() if mask is None else block & mask[None, :]
        idx = block.view(torch.uint8).to(torch.int32)
        out[r0 : r0 + _ROWS_PER_BLOCK] = table[idx].sum(dim=1, dtype=torch.int32)
    return out


def packed_pair_total(packed: torch.Tensor) -> int:
    """Set bits of the whole matrix, summed in int64 (synchronises)."""
    return int(packed_row_counts(packed).sum(dtype=torch.int64).item())


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def bool_dot(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """int32 [M, D] = ``a · btᵀ`` for int8 0/1 operands ``a`` [M, K] and
    ``bt`` [D, K], both K-contiguous (the only fast int8 layout on Hopper).

    One ``torch._int_mm``. Its CUDA build takes M > 16 and K, D positive
    multiples of 8, so ``a`` gains zero rows up to 17, both operands zero
    columns up to a multiple of 8 (at least 8), and ``bt`` zero rows up to a
    multiple of 8; the counts are trimmed back to [M, D]. Zero rows and
    columns add nothing to any count. With introspection on, it publishes
    its exact ``2·M·K·D`` operations (``observe/introspect.py``)."""
    m, k = a.shape
    d = bt.shape[0]
    pm = max(17 - m, 0)
    pk = (-k) % 8 if k else 8
    pd = (-d) % 8 if d else 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pd or pk:
        bt = F.pad(bt, (0, pk, 0, pd))
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    maybe_publish(
        "closure", "bool_dot",
        lambda: {"flops": 2 * m * k * d, "bytes_accessed": (m + d) * k + 4 * m * d},
        (a, bt, a.device.type),
    )
    return out[:m, :d] if (pm or pd) else out


def _fit_tile(n: int, cap: int) -> int:
    """Largest multiple of 32 that divides ``n`` and is ≤ ``cap`` (``n`` is
    itself a multiple of 32, so 32 always qualifies)."""
    t = max(32, min(cap, n))
    t -= t % 32
    while t > 32 and n % t:
        t -= 32
    return t


def _packed_product(
    lhs: torch.Tensor, packed: torch.Tensor, *, row_tile: int, dst_tile: int
) -> torch.Tensor:
    """int32 [K, W]: the words of ``unpack(lhs) · unpack(packed) > 0``, i.e.
    row ``k`` is the OR of the rows of ``packed`` that row ``k`` of ``lhs``
    names. ``dst_tile`` divides N.

    The dst stripe is the outer loop: its ``[dst_tile, N]`` operand is
    unpacked once per stripe, already transposed (``unpack_words_t_i8``),
    so both operands of every product are K-contiguous. The lhs row blocks
    of ``row_tile`` rows are unpacked per (stripe, block) pair, as the JAX
    package's schedule does. Each output block depends only on the inputs,
    so the schedule cannot change a bit."""
    N, W = packed.shape
    K = lhs.shape[0]
    out = torch.empty((K, W), dtype=_I32, device=packed.device)
    for d0 in range(0, N, dst_tile):
        w0, w1 = d0 // 32, (d0 + dst_tile) // 32
        bt = unpack_words_t_i8(packed[:, w0:w1], dst_tile)  # int8 [dst_tile, N]
        for s0 in range(0, K, row_tile):
            a = unpack_words_i8(lhs[s0 : s0 + row_tile], N)  # int8 [rows, N]
            out[s0 : s0 + row_tile, w0:w1] = pack_bool_cols(bool_dot(a, bt) > 0)
        del bt
    return out


def _packed_square_step(
    packed: torch.Tensor, *, row_tile: int, dst_tile: int
) -> torch.Tensor:
    """One squaring-with-union pass on the packed matrix:
    ``out[s] = row_s ∨ (∨_{k ∈ row_s} row_k)``, as tiled int8 products of an
    unpacked row tile with an unpacked dst stripe (``_packed_product``).
    Unpack traffic per pass: N² bytes for the stripes, N³/dst_tile for the
    row tiles, which is why the stripe is wide."""
    out = _packed_product(packed, packed, row_tile=row_tile, dst_tile=dst_tile)
    return out.bitwise_or_(packed)


# ---------------------------------------------------------------------------
# argument handling
# ---------------------------------------------------------------------------


def _words(x, device=None) -> torch.Tensor:
    """Packed words as an int32 tensor. A tensor stays on its device unless
    ``device`` names another; host words (the reference's uint32, or
    int32) are copied to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    a = np.ascontiguousarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=resolve_device(device))


def _is_packed(x) -> bool:
    """Packed words: an int32 tensor (the port's word type) or a host
    uint32 array (the reference's)."""
    if isinstance(x, torch.Tensor):
        return x.dtype == _I32
    return hasattr(x, "dtype") and np.asarray(x).dtype == np.uint32


def _check_square(N: int, W: int) -> None:
    if N != W * 32:
        raise ConfigError(
            f"packed matrix must be square in bits ([{N}, {N}/32]); "
            f"got [{N}, {W}]"
        )


# ---------------------------------------------------------------------------
# dense and packed closures
# ---------------------------------------------------------------------------


def transitive_closure(reach, *, device=None) -> torch.Tensor:
    """bool[N, N] → its transitive closure (edges composed any number of
    times; the diagonal is NOT added unless already present): ⌈log₂N⌉
    squarings ``r | (r · r > 0)``, each one ``bool_dot`` with exact int32
    counts. A tensor is closed on its device, a host array on ``device``."""
    r = reach if isinstance(reach, torch.Tensor) else torch.as_tensor(
        np.asarray(reach), device=resolve_device(device)
    )
    r = r.to(torch.bool)
    n = r.shape[0]
    if n == 0:
        return r.clone()
    steps = max(1, math.ceil(math.log2(max(n, 2))))
    for _ in range(steps):
        r8 = r.to(_I8)
        r = r | (bool_dot(r8, r8.t().contiguous()) > 0)
    return r


def packed_closure(
    packed,
    *,
    tile: int = 7168,
    max_iter: int = 32,
    dst_tile: int = 14336,
    device=None,
    on_pass: Optional[Callable[[int, torch.Tensor, int], None]] = None,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> torch.Tensor:
    """Transitive closure of a bit-packed reachability matrix (int32
    ``[Np, Np/32]``, Np a multiple of 32, pad bits zero: every one of the Np
    bit positions is treated as a node). Returns the packed closure, an
    int32 tensor on the input's device. The host loop squares until a pass
    adds no reachable pair (total popcount, which is monotone, so equality
    means fixpoint), capped at ``max_iter``.

    ``tile`` caps the row tile, ``dst_tile`` the dst stripe; both snap down
    to the largest 32-multiple divisor of Np, as in the JAX package, so the
    port runs the same schedule. ``on_pass(pass, packed, pairs)`` is called
    after each pass, once its pair count has been read.

    With ``checkpoint_dir`` set and ``checkpoint_every`` > 0, every
    ``checkpoint_every``-th pass commits an atomic closure checkpoint (the
    words as the reference's uint32, the pass counter and the pair count)
    through ``CheckpointManager.checkpoint_closure``; ``resume=True``
    restarts from the newest valid one, at its pass count (from the given
    ``packed`` at pass 0 when the ladder is empty or damaged), so a killed
    closure re-runs only the passes after its last checkpoint. A closure
    checkpoint of either package resumes in the other.

    The loop drives a ``ProgressTicker`` (job ``packed_closure``, total =
    the ⌈log₂N⌉ pass bound, so an early fixpoint finishes ``converged``
    below fraction 1.0); its pass-boundary callback is the one that commits
    the checkpoints and calls ``on_pass``."""
    packed = _words(packed, device)
    N, W = packed.shape
    _check_square(N, W)
    if N == 0:
        return packed
    start_pass = 0
    cm = None
    if checkpoint_dir:
        from ..resilience.errors import PersistError
        from ..serve.durability import CheckpointManager, load_closure_checkpoint

        cm = CheckpointManager(checkpoint_dir)
        if resume:
            try:
                arr, start_pass, _manifest = load_closure_checkpoint(checkpoint_dir)
                if tuple(arr.shape) != (N, W):
                    raise ConfigError(
                        f"closure checkpoint shape {tuple(arr.shape)} != "
                        f"input shape {(N, W)}"
                    )
                packed = _words(arr, packed.device)
            except PersistError:
                start_pass = 0
    t = _fit_tile(N, tile)
    dt = _fit_tile(N, dst_tile)
    total = packed_pair_total(packed)
    state = {"packed": packed, "pairs": total}

    def pass_done(done: int) -> None:
        if on_pass is not None:
            on_pass(done, state["packed"], state["pairs"])
        if cm is not None and checkpoint_every > 0 and done % checkpoint_every == 0:
            cm.checkpoint_closure(state["packed"], done, pairs=state["pairs"])

    bound = max(1, math.ceil(math.log2(max(N, 2))))
    ticker = ProgressTicker(
        "packed_closure",
        total=min(bound, max_iter) if max_iter else bound,
        unit="pass",
        initial=start_pass,
        on_pass=pass_done,
    )
    converged = False
    try:
        for _ in range(start_pass, max_iter):
            CLOSURE_ITERATIONS.inc()
            packed = _packed_square_step(packed, row_tile=t, dst_tile=dt)
            new_total = packed_pair_total(packed)
            state["packed"], state["pairs"] = packed, new_total
            ticker.tick(pairs=new_total)
            if new_total == total:
                converged = True
                break
            total = new_total
    except BaseException:
        ticker.finish("error")
        raise
    ticker.finish("converged" if converged else "done", pairs=total)
    return packed


# ---------------------------------------------------------------------------
# delta closure
# ---------------------------------------------------------------------------


def _closure_rows_step(
    packed: torch.Tensor, rows: torch.Tensor, *, tile: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One squaring pass restricted to the gathered ``rows``:
    ``new_s = row_s ∨ (∨_{k ∈ row_s} row_k)``, written into ``packed`` in
    place (the caller owns it); returns it and a per-gathered-row changed
    flag. Duplicate pad rows write identical values, so the scatter is
    exact. ``tile`` is the dst stripe."""
    old = packed[rows]  # [K, W]
    merged = _packed_product(old, packed, row_tile=_ROW_BLOCK, dst_tile=tile)
    merged.bitwise_or_(old)
    changed = (merged != old).any(dim=1)
    packed[rows] = merged
    return packed, changed


def _rows_touching(packed: torch.Tensor, cmask: torch.Tensor) -> torch.Tensor:
    """bool [N]: rows whose bit set intersects the packed node mask."""
    return ((packed & cmask[None, :]) != 0).any(dim=1)


def _rows_differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a != b).any(dim=1)


def _delta_seed(prev, base, suspect: torch.Tensor) -> torch.Tensor:
    """suspect rows restart from the new base; the rest keep the previous
    closure (a valid lower bound — none of their paths touch a dirty node)
    ∨ the new base."""
    return torch.where(suspect[:, None], 0, prev) | base


def _any_removed(prev_base, new_base) -> bool:
    # kvtpu: ignore[jit-host-sync] the eager driver branches on this flag next; read here or in the caller, it is the same one sync
    return bool((prev_base & ~new_base).any())


def _add_edges_round(
    C: torch.Tensor, added: torch.Tensor, rows: torch.Tensor, *, tile: int
) -> torch.Tensor:
    """One ``C ∨ C⁺·A·C⁺`` round for added edges ``A`` = the bits of
    ``added`` in base rows ``rows`` (C reflexively, so endpoints of an
    A-edge need no C-hop on either side), written into ``C`` in place (the
    caller owns it; every stripe's update reads only ``L`` and ``R``, made
    before the loop). Captures every path using exactly one A-edge; the
    caller iterates for multi-A-edge paths."""
    N, W = C.shape
    a_rows = added[rows]  # [d, W]
    # R[j] = descendants after taking an A-edge out of rows[j] (incl. the
    # A-edge targets themselves)
    R = _packed_product(a_rows, C, row_tile=_ROW_BLOCK, dst_tile=tile)
    R.bitwise_or_(a_rows)
    # L[s, j] = s reaches rows[j] (or IS it): C's bit-columns at the rows;
    # an int32 word sign-extends on >>, hence the & 1
    w = rows // 32
    b = (rows % 32).to(_I32)
    L = ((C[:, w] >> b[None, :]) & 1).to(_I8)
    L = torch.maximum(
        L, (torch.arange(N, device=C.device)[:, None] == rows[None, :]).to(_I8)
    )  # int8 [N, d]
    r8t = unpack_words_t_i8(R, N)  # int8 [N, d]: unpack(R)ᵀ
    for d0 in range(0, N, tile):
        counts = bool_dot(L, r8t[d0 : d0 + tile])  # [N, tile]
        C[:, d0 // 32 : (d0 + tile) // 32] |= pack_bool_cols(counts > 0)
    return C


def _rows_any(packed: torch.Tensor) -> torch.Tensor:
    return (packed != 0).any(dim=1)


def _padded_group(g: np.ndarray, kg: int, device) -> torch.Tensor:
    """A row group padded to ``kg`` rows by repeating its last row."""
    idx = np.concatenate([g, np.repeat(g[-1:], kg - len(g))])
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def packed_closure_delta(
    new_base,
    prev_closure,
    dirty,
    *,
    prev_base=None,
    tile: int = 7168,
    max_iter: int = 64,
    row_group: int = 2048,
    device=None,
) -> torch.Tensor:
    """Closure AFTER a diff — bit-for-bit ``packed_closure(new_base)``,
    seeded from the closure of the pre-diff matrix.

    ``dirty``: bool [N] node mask — every node whose base ROW or COLUMN may
    differ between ``prev_closure``'s base and ``new_base``. With
    ``prev_base`` (the base ``prev_closure`` was computed from) and no base
    bit cleared, the additions-only route runs: ``C ∨ C⁺·A·C⁺`` rounds over
    the rows that gained base bits, until a round adds no pair. Otherwise
    the suspect route: rows whose previous closure row reaches a dirty node
    (or are dirty) restart from the new base, the rest keep their previous
    closure row (a valid lower bound), and a frontier of changed rows is
    re-squared until nothing changes; when more than half the rows are
    suspect, a full ``packed_closure`` from that seed runs instead.

    Computes on ``new_base``'s device (host words go to ``device``)."""
    new_base = _words(new_base, device)
    dev = new_base.device
    prev = _words(prev_closure, dev)
    N, W = new_base.shape
    if tuple(prev.shape) != (N, W):
        raise ConfigError(
            f"previous closure shape {tuple(prev.shape)} != base shape {(N, W)}"
        )
    dirty = np.asarray(dirty, dtype=bool)
    if dirty.shape != (N,):
        raise ConfigError(f"dirty mask must be bool [{N}]")
    # ``t`` is the ROW tile of the dense-suspect fallback's full squaring;
    # the frontier steps take their own dst stripes: ``_add_edges_round``'s
    # counts are [N, stripe] int32, so its stripe is narrow
    t = _fit_tile(N, tile)
    dstt = _fit_tile(N, 14336)
    dstt_add = _fit_tile(N, 2048)
    kg = max(32, min(row_group, N))

    def pack_mask(m: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.packbits(m, bitorder="little").view("<i4").copy(), device=dev
        )

    if prev_base is not None:
        prev_base = _words(prev_base, dev)
    if prev_base is not None and not _any_removed(prev_base, new_base):
        # ADDITIONS ONLY: closure over C ∨ A is C ∨ C⁺·A·C⁺ iterated
        added = new_base & ~prev_base
        rows_np = np.nonzero(_rows_any(added).cpu().numpy())[0]
        C = prev | new_base
        if not len(rows_np):
            return C
        total = packed_pair_total(C)
        with ProgressTicker("packed_closure_delta", unit="round") as ticker:
            for _ in range(max_iter):
                DELTA_CLOSURE_ROUNDS.inc()
                for i in range(0, len(rows_np), kg):
                    idx = _padded_group(rows_np[i : i + kg], kg, dev)
                    C = _add_edges_round(C, added, idx, tile=dstt_add)
                new_total = packed_pair_total(C)
                ticker.tick(pairs=new_total)
                if new_total == total:
                    break
                total = new_total
        return C
    # removals present: rows whose old paths may route through a touched
    # node restart from the base (suspect analysis)
    suspect = _rows_touching(prev, pack_mask(dirty)).cpu().numpy() | dirty
    seed = _delta_seed(prev, new_base, torch.as_tensor(suspect, device=dev))
    if suspect.sum() * 2 > N:
        # most rows are suspect (densely-connected graph): run the plain
        # squaring from the (still valid, nearly-closed) seed instead
        return packed_closure(seed, tile=t, max_iter=max_iter)
    changed = _rows_differ(seed, prev).cpu().numpy()
    packed = seed
    with ProgressTicker("packed_closure_delta", unit="round") as ticker:
        for _ in range(max_iter):
            if not changed.any():
                break
            DELTA_CLOSURE_ROUNDS.inc()
            frontier = (
                _rows_touching(packed, pack_mask(changed)).cpu().numpy() | changed
            )
            rows = np.nonzero(frontier)[0]
            nxt = np.zeros(N, dtype=bool)
            for i in range(0, len(rows), kg):
                g = rows[i : i + kg]
                packed, ch = _closure_rows_step(
                    packed, _padded_group(g, kg, dev), tile=dstt
                )
                nxt[g] |= ch.cpu().numpy()[: len(g)]
            changed = nxt
            ticker.tick(frontier_rows=int(len(rows)))
    return packed


# ---------------------------------------------------------------------------
# bounded closures and path queries
# ---------------------------------------------------------------------------


def _bounded_frontier_step(
    packed: torch.Tensor, frontier: torch.Tensor, *, tile: int
) -> torch.Tensor:
    """One BFS layer for ``K`` packed frontier rows: ``nxt[k, d] = ∃j
    frontier[k, j] ∧ packed[j, d]`` — ``[≤_ROW_BLOCK, N]`` int8 products
    against unpacked dst stripes, never an N×N transient. ``tile`` is the
    dst stripe (a 32-multiple divisor of N)."""
    return _packed_product(frontier, packed, row_tile=_ROW_BLOCK, dst_tile=tile)


def bounded_packed_closure(
    packed,
    seeds,
    *,
    hops=None,
    tile: int = 14336,
    want_hops: bool = True,
    device=None,
):
    """Bounded multi-source closure over a packed matrix: BFS by layers from
    ``seeds`` (int [K] row indices). Returns ``(acc, hop)``: ``acc`` the
    packed int32 ``[K, W]`` reach-within-``hops`` rows on the matrix's
    device (``hops=None`` runs to the fixpoint — the closure rows of the
    seeds), ``hop`` an int32 numpy ``[K, N]`` shortest-hop-count matrix (0 =
    unreachable; a self-loop edge gives ``hop[k, seeds[k]] = 1``), or
    ``None`` when ``want_hops=False``.

    Layer ``l`` of the BFS is exactly the set first reached at shortest
    distance ``l``, so ``acc`` equals the ∨ of the first ``hops`` boolean
    matrix powers, bit for bit."""
    packed = _words(packed, device)
    N, W = packed.shape
    _check_square(N, W)
    seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
    if len(seeds) and (seeds.min() < 0 or seeds.max() >= N):
        raise ConfigError(f"seeds outside [0, {N})")
    if N == 0 or len(seeds) == 0:
        empty = torch.zeros((len(seeds), W), dtype=_I32, device=packed.device)
        hop = np.zeros((len(seeds), N), np.int32) if want_hops else None
        return empty, hop
    t = _fit_tile(N, tile)
    acc = packed[torch.as_tensor(seeds, device=packed.device)]
    frontier = acc
    hop = None
    if want_hops:
        hop = np.zeros((len(seeds), N), np.int32)
        fresh_np = unpack_cols(to_host_words(acc), N)
        hop[fresh_np] = 1
        any_fresh = bool(fresh_np.any())
    else:
        any_fresh = bool((frontier != 0).any())
    level = 1
    limit = int(hops) if hops is not None else N
    with ProgressTicker(
        "bounded_closure",
        total=limit if hops is not None else None,
        unit="level",
        initial=1,
    ) as ticker:
        while any_fresh and level < limit:
            CLOSURE_BOUNDED_LEVELS.inc()
            nxt = _bounded_frontier_step(packed, frontier, tile=t)
            fresh = nxt & ~acc
            acc = acc | fresh
            frontier = fresh
            level += 1
            if want_hops:
                fresh_np = unpack_cols(to_host_words(fresh), N)
                hop[fresh_np] = level
                any_fresh = bool(fresh_np.any())
            else:
                any_fresh = bool((fresh != 0).any())
            ticker.tick(level)
    return acc, hop


def bounded_closure_rows(
    row_fn,
    seeds,
    n: int,
    *,
    hops=None,
    chunk: int = 2048,
    device=None,
):
    """Bounded multi-source closure over a ROW ORACLE — the matrix-free
    form. ``row_fn(idx)`` must return the one-step reach rows
    ``bool [len(idx), n]`` (a tensor, or anything ``np.asarray`` takes) for
    the given numpy source indices. The BFS runs on ``device`` (default
    ``"cuda"``; raises without one): only ``[K, n]`` state plus a
    ``[≤chunk, n]`` transient per oracle call is ever held — never N×N.

    Returns numpy ``(acc, hop)``: ``acc`` bool ``[K, n]`` (destinations
    reachable from each seed within ``hops`` edges; ``hops=None`` = closure
    rows), ``hop`` int32 ``[K, n]`` shortest hop counts (0 =
    unreachable)."""
    seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
    K = len(seeds)
    if K and (seeds.min() < 0 or seeds.max() >= n):
        raise ConfigError(f"seeds outside [0, {n})")
    dev = resolve_device(device)
    if K == 0 or n == 0:
        return np.zeros((K, n), bool), np.zeros((K, n), np.int32)

    def rows(idx: np.ndarray) -> torch.Tensor:
        r = row_fn(idx)
        r = r if isinstance(r, torch.Tensor) else torch.as_tensor(np.asarray(r))
        return r.to(device=dev, dtype=torch.bool).reshape(len(idx), n)

    acc = rows(seeds)
    hop = acc.to(_I32)
    frontier = acc
    level = 1
    limit = int(hops) if hops is not None else n
    with ProgressTicker(
        "bounded_closure_rows",
        total=limit if hops is not None else None,
        unit="level",
        initial=1,
    ) as ticker:
        while bool(frontier.any()) and level < limit:
            CLOSURE_BOUNDED_LEVELS.inc()
            # nodes on any seed's frontier; their rows are fetched once and
            # OR-combined per seed by a [K, c] × [c, n] int8 product, chunked
            # so the oracle transient stays bounded
            U = np.nonzero(frontier.any(dim=0).cpu().numpy())[0]
            nxt = torch.zeros((K, n), dtype=torch.bool, device=dev)
            for i in range(0, len(U), chunk):
                u = U[i : i + chunk]
                rt = rows(u).to(_I8).t().contiguous()  # [n, c]: K-contiguous
                memb = frontier[:, torch.as_tensor(u, device=dev)].to(_I8)  # [K, c]
                nxt |= bool_dot(memb, rt) > 0
            fresh = nxt & ~acc
            acc = acc | fresh
            hop[fresh] = level + 1
            frontier = fresh
            level += 1
            ticker.tick(level)
    return acc.cpu().numpy(), hop.cpu().numpy()


def path_upto(reach, hops: int, *, device=None):
    """Paths of length ≤ ``hops`` — ``hops=2`` reproduces the reference's
    ``path`` exactly — through the bounded closure seeded at every row.

    Answers in kind: packed words in (an int32 tensor or host uint32) give
    packed int32 words out; a dense ``[N, N]`` matrix in gives a dense bool
    tensor out. The diagonal is NOT added unless already present. Tensors
    are computed on their device, host arrays on ``device``."""
    if _is_packed(reach):
        packed = _words(reach, device)
        n = packed.shape[0]
        if hops <= 1 or n == 0:
            return packed
        acc, _ = bounded_packed_closure(
            packed, np.arange(n), hops=hops, want_hops=False
        )
        return acc
    dense = reach if isinstance(reach, torch.Tensor) else torch.as_tensor(
        np.asarray(reach), device=resolve_device(device)
    )
    n = dense.shape[0]
    if hops <= 1 or n == 0:
        return dense
    pad = (-n) % 32
    padded = F.pad(dense.to(torch.bool), (0, pad, 0, pad))
    acc, _ = bounded_packed_closure(
        pack_bool_cols(padded), np.arange(n), hops=hops, want_hops=False
    )
    return unpack_words_i8(acc, n + pad)[:, :n].to(torch.bool)


# Kernel-manifest registration (observe/aot.py): rebind the dispatch
# functions so their dispatch keys reach the warm pack's manifest; call
# sites above are unchanged (late binding).
from ..observe.aot import register_kernel as _register_kernel  # noqa: E402

_packed_square_step = _register_kernel(
    "closure", "_packed_square_step", _packed_square_step,
    static_argnames=("row_tile", "dst_tile"),
)
_closure_rows_step = _register_kernel(
    "closure", "_closure_rows_step", _closure_rows_step,
    static_argnames=("tile",),
)
_rows_touching = _register_kernel("closure", "_rows_touching", _rows_touching)
_rows_differ = _register_kernel("closure", "_rows_differ", _rows_differ)
_delta_seed = _register_kernel("closure", "_delta_seed", _delta_seed)
_any_removed = _register_kernel("closure", "_any_removed", _any_removed)
_add_edges_round = _register_kernel(
    "closure", "_add_edges_round", _add_edges_round, static_argnames=("tile",)
)
_rows_any = _register_kernel("closure", "_rows_any", _rows_any)
_bounded_frontier_step = _register_kernel(
    "closure", "_bounded_frontier_step", _bounded_frontier_step,
    static_argnames=("tile",),
)
