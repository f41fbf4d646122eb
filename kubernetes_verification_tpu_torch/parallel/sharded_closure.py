"""Mesh-sharded transitive closure: the path-query engine at scale-out.

The port of ``kubernetes_verification_tpu.parallel.sharded_closure``.
``packed_closure`` (``ops/closure.py``) holds both packed matrices and the
unpacked product operands on one device; this module distributes the same
squaring over the ``(pods, grants)`` mesh with row-stripe ownership:

* each of the ``dp`` ranks on ``pods`` owns an ``[N/dp, W]`` packed row
  stripe of the matrix, across passes — stripes never move;
* the ``mp`` ranks on ``grants`` split the **destination** axis: member
  ``g`` computes the output word columns of its ``N/mp`` dst range, so a
  pass's products divide by the full ``dp·mp`` rank count;
* per dst tile, the operand is the whole matrix's column block — the
  stripes' word slices gathered over ``pods``, unpacked transiently to int8
  (already transposed, K-contiguous) as the one-device pass does;
* the grant members' outputs cover disjoint word ranges, so an int32 sum
  over ``grants`` is the bitwise OR, and the host loop stops on a change
  flag summed over every rank (the one host sync of a pass).

The pre-flight memory guard (:func:`check_closure_budget`) estimates the
per-rank working set from ``(N, W, tile, D)`` and refuses with guidance —
shard wider, use the bounded multi-source closure, or lower the tile caps —
before any device work.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ..observe.metrics import (
    CLOSURE_ITERATIONS,
    CLOSURE_SHARDED_ITERATIONS,
    CLOSURE_STRIPE_ROWS,
    HBM_GUARD_REFUSALS,
)
from ..observe.progress import ProgressTicker
from ..ops.bits import pack_bool_cols, unpack_words_i8, unpack_words_t_i8
from ..ops.closure import _fit_tile, bool_dot
from ..resilience.errors import ConfigError, PersistError
from .mesh import BOTH, GRANT_AXIS, POD_AXIS, Mesh, all_gather, psum, rank_slice

__all__ = [
    "ClosureBudgetError",
    "estimate_closure_hbm",
    "check_closure_budget",
    "sharded_packed_closure",
]

_I32 = torch.int32

#: env override for the per-device closure budget (bytes): forces refusals
#: in tests, and declares the budget where the device reports none (the CPU)
_LIMIT_ENV = "KVTPU_HBM_LIMIT_BYTES"


class ClosureBudgetError(ConfigError):
    """The closure pre-flight guard refused dispatch: the estimated
    per-device working set exceeds the memory budget. Carries the estimate
    so callers can render the guidance. Exit-code contract: input/config
    error (2) — fixed by changing the geometry, not by retrying."""

    def __init__(self, message: str, *, estimate: Optional[dict] = None):
        super().__init__(message)
        self.estimate = estimate or {}


def estimate_closure_hbm(
    n: int,
    *,
    row_tile: int,
    dst_tile: int,
    n_devices: int = 1,
    grant_devices: int = 1,
) -> dict:
    """Per-device working-set estimate (bytes) of one sharded squaring pass
    at ``N=n`` over ``dp=n_devices`` row stripes and ``mp=grant_devices``
    dst ranges (the JAX package's formula, unchanged):

    - ``stripe``: the owned packed rows, ``(N/dp)·(N/32)·4`` — held twice
      (input stripe + accumulating output) plus once more for the sum over
      ``grants``;
    - ``gather``: the gathered packed dst column block, ``N·dst_tile/8``;
    - ``b``: its transient int8 unpack, ``N·dst_tile``;
    - ``a``: the unpacked row tile, ``row_tile·N``;
    - ``counts``: the int32 product, ``4·row_tile·dst_tile``.

    ``n_devices=1, grant_devices=1`` prices the one-device ``packed_closure``
    (the stripe is the whole matrix)."""
    n = int(n)
    dp = max(1, int(n_devices))
    mp = max(1, int(grant_devices))
    w_bytes = (n // 32) * 4
    stripe = -(-n // dp) * w_bytes
    gather = n * (dst_tile // 32) * 4
    b = n * dst_tile
    a = row_tile * n
    counts = 4 * row_tile * dst_tile
    total = 3 * stripe + gather + b + a + counts
    return {
        "n": n,
        "n_devices": dp,
        "grant_devices": mp,
        "row_tile": int(row_tile),
        "dst_tile": int(dst_tile),
        "stripe_bytes": stripe,
        "gather_bytes": gather,
        "b_bytes": b,
        "a_bytes": a,
        "counts_bytes": counts,
        "total_bytes": total,
    }


def _device_budget(device=None) -> Optional[int]:
    """The per-device byte budget: ``KVTPU_HBM_LIMIT_BYTES`` when set, else
    what the CUDA device can still allocate (``torch.cuda.mem_get_info``'s
    free bytes plus what PyTorch's allocator holds unused), else ``None`` —
    no implicit budget on the CPU, so CPU runs never false-refuse."""
    env = os.environ.get(_LIMIT_ENV)
    if env:
        try:
            return int(float(env))
        except ValueError:
            raise ConfigError(f"{_LIMIT_ENV}={env!r} is not a byte count") from None
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)


def check_closure_budget(
    n: int,
    *,
    row_tile: int,
    dst_tile: int,
    n_devices: int = 1,
    grant_devices: int = 1,
    limit_bytes: Optional[int] = None,
    device=None,
) -> dict:
    """Pre-flight memory guard: estimate the closure working set and raise
    :class:`ClosureBudgetError` with guidance when it exceeds the budget
    (``limit_bytes``, else the env / the device's — see
    :func:`_device_budget`; no budget means no refusal). Returns the
    estimate on acceptance. Counts ``kvtpu_hbm_guard_refusals_total`` on
    refusal."""
    est = estimate_closure_hbm(
        n, row_tile=row_tile, dst_tile=dst_tile, n_devices=n_devices,
        grant_devices=grant_devices,
    )
    limit = limit_bytes if limit_bytes is not None else _device_budget(device)
    est["limit_bytes"] = limit
    if limit is None or est["total_bytes"] <= limit:
        return est
    HBM_GUARD_REFUSALS.inc()
    gb = 1e9
    # guidance: each suggestion re-prices the dominant terms
    wider = estimate_closure_hbm(
        n, row_tile=row_tile, dst_tile=dst_tile, n_devices=2 * n_devices,
        grant_devices=grant_devices,
    )["total_bytes"]
    lower_cap = max(32, ((limit // max(3 * n, 1)) // 32) * 32)
    raise ClosureBudgetError(
        f"closure refused pre-flight: estimated working set "
        f"{est['total_bytes'] / gb:.2f} GB/device exceeds the "
        f"{limit / gb:.2f} GB budget at N={n}, row_tile={row_tile}, "
        f"dst_tile={dst_tile}, devices={n_devices}x{grant_devices} "
        f"(stripe {3 * est['stripe_bytes'] / gb:.2f} GB, dst transients "
        f"{(est['gather_bytes'] + est['b_bytes']) / gb:.2f} GB, row tile "
        f"{est['a_bytes'] / gb:.2f} GB). Options: (1) shard wider — "
        f"{2 * n_devices} row-stripe devices brings it to "
        f"{wider / gb:.2f} GB/device; (2) use the bounded multi-source "
        f"closure (seed the rows of interest — serve path_exists/hops, "
        f"ops.closure.bounded_packed_closure) which never holds N x N; "
        f"(3) lower the tile caps (try tile/dst_tile <= {lower_cap}) to "
        f"shrink the unpacked transients.",
        estimate=est,
    )


def _sharded_square_local(
    mesh: Mesh, stripe: torch.Tensor, *, n_total: int, row_tile: int, dst_tile: int
):
    """One squaring-with-union pass on this rank's packed row stripe: the
    grant member computes its own ``N/mp`` dst word range; contributions
    land in disjoint word columns, so the sum over ``grants`` is the OR.
    Returns the updated stripe and the change count summed over every
    rank."""
    n_loc, W = stripe.shape
    N = n_total
    mp = mesh.shape[GRANT_AXIS]
    cols_per_dev = N // mp
    sq = torch.zeros_like(stripe)
    for dt in range(cols_per_dev // dst_tile):
        d0 = mesh.coords[GRANT_AXIS] * cols_per_dev + dt * dst_tile
        w0, w1 = d0 // 32, (d0 + dst_tile) // 32
        # the dst operand is the WHOLE matrix's column block: each stripe's
        # word slice gathered over ``pods``, unpacked transposed
        col_full = all_gather(mesh, stripe[:, w0:w1], POD_AXIS, dim=0)
        bt = unpack_words_t_i8(col_full, dst_tile)  # int8 [dst_tile, N]
        del col_full
        for s0 in range(0, n_loc, row_tile):
            a = unpack_words_i8(stripe[s0 : s0 + row_tile], N)  # int8 [rows, N]
            sq[s0 : s0 + row_tile, w0:w1] = pack_bool_cols(bool_dot(a, bt) > 0)
        del bt
    # disjoint word ranges per grant member: the int32 sum is the OR
    psum(mesh, sq, GRANT_AXIS)
    new = stripe | sq
    changed = (new != stripe).any().to(_I32).reshape(1)
    psum(mesh, changed, BOTH)
    # kvtpu: ignore[jit-host-sync] the eager loop decides convergence on this flag next; read here or in the caller, it is the same one sync
    return new, int(changed.item())


def _barrier(mesh: Mesh) -> None:
    """Every rank past this point (a sum over the world, which works on
    both backends without a device hint)."""
    psum(mesh, torch.zeros(1, dtype=_I32, device=mesh.device), BOTH)


def sharded_packed_closure(
    mesh: Mesh,
    packed,
    *,
    tile: int = 7168,
    dst_tile: int = 14336,
    max_iter: int = 32,
    hbm_limit: Optional[int] = None,
    guard: bool = True,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> np.ndarray:
    """Transitive closure of a packed matrix (``uint32 [n, W]`` host words
    or an int32 tensor of the same bits, column pad bits zero) over the
    ``(pods, grants)`` mesh, on every rank. Bit-for-bit equal to
    ``packed_closure`` — same products, same union, distributed schedule.
    Returns the packed closure as host ``uint32 [n, W]``.

    ``n`` need not divide the mesh: rows and word columns are zero-padded
    to the stripe geometry (pad nodes have no edges, so the closure
    restricted to the real nodes is unchanged) and trimmed on return.
    ``hbm_limit`` (bytes/rank) feeds the pre-flight guard; ``guard=False``
    skips it.

    With ``checkpoint_dir`` and ``checkpoint_every`` > 0, every that many
    passes the stripes are gathered and rank 0 commits one atomic
    ``checkpoint_closure`` generation — the *padded* ``[Np, Np/32]`` matrix
    and the pass counter (the other ranks wait for it). ``resume=True``
    restarts every rank from the newest valid generation whose shape matches
    this mesh's padding (another factorisation pads differently and raises
    ``ConfigError``); an empty or damaged ladder starts from ``packed`` at
    pass 0. A checkpoint of the JAX package's sharded closure resumes here
    and the other way round."""
    dp = mesh.shape[POD_AXIS]
    mp = mesh.shape[GRANT_AXIS]
    if isinstance(packed, torch.Tensor):
        packed_np = packed.cpu().numpy().view(np.uint32)
    else:
        packed_np = np.asarray(packed)
    if packed_np.ndim != 2 or packed_np.dtype != np.uint32:
        raise ConfigError(
            f"packed matrix must be uint32 [n, W]; got {packed_np.dtype} {packed_np.shape}"
        )
    n, W0 = packed_np.shape
    if n > W0 * 32:
        raise ConfigError(f"packed matrix has {n} rows but only {W0 * 32} bit columns")
    if n == 0:
        return packed_np.copy()
    # pad N so every row stripe splits into 32-multiple row tiles and every
    # grant member owns a whole number of 32-bit dst words
    mult = int(32 * dp * mp // np.gcd(dp, mp))
    Np = n + (-n) % mult
    Wp = Np // 32
    padded = np.zeros((Np, Wp), dtype=np.uint32)
    padded[:n, : min(W0, Wp)] = packed_np[:, : min(W0, Wp)]
    n_loc = Np // dp
    t = _fit_tile(n_loc, tile)
    dt = _fit_tile(Np // mp, dst_tile)
    if guard:
        check_closure_budget(
            Np, row_tile=t, dst_tile=dt, n_devices=dp, grant_devices=mp,
            limit_bytes=hbm_limit, device=mesh.device,
        )
    CLOSURE_STRIPE_ROWS.set(n_loc)
    # the manifest entry is shared; the key carries this call's geometry
    # (observe/aot.py warm pack)
    from ..observe.aot import transient_kernel

    square = transient_kernel(
        "sharded",
        "_sharded_square_local",
        _sharded_square_local,
        key_extras=(Np, t, dt, dp, mp),
    )
    start_pass = 0
    cm = None
    if checkpoint_dir:
        from ..serve.durability import CheckpointManager, load_closure_checkpoint

        cm = CheckpointManager(checkpoint_dir)
        if resume:
            try:
                arr, start_pass, _manifest = load_closure_checkpoint(checkpoint_dir)
                if tuple(arr.shape) != (Np, Wp):
                    raise ConfigError(
                        f"sharded closure checkpoint shape {tuple(arr.shape)} != "
                        f"padded shape {(Np, Wp)} for mesh ({dp}, {mp})"
                    )
                padded = np.asarray(arr, dtype=np.uint32)
            except PersistError:
                start_pass = 0
    rows = rank_slice(mesh, POD_AXIS, Np)
    cur = torch.as_tensor(padded[rows].view(np.int32).copy(), device=mesh.device)

    def commit(done: int) -> None:
        # gather the stripes into one host generation (rank 0 writes; the
        # padded matrix round-trips bit-exactly, so a resume on the same
        # mesh replays only the passes after this commit)
        whole = all_gather(mesh, cur, POD_AXIS, dim=0)
        if mesh.rank == 0:
            cm.checkpoint_closure(whole, done)
        _barrier(mesh)

    bound = max(1, math.ceil(math.log2(max(Np, 2))))
    ticker = ProgressTicker(
        "sharded_closure",
        total=min(bound, max_iter) if max_iter else bound,
        unit="pass",
        initial=start_pass,
    )
    converged = False
    try:
        for done in range(start_pass, max_iter):
            CLOSURE_ITERATIONS.inc()
            CLOSURE_SHARDED_ITERATIONS.inc()
            cur, changed = square(mesh, cur, n_total=Np, row_tile=t, dst_tile=dt)
            ticker.tick()
            if cm is not None and checkpoint_every > 0 and (done + 1) % checkpoint_every == 0:
                commit(done + 1)
            # the change flag summed over every rank decides convergence
            if changed == 0:
                converged = True
                break
    except BaseException:
        ticker.finish("error")
        raise
    ticker.finish("converged" if converged else "done")
    out = all_gather(mesh, cur, POD_AXIS, dim=0).cpu().numpy().view(np.uint32)
    if (Np, Wp) == (n, W0):
        return out
    # trim pad rows; restore the caller's word width (columns >= Np are pad
    # bits — zero by contract and untouched by the closure)
    res = np.zeros((n, W0), dtype=np.uint32)
    res[:, : min(W0, Wp)] = out[:n, : min(W0, Wp)]
    return res
