"""The port's hand-written CUDA kernels and their plain PyTorch versions.

``packed_dir_allow`` is the port of the Pallas TPU kernel
``kubernetes_verification_tpu/ops/pallas_kernels.py::packed_dir_allow``:

    out = pack((aᵀ·b > 0) ∨ ¬iso)      int32 [N, N/32]

one direction's grant contraction over the policy axis, the default-allow OR
(along dst columns for ``default_allow_axis=1``, ingress; along src rows for
``0``, egress; none for ``-1``) and the 32-bit little-endian bit-pack, with
the int32 counts never written to device memory. On a CUDA tensor it launches
the hand-written kernel of ``csrc/packed_dir_allow.cu`` (on the shared Hopper
mainloop of ``csrc/hopper_int8.cuh``: TMA into an mbarrier ring, ``wgmma``
int8 on K-contiguous copies of the maps, a grouped tile order, the pack done
from the accumulator layout) or raises;
only CPU tensors reach the plain version ``packed_dir_allow_reference``. ``packed_reach`` combines two
directions with a word-wise AND and the packed self-traffic diagonal, in plain
torch on the words, as the JAX package does in XLA outside its kernel.

``fused_ports_reach`` is the port of the Pallas TPU kernel
``kubernetes_verification_tpu/ops/pallas_kernels.py::fused_ports_stripe``:
the whole port-bitmap reach in one K walk over the virtual-policy segments of
both directions, flushing each segment's ``counts > 0`` into per-element
egress-plane / ``gi_any`` / ``conj`` state, then the default-allow expansion
and the bit-pack (``csrc/fused_ports_reach.cu``, on the same mainloop, whose
hook flushes a segment at the 64-column step that ends it; plain version
``fused_ports_reach_reference``).

The TPU kernels' pack matrices (``_pack_matrices``) have no counterpart: they
exist only because Mosaic cannot do a lane-splitting reshape.

Each kernel's exact operation and byte counts stand next to its wrapper
(``packed_dir_allow_cost``, ``fused_ports_reach_cost``): the wrappers
publish them as ``KernelCostReport``s (engine ``cuda``) while introspection
is on (``observe/introspect.py``), and ``introspect.analytic_bound`` turns
them into the least time the card could take.
"""
from __future__ import annotations

import ctypes

import torch

from ..observe.introspect import maybe_publish
from ..resilience.errors import BackendError, ConfigError
from .bits import or_diagonal, pack_bool_cols
from .match import exact_fp32

__all__ = [
    "packed_dir_allow",
    "packed_dir_allow_reference",
    "packed_dir_allow_pod_major",
    "packed_reach",
    "k_major",
    "launch",
    "fused_ports_reach",
    "fused_ports_reach_reference",
    "packed_dir_allow_cost",
    "fused_ports_reach_cost",
    "check_mask_count",
    "N_TILE",
    "K_STEP",
    "FUSED_MAX_MASKS",
]

#: the kernels' output row tile: N must be a multiple (a wider column tile
#: masks its ragged last tile itself)
N_TILE = 128
#: the kernels' K step: P is padded to a multiple with zeros, and a fused
#: segment ends on one (half of the 128-byte stage of the Hopper mainloop)
K_STEP = 64
#: dst columns per step of the plain version's loop
_REF_TILE = 4096
#: the most ported masks R ``fused_ports_reach`` takes: its per-element state
#: holds the R + 1 egress planes and two flags in at most two 32-bit words
FUSED_MAX_MASKS = 61
#: dst columns per step of ``fused_ports_reach_reference``'s loop (its
#: per-element state is int64, twice the float32 counts)
_REF_TILE_PORTS = 2048


def _check(a, b, not_iso, default_allow_axis):
    if default_allow_axis not in (-1, 0, 1):
        raise ConfigError(f"default_allow_axis={default_allow_axis} not in (-1, 0, 1)")
    if a.dtype != torch.int8 or b.dtype != torch.int8 or not_iso.dtype != torch.int32:
        raise ConfigError(
            f"packed_dir_allow takes int8/int8/int32, got "
            f"{a.dtype}/{b.dtype}/{not_iso.dtype}"
        )
    if a.dim() != 2 or a.shape != b.shape:
        raise ConfigError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must both be [P, N]")
    n = a.shape[1]
    if not_iso.dim() != 2 or not_iso.shape[1] != n or not_iso.shape[0] < 1:
        raise ConfigError(f"not_iso {tuple(not_iso.shape)} must be [8, {n}]")
    if n % N_TILE:
        raise ConfigError(f"N={n} is not a multiple of the kernel tile {N_TILE}")
    if not (a.device == b.device == not_iso.device):
        raise ConfigError("a, b and not_iso must be on one device")
    if not (a.is_contiguous() and b.is_contiguous() and not_iso.is_contiguous()):
        raise ConfigError("packed_dir_allow takes contiguous tensors")


def packed_dir_allow_cost(p: int, n: int, niso_numel: int) -> dict:
    """Exact counts of one ``packed_dir_allow`` over ``p`` policies and
    ``n`` pods: ``2·P·N·N`` int8 operations; bytes ``2·P·N`` (each map read
    once) ``+ 4·|niso|`` ``+ N·N/8`` (the packed words written once)."""
    args = 2 * p * n + 4 * niso_numel
    out = n * n // 8
    return {"flops": 2 * p * n * n, "bytes_accessed": args + out,
            "argument_bytes": args, "output_bytes": out}


def fused_ports_reach_cost(
    n: int, k: int, kp: int, plan_numel: int, ov_numel: int
) -> dict:
    """Exact counts of one ``fused_ports_reach`` over ``n`` pods with ``k``
    real virtual-policy rows in a K layout of ``kp`` columns: ``2·K·N·N``
    int8 operations; bytes ``2·N·K'`` (both operands read once) ``+
    4·|plan| + 8·|ov| + 8·N`` (the two isolation vectors) ``+ N·N/8``."""
    args = 2 * n * kp + 4 * plan_numel + 8 * ov_numel + 8 * n
    out = n * n // 8
    return {"flops": 2 * k * n * n, "bytes_accessed": args + out,
            "argument_bytes": args, "output_bytes": out}


def _publish(fn: str, cost, operands: tuple) -> None:
    """The kernel's cost report, keyed by its operands' shapes and device
    (a no-op while introspection is off)."""
    maybe_publish("cuda", fn, cost, operands + (operands[0].device.type,))


def k_major(x: torch.Tensor) -> torch.Tensor:
    """int8 [P, N] → int8 [N, P'], the K-contiguous transpose the kernel
    reads (int8 tensor cores multiply only K-contiguous operands), with P'
    the policy axis padded by zero columns to a positive multiple of
    ``K_STEP`` (inert: a zero adds nothing to any count). One strided copy."""
    p, n = x.shape
    pp = p + ((K_STEP - p % K_STEP) % K_STEP if p else K_STEP)
    out = x.new_zeros((n, pp))
    out[:, :p] = x.t()
    return out


def packed_dir_allow_reference(
    a: torch.Tensor,
    b: torch.Tensor,
    not_iso: torch.Tensor,
    *,
    default_allow_axis: int = -1,
) -> torch.Tensor:
    """The plain version: a dst-tiled loop of exact float32 products (counts
    ≤ P < 2²⁴, TF32 off), thresholded, ORed and packed. Any device."""
    _check(a, b, not_iso, default_allow_axis)
    n = a.shape[1]
    free = not_iso[0] > 0
    af = a.to(torch.float32)
    out = torch.empty((n, n // 32), dtype=torch.int32, device=a.device)
    for d0 in range(0, n, _REF_TILE):
        d1 = min(n, d0 + _REF_TILE)
        with exact_fp32():
            ok = (af.T @ b[:, d0:d1].to(torch.float32)) > 0
        if default_allow_axis == 1:
            ok |= free[None, d0:d1]
        elif default_allow_axis == 0:
            ok |= free[:, None]
        out[:, d0 // 32 : d1 // 32] = pack_bool_cols(ok)
    return out


def packed_dir_allow(
    a: torch.Tensor,  # int8 [P, N] source-side per-policy map
    b: torch.Tensor,  # int8 [P, N] destination-side per-policy map
    not_iso: torch.Tensor,  # int32 [8, N] (row 0 read)
    *,
    default_allow_axis: int = -1,
) -> torch.Tensor:
    """int32 [N, N/32]: pack((aᵀb > 0) ∨ ¬iso), words with the reference's
    uint32 bit pattern. N must be a multiple of ``N_TILE``. CPU tensors take
    the plain version; a CUDA tensor launches the kernel, counted in ``packed_dir_allow.launches``, on the
    K-contiguous copies ``k_major`` makes of the two maps."""
    _check(a, b, not_iso, default_allow_axis)
    _publish(
        "packed_dir_allow",
        lambda: packed_dir_allow_cost(a.shape[0], a.shape[1], not_iso.numel()),
        (a, b, not_iso),
    )
    if a.device.type == "cpu":
        return packed_dir_allow_reference(
            a, b, not_iso, default_allow_axis=default_allow_axis
        )
    if a.device.type != "cuda":
        raise BackendError(
            f"packed_dir_allow runs on cuda or cpu, not {a.device}",
            backend="torch",
        )
    if a.shape[1] == 0:  # no pods: nothing to launch
        return torch.empty((0, 0), dtype=torch.int32, device=a.device)
    return launch(k_major(a), k_major(b), not_iso, default_allow_axis)


def launch(
    at: torch.Tensor, bt: torch.Tensor, not_iso: torch.Tensor, axis: int
) -> torch.Tensor:
    """Launch the CUDA kernel on K-contiguous operands (``k_major`` of the
    two maps, on one CUDA device) and count the launch. Returns the int32
    [N, N/32] words; asynchronous, on the current stream."""
    from .cuda_build import load_library

    n, p = at.shape
    if (
        bt.shape != at.shape or at.dtype != torch.int8 or bt.dtype != torch.int8
        or not_iso.dtype != torch.int32 or not_iso.shape[-1] != n
    ):
        raise ConfigError(
            f"launch takes int8 [N, P'] twice and int32 [8, N], got "
            f"{tuple(at.shape)} {at.dtype}, {tuple(bt.shape)} {bt.dtype}, "
            f"{tuple(not_iso.shape)} {not_iso.dtype}"
        )
    out = torch.empty((n, n // 32), dtype=torch.int32, device=at.device)
    for t in (at, bt, not_iso, out):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise BackendError("packed_dir_allow needs contiguous, 16-byte "
                               "aligned tensors", backend="torch")
    lib = load_library("packed_dir_allow")
    fn = lib.packed_dir_allow_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(at.device):
        stream = torch.cuda.current_stream(at.device).cuda_stream
        rc = fn(
            at.data_ptr(), bt.data_ptr(), not_iso.data_ptr(), out.data_ptr(),
            n, p, axis, stream,
        )
    if rc != 0:
        raise BackendError(
            f"packed_dir_allow launch failed: cudaError {rc} "
            f"(N={n}, P'={p}, axis={axis})",
            backend="torch",
        )
    packed_dir_allow.launches += 1
    return out


packed_dir_allow.launches = 0


def packed_dir_allow_pod_major(
    at: torch.Tensor,  # int8 [N, P] source-side map, pod-major
    bt: torch.Tensor,  # int8 [N, P] destination-side map, pod-major
    not_iso: torch.Tensor,  # int32 [8, N] (row 0 read)
    *,
    default_allow_axis: int = -1,
) -> torch.Tensor:
    """``packed_dir_allow`` on pod-major maps, the K-contiguous layout the
    kernel reads: a CUDA tensor launches it on the maps themselves when P
    is a positive multiple of ``K_STEP`` (else on zero-padded copies); a
    CPU tensor takes the plain version on the transposes."""
    _publish(
        "packed_dir_allow",
        lambda: packed_dir_allow_cost(at.shape[1], at.shape[0], not_iso.numel()),
        (at.t(), bt.t(), not_iso),
    )
    if at.device.type == "cpu":
        return packed_dir_allow_reference(
            at.t().contiguous(), bt.t().contiguous(), not_iso,
            default_allow_axis=default_allow_axis,
        )
    if at.device.type != "cuda":
        raise BackendError(
            f"packed_dir_allow runs on cuda or cpu, not {at.device}", backend="torch"
        )
    if at.shape != bt.shape or at.shape[0] % N_TILE:
        raise ConfigError(
            f"at {tuple(at.shape)} and bt {tuple(bt.shape)} must both be [N, P] "
            f"with N a multiple of {N_TILE}"
        )
    p = at.shape[1]
    pad = (-p) % K_STEP if p else K_STEP
    if pad:
        at = torch.nn.functional.pad(at, (0, pad))
        bt = torch.nn.functional.pad(bt, (0, pad))
    return launch(at, bt, not_iso, default_allow_axis)


def packed_reach(
    ing_by_pol: torch.Tensor,  # int8 [P, N] (src side of ingress)
    sel_ing: torch.Tensor,  # int8 [P, N] (dst side of ingress)
    sel_eg: torch.Tensor,  # int8 [P, N] (src side of egress)
    eg_by_pol: torch.Tensor,  # int8 [P, N] (dst side of egress)
    not_ing_iso: torch.Tensor,  # int32 [8, N]
    not_eg_iso: torch.Tensor,  # int32 [8, N]
    *,
    self_traffic: bool = True,
    default_allow_unselected: bool = True,
) -> torch.Tensor:
    """int32 [N, N/32] packed reachability: two direction kernels, one
    word-wise AND (in place), and the packed-diagonal OR."""
    da = default_allow_unselected
    out = packed_dir_allow(
        ing_by_pol, sel_ing, not_ing_iso, default_allow_axis=1 if da else -1
    )
    out &= packed_dir_allow(
        sel_eg, eg_by_pol, not_eg_iso, default_allow_axis=0 if da else -1
    )
    if self_traffic:
        or_diagonal(out)
    return out


# ---------------------------------------------------------------------------
# fused_ports_reach: the port-bitmap reach
# ---------------------------------------------------------------------------


def check_mask_count(r: int) -> None:
    """``ConfigError`` unless ``fused_ports_reach`` takes R = ``r`` ported
    masks."""
    if r > FUSED_MAX_MASKS:
        raise ConfigError(
            f"R={r} ported masks is over fused_ports_reach's limit of "
            f"{FUSED_MAX_MASKS}; solve with use_kernel=False (the torch "
            "mask-group sweep), or coarsen the cluster's port specs"
        )


def _check_fused(at, bt, plan, ov, niso_i, niso_e) -> list:
    """``ConfigError`` unless both routes of ``fused_ports_reach`` take these
    operands; the plan's segments (``_plan_segments``). The kernel flushes
    only where a K step ends a plan row, so a plan it cannot walk is refused
    here, on the card as on the CPU."""
    if at.dtype != torch.int8 or bt.dtype != torch.int8:
        raise ConfigError(f"fused_ports_reach takes int8 operands, got {at.dtype}/{bt.dtype}")
    if at.dim() != 2 or at.shape != bt.shape:
        raise ConfigError(
            f"at {tuple(at.shape)} and bt {tuple(bt.shape)} must both be [N, K']"
        )
    n, kp = at.shape
    if n % N_TILE or kp % K_STEP or kp == 0:
        raise ConfigError(
            f"N={n} must be a multiple of the kernel tile {N_TILE} and "
            f"K'={kp} a positive multiple of the K step {K_STEP}"
        )
    if plan.dtype != torch.int32 or plan.dim() != 2 or plan.shape[1] != 3 or not len(plan):
        raise ConfigError(f"plan must be int32 [S >= 1, 3], got {tuple(plan.shape)} {plan.dtype}")
    if ov.dtype != torch.int64 or ov.dim() != 1:
        raise ConfigError(f"ov must be int64 [R], got {tuple(ov.shape)} {ov.dtype}")
    check_mask_count(ov.shape[0])
    for name, v in (("niso_i", niso_i), ("niso_e", niso_e)):
        if v.dtype != torch.int32 or tuple(v.shape) != (n,):
            raise ConfigError(f"{name} must be int32 [{n}], got {tuple(v.shape)} {v.dtype}")
    if len({t.device for t in (at, bt, plan, ov, niso_i, niso_e)}) != 1:
        raise ConfigError("fused_ports_reach's operands must be on one device")
    if not all(t.is_contiguous() for t in (at, bt, plan, ov, niso_i, niso_e)):
        raise ConfigError("fused_ports_reach takes contiguous tensors")
    return _plan_segments(plan, kp, ov.shape[0])


def _plan_segments(plan: torch.Tensor, kp: int, r: int) -> list:
    """``(k0, k1, kind, slab)`` per plan row; ``ConfigError`` unless the
    segments tile ``[0, K')`` in whole, non-empty K steps and each kind's
    slab is in range (0, 1: an egress plane ≤ R, R the full block; 2: an
    ingress mask < R; 3: the ingress full block)."""
    segs, k0 = [], 0
    for end, kind, slab in plan.tolist():
        k1 = end * K_STEP
        ok_slab = {0: 0 <= slab <= r, 1: 0 <= slab <= r, 2: 0 <= slab < r, 3: True}.get(kind)
        if k1 <= k0 or not ok_slab:
            raise ConfigError(f"bad plan row {(end, kind, slab)} (R={r}, K'={kp})")
        segs.append((k0, k1, kind, slab))
        k0 = k1
    if k0 != kp:
        raise ConfigError(f"the plan ends at K={k0}, not at K'={kp}")
    return segs


def fused_ports_reach_reference(
    at: torch.Tensor,
    bt: torch.Tensor,
    plan: torch.Tensor,
    ov: torch.Tensor,
    niso_i: torch.Tensor,
    niso_e: torch.Tensor,
    *,
    default_allow: bool,
) -> torch.Tensor:
    """The plain version: per segment a dst-tiled exact float32 product
    (counts ≤ K' < 2²⁴, TF32 off), ``> 0``, and the same flush as the
    kernel into int64 per-element state (egress planes as bits 0..R); then
    the default-allow expansion and the pack. Any device."""
    segs = _check_fused(at, bt, plan, ov, niso_i, niso_e)
    n = at.shape[0]
    r = ov.shape[0]
    masks = ov.tolist() + [(1 << (r + 1)) - 1]  # kind 3 overlaps every plane
    a_segs = [at[:, k0:k1].to(torch.float32).contiguous() for k0, k1, _, _ in segs]
    di_all = niso_i > 0
    de = (niso_e > 0)[:, None]
    out = torch.empty((n, n // 32), dtype=torch.int32, device=at.device)
    for d0 in range(0, n, _REF_TILE_PORTS):
        d1 = min(n, d0 + _REF_TILE_PORTS)
        planes = torch.zeros((n, d1 - d0), dtype=torch.int64, device=at.device)
        gi_any = torch.zeros((n, d1 - d0), dtype=torch.bool, device=at.device)
        conj = torch.zeros_like(gi_any)
        for (k0, k1, kind, slab), a in zip(segs, a_segs):
            with exact_fp32():
                ok = (a @ bt[d0:d1, k0:k1].to(torch.float32).T) > 0
            if kind <= 1:  # egress: plane `slab` (R: the full block)
                planes |= ok.to(torch.int64) << slab
            else:  # ingress: AND the planes it overlaps
                conj |= ok & ((planes & masks[slab if kind == 2 else r]) != 0)
                gi_any |= ok
        reach = conj
        if default_allow:
            di = di_all[None, d0:d1]
            reach = reach | (di & de) | (di & (planes != 0)) | (de & gi_any)
        out[:, d0 // 32 : d1 // 32] = pack_bool_cols(reach)
    return out


def fused_ports_reach(
    at: torch.Tensor,  # int8 [N, K'] src-side VP rows, K-contiguous
    bt: torch.Tensor,  # int8 [N, K'] dst-side VP rows, K-contiguous
    plan: torch.Tensor,  # int32 [S, 3]: (segment end in K steps, kind, slab)
    ov: torch.Tensor,  # int64 [R]: per ported mask, the egress planes it overlaps
    niso_i: torch.Tensor,  # int32 [N]: 1 where the dst is not ingress-isolated
    niso_e: torch.Tensor,  # int32 [N]: 1 where the src is not egress-isolated
    *,
    default_allow: bool,
    k_rows=None,
) -> torch.Tensor:
    """int32 [N, N/32]: the port-bitmap reach words (the reference's uint32
    bit pattern), before the self-traffic diagonal and ``col_mask``.

    The K axis is ``[egress ported segments | egress full block | ingress
    ported segments | ingress full block]``, each segment padded on its own
    with zero columns to a ``K_STEP`` multiple; ``plan`` row s ends segment
    s. An egress segment sets plane bit ``slab`` of each (src, dst) element
    where its count is > 0 (bit R: the full block); an ingress segment
    ORs ``ok`` into ``gi_any`` and ``ok ∧ (planes & ov[slab] ≠ 0)`` into
    ``conj`` (the full block: any plane). Then ``conj ∨ (di∧de) ∨
    (di∧ge_any) ∨ (de∧gi_any)`` with ``default_allow``. ``ov[m]`` has bit R
    set: the full egress block overlaps every mask.

    CPU tensors take the plain version; a CUDA tensor launches the kernel,
    counted in ``fused_ports_reach.launches``. R above ``FUSED_MAX_MASKS``,
    or a plan that does not tile ``[0, K')`` in whole non-empty K steps,
    raises ``ConfigError`` on either. ``k_rows`` (an int, or a zero-arg
    function evaluated only for the cost report) is the number of real
    virtual-policy rows among the K' columns; the report counts K' without
    it."""
    _check_fused(at, bt, plan, ov, niso_i, niso_e)

    def cost():
        k = at.shape[1] if k_rows is None else int(k_rows() if callable(k_rows) else k_rows)
        return fused_ports_reach_cost(at.shape[0], k, at.shape[1], plan.numel(), ov.numel())

    _publish("fused_ports_reach", cost, (at, bt, plan, ov, niso_i, niso_e))
    if at.device.type == "cpu":
        return fused_ports_reach_reference(
            at, bt, plan, ov, niso_i, niso_e, default_allow=default_allow
        )
    if at.device.type != "cuda":
        raise BackendError(
            f"fused_ports_reach runs on cuda or cpu, not {at.device}", backend="torch"
        )
    from .cuda_build import load_library

    n, kp = at.shape
    out = torch.empty((n, n // 32), dtype=torch.int32, device=at.device)
    if any(t.data_ptr() % 16 for t in (at, bt, out)):
        raise BackendError("fused_ports_reach needs 16-byte aligned operands",
                           backend="torch")
    fn = load_library("fused_ports_reach").fused_ports_reach_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(at.device):
        stream = torch.cuda.current_stream(at.device).cuda_stream
        rc = fn(
            at.data_ptr(), bt.data_ptr(), plan.data_ptr(), ov.data_ptr(),
            niso_i.data_ptr(), niso_e.data_ptr(), out.data_ptr(),
            n, kp, plan.shape[0], ov.shape[0], int(default_allow), stream,
        )
    if rc != 0:
        raise BackendError(
            f"fused_ports_reach launch failed: cudaError {rc} "
            f"(N={n}, K'={kp}, segments={plan.shape[0]}, R={ov.shape[0]})",
            backend="torch",
        )
    fused_ports_reach.launches += 1
    return out


fused_ports_reach.launches = 0
