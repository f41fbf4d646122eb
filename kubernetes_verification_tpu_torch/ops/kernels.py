"""The packed any-port reachability kernel and its plain PyTorch version.

``packed_dir_allow`` is the port of the Pallas TPU kernel
``kubernetes_verification_tpu/ops/pallas_kernels.py::packed_dir_allow``:

    out = pack((aᵀ·b > 0) ∨ ¬iso)      int32 [N, N/32]

one direction's grant contraction over the policy axis, the default-allow OR
(along dst columns for ``default_allow_axis=1``, ingress; along src rows for
``0``, egress; none for ``-1``) and the 32-bit little-endian bit-pack, with
the int32 counts never written to device memory. On a CUDA tensor it launches
the hand-written kernel of ``csrc/packed_dir_allow.cu`` (int8 tensor cores
on K-contiguous copies of the maps, ballot pack in the epilogue) or raises;
only CPU tensors reach the plain version ``packed_dir_allow_reference``. ``packed_reach`` combines two
directions with a word-wise AND and the packed self-traffic diagonal, in plain
torch on the words, as the JAX package does in XLA outside its kernel.

The TPU kernel's pack matrices (``_pack_matrices``) have no counterpart: they
exist only because Mosaic cannot do a lane-splitting reshape.
"""
from __future__ import annotations

import ctypes

import torch

from ..resilience.errors import BackendError, ConfigError
from .bits import or_diagonal, pack_bool_cols
from .match import exact_fp32

__all__ = [
    "packed_dir_allow",
    "packed_dir_allow_reference",
    "packed_reach",
    "k_major",
    "launch",
    "N_TILE",
    "K_STEP",
]

#: the kernel's output tile (rows and columns): N must be a multiple
N_TILE = 128
#: the kernel's policy-axis step: P is padded to a multiple with zeros
K_STEP = 64
#: dst columns per step of the plain version's loop
_REF_TILE = 4096


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
