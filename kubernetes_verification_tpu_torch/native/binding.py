"""Build + ctypes binding for the packed-bitset native engine.

The port's copy of ``kubernetes_verification_tpu.native.binding``. It
compiles ``bitset.cpp`` with the system ``g++`` on first import into the
package's gitignored ``_build/`` directory, under a name that carries a hash
of the source (an edited source never loads a stale build), and wraps the C
ABI in NumPy-friendly functions. The library is built for this host
(``-march=native``), so it is never shipped with the warm kernel pack. If no
compiler is available the import raises ``NativeUnavailable`` and the
``native`` backend simply doesn't register — the port stays fully
functional on the other backends.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

__all__ = ["lib", "NativeUnavailable", "pack", "unpack", "BitMatrix"]


class NativeUnavailable(RuntimeError):
    pass


_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bitset.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")


def _so_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libkvbitset-{digest}.so")


def _build() -> str:
    so = _so_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # per-process temp name: concurrent first imports must not clobber each
    # other's half-written artifact before the atomic os.replace
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
        "-o", tmp, _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:  # no g++
        raise NativeUnavailable("g++ not found") from e
    except subprocess.CalledProcessError as e:
        # retry without -march=native (portability) and without openmp
        for drop in (["-march=native"], ["-march=native", "-fopenmp"]):
            cmd2 = [c for c in cmd if c not in drop]
            try:
                subprocess.run(cmd2, check=True, capture_output=True, text=True)
                break
            except subprocess.CalledProcessError:
                continue
        else:
            raise NativeUnavailable(f"compile failed:\n{e.stderr}") from e
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build())
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    sigs = {
        "kv_pack": (None, [u8p, i64, i64, u64p]),
        "kv_unpack": (None, [u64p, i64, i64, u8p]),
        "kv_subset": (None, [u64p, u64p, i64, i64, i64, u8p]),
        "kv_disjoint": (None, [u64p, u64p, i64, i64, i64, u8p]),
        "kv_any": (None, [u64p, u64p, i64, i64, i64, u8p]),
        "kv_or_scatter": (None, [u64p, u64p, i64, i64, i64, u64p]),
        "kv_row_or_mask": (None, [u64p, u8p, u64p, i64, i64]),
        "kv_and_rows": (None, [u64p, u64p, i64, i64, u64p]),
        "kv_or_into": (None, [u64p, u64p, i64, i64]),
        "kv_closure": (None, [u64p, i64, i64]),
        "kv_popcount_rows": (None, [u64p, i64, i64, i64p]),
        "kv_transpose": (None, [u64p, i64, i64, u64p]),
        "kv_num_threads": (ctypes.c_int, []),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


lib = _load()


def _u64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def words(cols: int) -> int:
    return (cols + 63) // 64


def pack(a: np.ndarray) -> np.ndarray:
    """bool [R, C] → packed uint64 [R, words(C)]."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    r, c = a.shape
    out = np.zeros((r, words(c)), dtype=np.uint64)
    lib.kv_pack(_u8(a), r, c, _u64(out))
    return out


def unpack(p: np.ndarray, cols: int) -> np.ndarray:
    """packed uint64 [R, words(cols)] → bool [R, cols]."""
    p = np.ascontiguousarray(p, dtype=np.uint64)
    r = p.shape[0]
    out = np.zeros((r, cols), dtype=np.uint8)
    lib.kv_unpack(_u64(p), r, cols, _u8(out))
    return out.astype(bool)


class BitMatrix:
    """A packed boolean matrix [rows × cols] with the native kernels as
    methods — the framework-owned replacement for the bitarray objects the
    reference builds its matrix out of (``kano_py/kano/model.py:124-184``)."""

    def __init__(self, data: np.ndarray, cols: int):
        assert data.dtype == np.uint64 and data.ndim == 2
        self.data = np.ascontiguousarray(data)
        self.rows = data.shape[0]
        self.cols = cols
        assert data.shape[1] == words(cols)

    @classmethod
    def from_bool(cls, a: np.ndarray) -> "BitMatrix":
        return cls(pack(a), a.shape[1])

    @classmethod
    def zeros(cls, rows: int, cols: int) -> "BitMatrix":
        return cls(np.zeros((rows, words(cols)), dtype=np.uint64), cols)

    def to_bool(self) -> np.ndarray:
        return unpack(self.data, self.cols)

    def subset_of(self, other: "BitMatrix") -> np.ndarray:
        """bool [self.rows, other.rows]: row_s ⊆ other_row_n."""
        out = np.zeros((self.rows, other.rows), dtype=np.uint8)
        lib.kv_subset(
            _u64(self.data), _u64(other.data), self.rows, other.rows,
            self.data.shape[1], _u8(out),
        )
        return out.astype(bool)

    def disjoint_from(self, other: "BitMatrix") -> np.ndarray:
        out = np.zeros((self.rows, other.rows), dtype=np.uint8)
        lib.kv_disjoint(
            _u64(self.data), _u64(other.data), self.rows, other.rows,
            self.data.shape[1], _u8(out),
        )
        return out.astype(bool)

    def intersects(self, other: "BitMatrix") -> np.ndarray:
        out = np.zeros((self.rows, other.rows), dtype=np.uint8)
        lib.kv_any(
            _u64(self.data), _u64(other.data), self.rows, other.rows,
            self.data.shape[1], _u8(out),
        )
        return out.astype(bool)

    def or_scatter_into(self, sel: "BitMatrix", val: "BitMatrix") -> None:
        """``for p, i: if sel[p, i]: self[i] |= val[p]`` — the matrix-build
        hot loop (``kano_py/kano/model.py:158-163``)."""
        assert sel.rows == val.rows and sel.data.shape == val.data.shape
        assert self.data.shape[1] == val.data.shape[1]
        lib.kv_or_scatter(
            _u64(sel.data), _u64(val.data), sel.rows, self.rows,
            self.data.shape[1], _u64(self.data),
        )

    def row_or_mask(self, cond: np.ndarray, mask_row: np.ndarray) -> None:
        cond = np.ascontiguousarray(cond, dtype=np.uint8)
        mask_row = np.ascontiguousarray(mask_row, dtype=np.uint64)
        lib.kv_row_or_mask(
            _u64(self.data), _u8(cond), _u64(mask_row), self.rows,
            self.data.shape[1],
        )

    def and_with(self, other: "BitMatrix") -> "BitMatrix":
        out = np.zeros_like(self.data)
        lib.kv_and_rows(
            _u64(self.data), _u64(other.data), self.rows, self.data.shape[1],
            _u64(out),
        )
        return BitMatrix(out, self.cols)

    def or_into(self, other: "BitMatrix") -> None:
        """self |= other."""
        lib.kv_or_into(
            _u64(self.data), _u64(other.data), self.rows, self.data.shape[1]
        )

    def closure_inplace(self) -> None:
        assert self.rows == self.cols
        lib.kv_closure(_u64(self.data), self.rows, self.data.shape[1])

    def popcount_rows(self) -> np.ndarray:
        out = np.zeros(self.rows, dtype=np.int64)
        lib.kv_popcount_rows(
            _u64(self.data), self.rows, self.data.shape[1], _i64(out)
        )
        return out

    def transpose(self) -> "BitMatrix":
        out = np.zeros((self.cols, words(self.rows)), dtype=np.uint64)
        lib.kv_transpose(_u64(self.data), self.rows, self.cols, _u64(out))
        return BitMatrix(out, self.rows)

    def set_diagonal(self) -> None:
        for i in range(min(self.rows, self.cols)):
            self.data[i, i >> 6] |= np.uint64(1 << (i & 63))
