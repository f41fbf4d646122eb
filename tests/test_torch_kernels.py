"""``packed_dir_allow`` / ``packed_reach``: the port's plain version against
the JAX package's Pallas kernel in interpret mode, the packed-word helpers
and the popcount against the JAX package's (exact: every output is integer
words). The CUDA kernel itself runs only on the card:
``tests/test_torch_cuda.py`` holds it against the plain version there."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_verification_tpu.ops.closure import _packed_row_counts as jax_row_counts
from kubernetes_verification_tpu.ops.pallas_kernels import (
    packed_dir_allow as jax_packed_dir_allow,
)
from kubernetes_verification_tpu.ops.pallas_kernels import (
    packed_reach as jax_packed_reach,
)
from kubernetes_verification_tpu.ops.tiled import pack_bool_cols as jax_pack
from kubernetes_verification_tpu.ops.tiled import unpack_words_i8 as jax_unpack
from kubernetes_verification_tpu_torch.ops.bits import (
    or_diagonal,
    pack_bool_cols,
    unpack_words_i8,
)
from kubernetes_verification_tpu_torch.ops.closure import (
    packed_pair_total,
    packed_row_counts,
)
from kubernetes_verification_tpu_torch.ops.kernels import (
    K_STEP,
    fused_ports_reach_reference,
    k_major,
    packed_dir_allow,
    packed_dir_allow_reference,
    packed_reach,
)
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError
from torch_parity import words

P, N = 40, 128


def _operands(seed=0, p=P, n=N):
    rng = np.random.default_rng(seed)
    a = (rng.random((p, n)) < 0.08).astype(np.int8)
    b = (rng.random((p, n)) < 0.08).astype(np.int8)
    niso = np.broadcast_to((rng.random(n) < 0.5).astype(np.int32), (8, n)).copy()
    return a, b, niso


def _jax_padded(x, tk=32):
    """JAX's kernel takes P in whole ``tk`` steps: pad with zero rows."""
    return jnp.asarray(np.pad(x, ((0, (tk - x.shape[0] % tk) % tk), (0, 0))))


@pytest.mark.parametrize("axis", [1, 0, -1])
def test_packed_dir_allow_matches_pallas_interpret(axis):
    a, b, niso = _operands()
    want = jax_packed_dir_allow(
        _jax_padded(a), _jax_padded(b), jnp.asarray(niso),
        tm=64, tn=64, tk=32, default_allow_axis=axis, interpret=True,
    )
    before = packed_dir_allow.launches
    got = packed_dir_allow(
        torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(niso),
        default_allow_axis=axis,
    )
    assert got.dtype == torch.int32 and got.shape == (N, N // 32)
    np.testing.assert_array_equal(words(got), words(want))
    # the CPU tensor took the plain version: no kernel launch counted
    assert packed_dir_allow.launches == before


@pytest.mark.parametrize("self_traffic", [True, False])
@pytest.mark.parametrize("default_allow", [True, False])
def test_packed_reach_matches_pallas_interpret(self_traffic, default_allow):
    ops = [_operands(seed)[:2] for seed in (1, 2)]
    (ing, sel_i), (sel_e, eg) = ops
    _, _, niso_i = _operands(3)
    _, _, niso_e = _operands(4)
    want = jax_packed_reach(
        *(_jax_padded(x) for x in (ing, sel_i, sel_e, eg)),
        jnp.asarray(niso_i), jnp.asarray(niso_e),
        tm=64, tn=64, tk=32, self_traffic=self_traffic,
        default_allow_unselected=default_allow, interpret=True,
    )
    got = packed_reach(
        *(torch.as_tensor(x) for x in (ing, sel_i, sel_e, eg, niso_i, niso_e)),
        self_traffic=self_traffic, default_allow_unselected=default_allow,
    )
    np.testing.assert_array_equal(words(got), words(want))


def test_zero_policy_rows_are_inert():
    a, b, niso = _operands(5)
    ref = packed_dir_allow(
        torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(niso),
        default_allow_axis=0,
    )
    pad = ((0, K_STEP), (0, 0))
    padded = packed_dir_allow(
        torch.as_tensor(np.pad(a, pad)), torch.as_tensor(np.pad(b, pad)),
        torch.as_tensor(niso), default_allow_axis=0,
    )
    assert torch.equal(ref, padded)
    empty = np.zeros((0, N), np.int8)
    none = packed_dir_allow_reference(
        torch.as_tensor(empty), torch.as_tensor(empty), torch.as_tensor(niso),
        default_allow_axis=-1,
    )
    assert not none.any()


def test_packed_dir_allow_rejects_bad_operands():
    a, b, niso = _operands()
    ta, tb, tn = torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(niso)
    with pytest.raises(ConfigError, match="multiple"):
        packed_dir_allow(ta[:, :96], tb[:, :96], tn[:, :96])
    with pytest.raises(ConfigError, match="int8"):
        packed_dir_allow(ta.to(torch.int32), tb, tn)
    with pytest.raises(ConfigError, match="default_allow_axis"):
        packed_dir_allow(ta, tb, tn, default_allow_axis=2)
    with pytest.raises(ConfigError, match="contiguous"):
        packed_dir_allow(ta, tb, torch.as_tensor(niso.T.copy()).T)


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(7)
    bits = rng.random((9, 96)) < 0.5
    bits[:, 31] = True  # the sign bit of the int32 word
    packed = pack_bool_cols(torch.as_tensor(bits))
    np.testing.assert_array_equal(words(packed), words(jax_pack(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        unpack_words_i8(packed, 96).numpy(),
        np.asarray(jax_unpack(jax_pack(jnp.asarray(bits)), 96)),
    )
    diag = or_diagonal(torch.zeros((40, 2), dtype=torch.int32))
    want = np.zeros((40, 64), bool)
    want[np.arange(40), np.arange(40)] = True
    np.testing.assert_array_equal(words(diag), words(jax_pack(jnp.asarray(want))))


def test_popcount_matches_jax():
    rng = np.random.default_rng(8)
    w = rng.integers(0, 2**32, size=(5000, 7), dtype=np.uint64).astype(np.uint32)
    w[0] = 0xFFFFFFFF
    got = packed_row_counts(torch.as_tensor(w.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_row_counts(jnp.asarray(w))))
    assert packed_pair_total(torch.as_tensor(w.view(np.int32))) == int(
        np.asarray(jax_row_counts(jnp.asarray(w))).astype(np.int64).sum()
    )


def test_k_major_is_the_padded_transpose():
    a = torch.as_tensor(_operands(10, p=70)[0])
    at = k_major(a)
    assert at.shape == (N, 128) and at.is_contiguous()
    assert torch.equal(at[:, :70], a.t()) and not at[:, 70:].any()
    assert k_major(a[:0]).shape == (N, K_STEP)


# ---------------------------------------------------------------------------
# Rehearsals of the Hopper kernels' index arithmetic (csrc/hopper_int8.cuh):
# numpy models of what each thread computes, held against the plain versions
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parents[1] / "kubernetes_verification_tpu_torch" / "csrc"


def _header_constant(name):
    """An ``int`` constant of the shared mainloop header (its default where
    a macro can override it)."""
    text = (_CSRC / "hopper_int8.cuh").read_text()
    return int(re.search(rf"#define HOPPER_INT8_{name} (\d+)", text).group(1))


def _fragment_coords(bn):
    """The wgmma s32 accumulator layout of a 64 x ``bn`` warpgroup tile:
    ``[4 warps, 32 lanes, bn/2 elements] -> (row, column)``."""
    w, lane, i = np.meshgrid(np.arange(4), np.arange(32), np.arange(bn // 2), indexing="ij")
    row = 16 * w + lane // 4 + 8 * ((i % 4) // 2)
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return row, col


def _lane_words(bits, bn):
    """``pack_rows`` then ``quad_or`` for each thread of a warpgroup: the
    thread's two rows' words, as uint32 ``[4, 32, 2, bn/32]``."""
    row, col = _fragment_coords(bn)
    i = np.arange(bn // 2)
    pos = (8 * ((i // 4) % 4) + i % 2)[None, None, :] + 2 * (np.arange(32) % 4)[None, :, None]
    part = np.zeros((4, 32, 2, bn // 32), np.uint64)
    vals = bits[row, col].astype(np.uint64) << pos.astype(np.uint64)
    for e in range(bn // 2):
        part[:, :, (e % 4) // 2, e // 16] |= vals[:, :, e]
    quad = part.reshape(4, 8, 4, 2, bn // 32)
    full = np.bitwise_or.reduce(quad, axis=2)  # the two xor shuffles
    return np.repeat(full[:, :, None], 4, axis=2).reshape(4, 32, 2, bn // 32).astype(np.uint32)


def _stored(words, bn):
    """The [64, bn/32] words ``store_rows`` writes: lane l stores word q of
    its rows l/4 and l/4 + 8 of its warp's 16 where q % 4 == l % 4."""
    out = np.full((64, bn // 32), -1, np.int64)
    for w in range(4):
        for lane in range(32):
            for h in range(2):
                for q in range(bn // 32):
                    if q % 4 == lane % 4:
                        r = 16 * w + lane // 4 + 8 * h
                        assert out[r, q] == -1  # each word stored once
                        out[r, q] = words[w, lane, h, q]
    assert (out >= 0).all()  # and every word stored
    return out.astype(np.uint32)


@pytest.mark.parametrize("bn", [128, 192, 256])
def test_accumulator_layout_covers_the_tile_once(bn):
    row, col = _fragment_coords(bn)
    flat = (row * bn + col).ravel()
    assert np.array_equal(np.sort(flat), np.arange(64 * bn))


@pytest.mark.parametrize("bn", [128, 192, 256])
def test_lane_pack_matches_pack_bool_cols(bn):
    """The epilogue's pack, straight from the accumulator layout: each lane
    ORs its 8 bits of a row's word into place and two shuffles within the
    quad finish it; it must give ``pack_bool_cols``'s words."""
    rng = np.random.default_rng(bn)
    bits = rng.random((64, bn)) < 0.4
    bits[:, 31] = True  # the sign bit of an int32 word
    got = _stored(_lane_words(bits, bn), bn)
    want = words(pack_bool_cols(torch.as_tensor(bits)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bn", [192, 128])  # W = 1, W = 2
def test_fused_epilogue_matches_the_plain_expansion(bn):
    """``fused_ports_reach``'s epilogue per element: its column's bit of the
    ballot word ``di`` (at the element's bit position in its lane), its row's
    ``de``, then the lane pack; it must equal pack(conj | di∧de | di∧ge |
    de∧gi), the plain version's expansion."""
    rng = np.random.default_rng(bn)
    conj, ge, gi = (rng.random((64, bn)) < p for p in (0.1, 0.5, 0.3))
    di = rng.random(bn) < 0.5
    de = rng.random(64) < 0.5
    di_w = words(pack_bool_cols(torch.as_tensor(di[None, :])))[0]  # the ballots
    row, col = _fragment_coords(bn)
    i = np.arange(bn // 2)[None, None, :]
    lane = np.arange(32)[None, :, None]
    bit = 8 * ((i // 4) % 4) + 2 * (lane % 4) + i % 2  # elem_bit
    col_bit = np.broadcast_to(((di_w[i // 16] >> bit.astype(np.uint32)) & 1).astype(bool), row.shape)
    np.testing.assert_array_equal(col_bit, di[col])  # the ballot bit is the column's
    rowe = de[row]
    reach = conj[row, col] | (col_bit & (rowe | ge[row, col])) | (rowe & gi[row, col])
    got = np.zeros((64, bn), bool)
    got[row, col] = reach
    want = conj | (di[None, :] & de[:, None]) | (di[None, :] & ge) | (de[:, None] & gi)
    np.testing.assert_array_equal(
        _stored(_lane_words(got, bn), bn), words(pack_bool_cols(torch.as_tensor(want)))
    )


def _tile_coords(t, tiles_m, tiles_n, group_m):
    per_group = group_m * tiles_n
    first = (t // per_group) * group_m
    size = min(tiles_m - first, group_m)
    r = t % per_group
    return first + r % size, r // size


@pytest.mark.parametrize("tiles_m,tiles_n", [(1, 1), (3, 2), (9, 5), (800, 400)])
def test_grouped_tile_order_is_a_bijection_with_l2_reuse(tiles_m, tiles_n):
    group_m = _header_constant("GROUP_M")
    coords = [_tile_coords(t, tiles_m, tiles_n, group_m) for t in range(tiles_m * tiles_n)]
    assert sorted(coords) == [(m, n) for m in range(tiles_m) for n in range(tiles_n)]
    # 132 tiles in flight (one block per SM) inside one group touch at most
    # GROUP_M row tiles and ~132 / GROUP_M column tiles, not one row tile and
    # 132 column tiles; a window across a group boundary, two groups' worth
    per_group = group_m * tiles_n
    for t0 in range(0, len(coords), 997):
        window = coords[t0 : t0 + 132]
        groups = {(t0 + i) // per_group for i in range(len(window))}
        assert len({m for m, _ in window}) <= group_m * len(groups)
        if len(groups) == 1:
            size = min(group_m, tiles_m - min(m for m, _ in window) // group_m * group_m)
            assert len({n for _, n in window}) <= -(-132 // size) + 1


def _kernel_walk(ends, steps):
    """The consumer's K walk in ``int8_kernel``: ring stages of two 64-column
    steps, two k32 wgmmas per step, a flush after the step that ends a plan
    row. Returns per wgmma ``(stage, k32 group, scale_d)`` and per flush
    ``(stage, k32 group of its last wgmma, plan row)``."""
    mmas, flushes, seg, zero = [], [], 0, True
    for ks in range((steps + 1) // 2):
        for h in range(2):
            step = 2 * ks + h
            if step >= steps:
                continue
            mmas += [(ks, 2 * h, 0 if zero else 1), (ks, 2 * h + 1, 1)]
            zero = False
            if seg < len(ends) and step + 1 == ends[seg]:
                flushes.append((ks, 2 * h + 1, seg))
                seg += 1
                zero = True
    return mmas, flushes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_walk_flushes_each_plan_row_once_at_its_step(seed):
    """Plan rows end on 64-column steps: a flush falls after the second k32
    wgmma of a 128-byte stage (mid-stage) or after the fourth, exactly once
    per row, and the segment's next wgmma starts with scale-d = 0."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 4, size=int(rng.integers(1, 30)))  # in steps
    ends = np.cumsum(lengths).tolist()
    mmas, flushes = _kernel_walk(ends, ends[-1])
    assert [f[2] for f in flushes] == list(range(len(ends)))
    for (stage, group, _), end in zip(flushes, ends):
        assert (stage, group) == ((end - 1) // 2, 1 if end % 2 else 3)
    assert any(g == 1 for _, g, _ in flushes) or all(e % 2 == 0 for e in ends)
    starts = {0} | {2 * e for e in ends[:-1]}  # first k32 group of each segment
    for idx, (stage, group, scale) in enumerate(mmas):
        assert scale == (0 if 4 * stage + group in starts else 1), idx
    assert len(mmas) == 2 * ends[-1]  # the zero half stage is never multiplied


def test_fused_walk_model_matches_the_plain_version():
    """The whole kernel, modelled in numpy: the K walk's per-k32 products with
    scale-d, the flush after the step that ends each segment, and the
    epilogue, against ``fused_ports_reach_reference`` on segments that end
    half-way through stages (exact)."""
    rng = np.random.default_rng(21)
    n, r = 128, 3
    segs = [(0, 0, 30), (0, 2, 64), (1, 3, 65), (2, 1, 1), (2, 2, 100), (3, 3, 64)]
    kp = sum(l + (-l) % K_STEP for *_, l in segs)
    at = np.zeros((n, kp), np.int8)
    bt = np.zeros((n, kp), np.int8)
    plan, off = [], 0
    for kind, slab, l in segs:
        at[:, off : off + l] = rng.random((n, l)) < 0.15
        bt[:, off : off + l] = rng.random((n, l)) < 0.15
        off += l + (-l) % K_STEP
        plan.append((off // K_STEP, kind, slab))
    ov = np.array([0b1001, 0b1110, 0b1100], np.int64)
    niso_i, niso_e = ((rng.random(n) < 0.5).astype(np.int32) for _ in range(2))
    ends = [e for e, _, _ in plan]
    mmas, flushes = _kernel_walk(ends, kp // K_STEP)
    assert sum(1 for _, g, _ in flushes if g == 1) >= 2  # mid-stage flushes
    a, b = at.astype(np.int64), bt.astype(np.int64)
    acc = np.zeros((n, n), np.int64)
    planes = np.zeros((n, n), np.int64)
    gi_any = np.zeros((n, n), bool)
    conj = np.zeros((n, n), bool)
    done = {(s, g): row for s, g, row in flushes}
    k0 = 0
    for stage, group, scale in mmas:
        cols = slice(128 * stage + 32 * group, 128 * stage + 32 * group + 32)
        acc = a[:, cols] @ b[:, cols].T + (acc if scale else 0)
        row = done.get((stage, group))
        if row is None:
            continue
        end, kind, slab = plan[row]
        np.testing.assert_array_equal(acc, a[:, k0 : end * 64] @ b[:, k0 : end * 64].T)
        k0 = end * 64
        ok = acc > 0
        if kind <= 1:
            planes |= ok.astype(np.int64) << slab
        else:
            mask = int(ov[slab]) if kind == 2 else (1 << (r + 1)) - 1
            conj |= ok & ((planes & mask) != 0)
            gi_any |= ok
    ops = [torch.as_tensor(x) for x in (at, bt, np.asarray(plan, np.int32), ov, niso_i, niso_e)]
    for da in (True, False):
        reach = conj.copy()
        if da:
            di, de = niso_i[None, :] > 0, niso_e[:, None] > 0
            reach |= (di & de) | (di & (planes != 0)) | (de & gi_any)
        want = fused_ports_reach_reference(*ops, default_allow=da)
        np.testing.assert_array_equal(words(pack_bool_cols(torch.as_tensor(reach))), words(want))


def test_build_hash_covers_the_included_header(tmp_path, monkeypatch):
    """An edited ``hopper_int8.cuh`` must give both kernels a new library
    name, so a stale build is never loaded."""
    from kubernetes_verification_tpu_torch.ops import cuda_build

    for f in _CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(cuda_build, "SOURCES", {
        name: str(tmp_path / f"{name}.cu") for name in cuda_build.SOURCES
    })
    for name in cuda_build.SOURCES:
        assert [Path(p).name for p in cuda_build._sources(cuda_build.SOURCES[name])] == [
            f"{name}.cu", "hopper_int8.cuh"
        ]
    before = {name: cuda_build._target(name) for name in cuda_build.SOURCES}
    header = tmp_path / "hopper_int8.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: cuda_build._target(name) for name in cuda_build.SOURCES}
    assert all(before[name] != after[name] for name in before)
