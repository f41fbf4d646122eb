"""The port's closures and path queries (``ops/closure.py``) against the JAX
package's on the same seeded matrices, on the CPU. Exact: every output is
packed words, bools or hop counts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_verification_tpu.ops import closure as jc
from kubernetes_verification_tpu.resilience.errors import ConfigError as JaxConfigError
from kubernetes_verification_tpu_torch.ops import closure as tc
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError
from torch_parity import words


def _graph(n: int, degree: float, seed: int) -> np.ndarray:
    """bool [n, n] with about ``degree`` out-edges per row."""
    rng = np.random.default_rng(seed)
    return rng.random((n, n)) < degree / max(n, 1)


def _pack(dense: np.ndarray) -> np.ndarray:
    """bool [n, n] (n % 32 == 0) → the reference's uint32 [n, n/32]."""
    return np.packbits(dense, axis=1, bitorder="little").view("<u4").copy()


def _t(w: np.ndarray) -> torch.Tensor:
    """uint32 host words → the port's int32 words on the CPU."""
    return torch.as_tensor(np.array(w, dtype="<u4").view(np.int32))


def _blocks(n: int, block: int, degree: float, seed: int) -> np.ndarray:
    """A graph of disjoint ``block``-node components: a change inside one
    leaves the other components' closure rows untouched."""
    g = np.zeros((n, n), dtype=bool)
    for i, b0 in enumerate(range(0, n, block)):
        g[b0 : b0 + block, b0 : b0 + block] = _graph(block, degree, seed + i)
    return g


@pytest.mark.parametrize("n,tile,dst_tile", [
    (32, 7168, 14336),  # one tile
    (96, 64, 64),  # 64 does not divide 96: both snap to 32
    (224, 64, 96),  # row tile 32, stripe 32 (96 does not divide 224)
    (512, 128, 256),  # tiles that divide N: 4 × 2 products per pass
])
@pytest.mark.parametrize("degree", [1.2, 3.0])
def test_packed_closure_matches_jax(n, tile, dst_tile, degree):
    w = _pack(_graph(n, degree, n))
    want = jc.packed_closure(jnp.asarray(w), tile=tile, dst_tile=dst_tile)
    got = tc.packed_closure(_t(w), tile=tile, dst_tile=dst_tile)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(words(got), words(want))
    # and it is the dense closure
    dense = np.asarray(jc.transitive_closure(jnp.asarray(_graph(n, degree, n))))
    np.testing.assert_array_equal(words(got), _pack(dense))


@pytest.mark.parametrize("max_iter", [0, 1, 2])
def test_packed_closure_max_iter_caps(max_iter):
    w = _pack(_graph(224, 1.1, 5))
    want = jc.packed_closure(jnp.asarray(w), tile=64, max_iter=max_iter)
    got = tc.packed_closure(w, tile=64, max_iter=max_iter, device="cpu")
    np.testing.assert_array_equal(words(got), words(want))


def test_packed_closure_reports_each_pass():
    w = _pack(_graph(96, 1.2, 3))
    seen = []
    got = tc.packed_closure(
        _t(w), on_pass=lambda i, p, pairs: seen.append((i, words(p).copy(), pairs))
    )
    assert [i for i, _, _ in seen] == list(range(1, len(seen) + 1))
    assert seen[-1][2] == seen[-2][2]  # stops on the pass that adds no pair
    np.testing.assert_array_equal(seen[-1][1], words(got))
    first = jc._packed_square_step(jnp.asarray(w), row_tile=96, dst_tile=96)
    np.testing.assert_array_equal(seen[0][1], words(first))


def test_packed_closure_edges():
    zero = np.zeros((64, 2), np.uint32)
    np.testing.assert_array_equal(words(tc.packed_closure(zero, device="cpu")), zero)
    empty = tc.packed_closure(np.zeros((0, 0), np.uint32), device="cpu")
    assert tuple(empty.shape) == (0, 0)
    with pytest.raises(JaxConfigError, match="square in bits"):
        jc.packed_closure(np.zeros((64, 1), np.uint32))
    with pytest.raises(ConfigError, match="square in bits"):
        tc.packed_closure(np.zeros((64, 1), np.uint32), device="cpu")


@pytest.mark.parametrize("n", [1, 5, 37, 64])
def test_transitive_closure_matches_jax(n):
    g = _graph(n, 1.3, n + 100)
    want = np.asarray(jc.transitive_closure(jnp.asarray(g)))
    got = tc.transitive_closure(torch.as_tensor(g))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(tc.transitive_closure(np.zeros((0, 0), bool), device="cpu").shape) == (0, 0)


@pytest.mark.parametrize("hops", [None, 1, 2, 3])
@pytest.mark.parametrize("want_hops", [True, False])
@pytest.mark.parametrize("seeds", ["one", "all", "some"])
def test_bounded_packed_closure_matches_jax(hops, want_hops, seeds):
    n = 224
    w = _pack(_graph(n, 1.5, 9))
    idx = {"one": [17], "all": np.arange(n), "some": [0, 5, 5, 223, 100]}[seeds]
    acc_j, hop_j = jc.bounded_packed_closure(
        jnp.asarray(w), idx, hops=hops, tile=64, want_hops=want_hops
    )
    acc_t, hop_t = tc.bounded_packed_closure(
        _t(w), idx, hops=hops, tile=64, want_hops=want_hops
    )
    np.testing.assert_array_equal(words(acc_t), words(acc_j))
    if want_hops:
        np.testing.assert_array_equal(hop_t, hop_j)
    else:
        assert hop_t is None and hop_j is None
    if hops is None:  # the closure rows of the seeds
        full = words(tc.packed_closure(_t(w)))
        np.testing.assert_array_equal(words(acc_t), full[np.asarray(idx)])


def test_bounded_packed_closure_edges():
    w = _pack(_graph(64, 1.5, 2))
    for bad in ([-1], [64], [3, 70]):
        with pytest.raises(ConfigError, match="seeds outside"):
            tc.bounded_packed_closure(_t(w), bad)
    acc, hop = tc.bounded_packed_closure(_t(w), [])
    assert tuple(acc.shape) == (0, 2) and hop.shape == (0, 64)
    acc, hop = tc.bounded_packed_closure(_t(w), [1, 2], hops=0)
    np.testing.assert_array_equal(words(acc), w[[1, 2]])
    with pytest.raises(ConfigError, match="square in bits"):
        tc.bounded_packed_closure(_t(w[:32]), [0])


@pytest.mark.parametrize("hops", [None, 1, 2, 4])
@pytest.mark.parametrize("chunk", [3, 2048])
def test_bounded_closure_rows_matches_jax(hops, chunk):
    g = _graph(70, 1.4, 4)
    seeds = [0, 3, 69, 3]
    want = jc.bounded_closure_rows(lambda i: g[i], seeds, 70, hops=hops, chunk=chunk)
    got = tc.bounded_closure_rows(
        lambda i: g[i], seeds, 70, hops=hops, chunk=chunk, device="cpu"
    )
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # an oracle that answers with tensors gives the same rows
    got_t = tc.bounded_closure_rows(
        lambda i: torch.as_tensor(g[i]), seeds, 70, hops=hops, chunk=chunk,
        device="cpu",
    )
    for a, b in zip(got_t, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ConfigError):
        tc.bounded_closure_rows(lambda i: g[i], [70], 70, device="cpu")
    acc, hop = tc.bounded_closure_rows(lambda i: g[i], [], 70, device="cpu")
    assert acc.shape == (0, 70) and hop.shape == (0, 70)


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_path_upto_dense_and_packed_match_jax(hops):
    g = _graph(50, 1.6, 8)
    want = np.asarray(jc.path_upto(jnp.asarray(g), hops))
    got = tc.path_upto(torch.as_tensor(g), hops)
    assert got.dtype == torch.bool and tuple(got.shape) == (50, 50)
    np.testing.assert_array_equal(got.numpy(), want)
    w = _pack(_graph(96, 1.6, 8))
    want_p = jc.path_upto(jnp.asarray(w), hops)
    got_p = tc.path_upto(_t(w), hops)
    assert got_p.dtype == torch.int32
    np.testing.assert_array_equal(words(got_p), words(want_p))
    host_p = tc.path_upto(w, hops, device="cpu")  # host uint32 words: packed too
    np.testing.assert_array_equal(words(host_p), words(want_p))


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tc, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(tc, name, spy)
    return calls


def _delta_case(route: str):
    """``(base, new_base, dirty, prev_base)`` for one route of
    ``packed_closure_delta``."""
    n = 224
    rng = np.random.default_rng(31)
    base = _blocks(n, 32, 1.3, 40)
    new = base.copy()
    if route == "additions":
        for s, d in rng.integers(0, n, (6, 2)):
            new[s, d] = True
        return base, new, new.any(axis=1) != base.any(axis=1), base
    if route == "suspect":  # removals inside one component
        rows, cols = np.nonzero(base[64:96, 64:96])
        new[rows[:3] + 64, cols[:3] + 64] = False
        new[70, 90] = True
    else:  # "dense": removals in a graph where every row is suspect
        base = _graph(n, 6.0, 41)
        new = base.copy()
        rows, cols = np.nonzero(base)
        new[rows[:5], cols[:5]] = False
    dirty = np.zeros(n, bool)
    changed = base != new
    dirty[np.nonzero(changed.any(axis=1))[0]] = True
    dirty[np.nonzero(changed.any(axis=0))[0]] = True
    return base, new, dirty, None


@pytest.mark.parametrize("route,step", [
    ("additions", "_add_edges_round"),
    ("suspect", "_closure_rows_step"),
    ("dense", "packed_closure"),
])
@pytest.mark.parametrize("row_group", [32, 2048])
def test_packed_closure_delta_matches_jax(monkeypatch, route, step, row_group):
    base, new, dirty, prev_base = _delta_case(route)
    if route == "additions":
        dirty = np.zeros(len(base), bool)  # unused by the additions route
    wb, wn = _pack(base), _pack(new)
    prev = jc.packed_closure(jnp.asarray(wb))
    kw = dict(row_group=row_group)
    if prev_base is not None:
        kw["prev_base"] = _pack(prev_base)
    want = jc.packed_closure_delta(jnp.asarray(wn), prev, dirty, **kw)
    calls = _spy(monkeypatch, step)
    if "prev_base" in kw:
        kw["prev_base"] = _t(kw["prev_base"])
    got = tc.packed_closure_delta(_t(wn), _t(words(prev)), dirty, **kw)
    assert calls, f"the {route} route did not run {step}"
    np.testing.assert_array_equal(words(got), words(want))
    np.testing.assert_array_equal(words(got), words(jc.packed_closure(jnp.asarray(wn))))


def test_packed_closure_delta_checks_its_inputs():
    w = _pack(_graph(64, 1.0, 1))
    with pytest.raises(ConfigError, match="previous closure shape"):
        tc.packed_closure_delta(_t(w), _t(w[:32]), np.zeros(64, bool))
    with pytest.raises(ConfigError, match="dirty mask"):
        tc.packed_closure_delta(_t(w), _t(w), np.zeros(63, bool))
    # no base bit gained: the previous closure ∨ the base, unchanged
    closed = tc.packed_closure(_t(w))
    same = tc.packed_closure_delta(_t(w), closed, np.zeros(64, bool), prev_base=_t(w))
    assert torch.equal(same, closed)


@pytest.mark.parametrize("m,k,d", [(1, 40, 24), (16, 33, 5), (17, 8, 8), (0, 0, 0), (40, 64, 200)])
def test_bool_dot_pads_to_the_int_mm_rules(m, k, d):
    rng = np.random.default_rng(m + k + d)
    a = (rng.random((m, k)) < 0.5).astype(np.int8)
    bt = (rng.random((d, k)) < 0.5).astype(np.int8)
    got = tc.bool_dot(torch.as_tensor(a), torch.as_tensor(bt))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, d)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ bt.T.astype(np.int64))
