"""The posture ops of the port (``ops/posture.py``) on the CPU, against the JAX
package's on seeded random words (exact: every output is integer or bit
words), with forced ties for ``topk_changed_rows``, and on a packed engine's
generation-over-generation diff."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.ops import posture as jax_posture
from kubernetes_verification_tpu_torch.ops import posture
from kubernetes_verification_tpu_torch.ops.bits import to_host_words, unpack_cols
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError


def _words(rng, rows, words, density=0.5):
    """uint32 [rows, words] with about ``density`` of the bits set."""
    bits = rng.random((rows, words * 32)) < density
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(words.view(np.int32).copy())


@pytest.mark.parametrize("shape", [(1, 1), (67, 5), (130, 33)])
def test_packed_xor_popcount_and_row_popcount_match_jax(shape):
    rng = np.random.default_rng(shape[0])
    prev = _words(rng, *shape)
    cur = prev.copy()
    flip = rng.random(prev.shape) < 0.3
    cur[flip] = _words(rng, *shape)[flip]
    got = posture.packed_xor_popcount(_t(prev), _t(cur))
    want = jax_posture.packed_xor_popcount(jnp.asarray(prev), jnp.asarray(cur))
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.int32
        assert to_host_words(g).tobytes() == np.asarray(w).tobytes()
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        posture.packed_row_popcount(_t(cur)).numpy(),
        np.asarray(jax_posture.packed_row_popcount(jnp.asarray(cur))))
    # the planes ARE the delta: unpacked, widened = cur & ~prev
    n = shape[1] * 32
    np.testing.assert_array_equal(
        unpack_cols(to_host_words(got[0]), n),
        unpack_cols(cur, n) & ~unpack_cols(prev, n))
    np.testing.assert_array_equal(got[2].numpy(), unpack_cols(to_host_words(got[0]), n).sum(1))


def test_packed_xor_popcount_refuses_mismatched_shapes():
    with pytest.raises(ConfigError, match="shape"):
        posture.packed_xor_popcount(torch.zeros((3, 2), dtype=torch.int32),
                                    torch.zeros((3, 1), dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_changed_rows_breaks_ties_to_the_lower_row(seed):
    rng = np.random.default_rng(seed)
    # few distinct values over many rows: every k cuts through a tie
    counts = rng.integers(0, 4, 97).astype(np.int32)
    counts[[5, 40, 90]] = 9  # a tie at the top
    for k in (0, 1, 2, 3, 8, 50, 97):
        gv, gi = posture.topk_changed_rows(torch.as_tensor(counts), k)
        wv, wi = jax_posture.topk_changed_rows(jnp.asarray(counts), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv), err_msg=f"k={k}")
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi), err_msg=f"k={k}")
        assert gi.dtype == torch.int32 and gv.dtype == torch.int32
    assert posture.topk_changed_rows(torch.as_tensor(counts), 3)[1].tolist() == [5, 40, 90]
    with pytest.raises(ConfigError, match="k=98"):
        posture.topk_changed_rows(torch.as_tensor(counts), 98)


@pytest.mark.parametrize("groups", [1, 4, 21])
def test_ns_word_masks_and_ns_pair_counts_match_jax(groups):
    rng = np.random.default_rng(groups)
    rows, words = 90, 4
    cols = words * 32 - 7  # padding columns past the real ones
    col_ns = rng.integers(-1, groups, cols)
    masks = posture.ns_word_masks(col_ns, groups, words)
    np.testing.assert_array_equal(masks, jax_posture.ns_word_masks(col_ns, groups, words))
    delta = _words(rng, rows, words, density=0.2)
    row_ns = rng.integers(0, groups + 1, rows).astype(np.int32)  # groups = pad rows
    got = posture.ns_pair_counts(_t(delta), masks, row_ns, groups)
    want = jax_posture.ns_pair_counts(
        jnp.asarray(delta), jnp.asarray(masks), jnp.asarray(row_ns), groups)
    assert got.dtype == torch.int32 and got.shape == (groups, groups)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # device masks (int32) and device row namespaces give the same counts
    again = posture.ns_pair_counts(_t(delta), _t(masks), torch.as_tensor(row_ns), groups)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    # against a plain count over the unpacked bits
    bits = unpack_cols(delta, words * 32)[:, :cols]
    plain = np.zeros((groups, groups), dtype=np.int64)
    for r, c in zip(*np.nonzero(bits)):
        if row_ns[r] < groups and col_ns[c] >= 0:
            plain[row_ns[r], col_ns[c]] += 1
    np.testing.assert_array_equal(got.numpy(), plain)


def test_changed_columns_matches_jax_and_caps():
    rng = np.random.default_rng(7)
    row = _words(rng, 1, 6, density=0.3)[0]
    for cap in (0, 3, 1000):
        want = jax_posture.changed_columns(row, cap)
        np.testing.assert_array_equal(posture.changed_columns(row, cap), want)
        np.testing.assert_array_equal(posture.changed_columns(_t(row[None])[0], cap), want)


def test_posture_diff_of_a_packed_engine_generation():
    """The words before and after one policy op and one pod relabel of the
    packed engine: the planes, their row counts and the namespace-pair
    counts equal a host computation on the unpacked matrices."""
    c = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=150, n_policies=12, n_namespaces=5, seed=9, p_ipblock_peer=0.0))
    eng = kvt.PackedIncrementalVerifier(c, device="cpu")
    prev = eng._packed.clone()
    # a policy that isolates a whole namespace for ingress
    eng.add_policy(kvt.NetworkPolicy("deny-ns1", namespace="ns1", pod_selector=kvt.Selector(),
                                     ingress=(), policy_types=("Ingress",)))
    eng.update_pod_labels(17, dict(c.pods[3].labels))
    cur = eng._packed
    wid, nar, rw, rn = posture.packed_xor_popcount(prev, cur)
    n, Np = eng.n_pods, eng._n_padded
    hp, hc = unpack_cols(to_host_words(prev), Np), unpack_cols(to_host_words(cur), Np)
    np.testing.assert_array_equal(unpack_cols(to_host_words(wid), Np), hc & ~hp)
    np.testing.assert_array_equal(unpack_cols(to_host_words(nar), Np), hp & ~hc)
    np.testing.assert_array_equal(rw.numpy(), (hc & ~hp).sum(1))
    np.testing.assert_array_equal(rn.numpy(), (hp & ~hc).sum(1))
    assert rn.sum() > 0
    ns_index = {ns.name: i for i, ns in enumerate(eng.namespaces)}
    G = len(ns_index)
    col_ns = np.array([ns_index[p.namespace] for p in eng.pods])
    row_ns = np.full(Np, G, dtype=np.int32)
    row_ns[:n] = col_ns
    masks = posture.ns_word_masks(col_ns, G, Np // 32)
    got = posture.ns_pair_counts(wid | nar, masks, row_ns, G).numpy()
    changed = (hc ^ hp)[:n, :n]
    plain = np.zeros((G, G), dtype=np.int64)
    np.add.at(plain, (col_ns[np.nonzero(changed)[0]], col_ns[np.nonzero(changed)[1]]), 1)
    np.testing.assert_array_equal(got, plain)
    vals, rows = posture.topk_changed_rows(rw + rn, 8)
    order = np.argsort(-(rw + rn).numpy(), kind="stable")[:8]
    np.testing.assert_array_equal(rows.numpy(), order)
