"""The port-bitmap path of the port (``ops/tiled_ports.py``) and its kernel's
plain version (``ops/kernels.py::fused_ports_reach_reference``) against the
JAX package, on carried multi-atom encodings with named and container ports.
Exact everywhere: every output is boolean or integer words.

The two routes pad N differently (the sweep to its tile, the kernel route to
a multiple of the kernel tile as well), so words are compared over the first
⌈n/32⌉ columns, and every pad word must be zero."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_verification_tpu.encode.encoder import encode_cluster as jax_encode
from kubernetes_verification_tpu.harness.generate import (
    GeneratorConfig as JaxGeneratorConfig,
)
from kubernetes_verification_tpu.harness.generate import (
    random_cluster as jax_random_cluster,
)
from kubernetes_verification_tpu.ops import tiled as jax_tiled_mod
from kubernetes_verification_tpu.ops.pallas_kernels import fused_ports_stripe
from kubernetes_verification_tpu.ops.tiled import tiled_k8s_reach as jax_tiled
from kubernetes_verification_tpu.parallel.sharded_ops import pad_grants as jax_pad_grants
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.encode.encoder import (
    FrozenBankMiss,
    encode_cluster,
    encode_policy_delta,
)
from kubernetes_verification_tpu_torch.encode.ports import compute_port_atoms, named_resolution
from kubernetes_verification_tpu_torch.ops import tiled_ports
from kubernetes_verification_tpu_torch.ops.bits import pack_bool_cols
from kubernetes_verification_tpu_torch.ops.kernels import (
    FUSED_MAX_MASKS,
    K_STEP,
    fused_ports_reach,
    fused_ports_reach_reference,
)
from kubernetes_verification_tpu_torch.ops.padding import pad_grants
from kubernetes_verification_tpu_torch.ops.tiled import tiled_k8s_reach
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError
from torch_parity import carried, carry, words

_FLAGS = [
    {},
    dict(self_traffic=False),
    dict(default_allow_unselected=False),
    dict(direction_aware_isolation=False),
]
_FLAG_IDS = ["default", "no-self", "no-default-allow", "no-direction"]


def _gen(n_pods, seed, n_policies=9):
    return dict(
        n_pods=n_pods, n_policies=n_policies, n_namespaces=3, p_ports=0.8,
        p_named_port=0.3, p_container_ports=0.5, seed=seed, compute_ports=True,
    )


def _ported(n_pods, seed, **kw):
    jenc, penc = carried(**_gen(n_pods, seed, **kw))
    assert len(penc.atoms) > 1 and penc.restrict_bank is not None
    return jenc, penc


def _assert_same(got, want, n):
    """Words over the real columns, zero pad words, isolation vectors."""
    w = -(-n // 32)
    g, j = words(got.packed), words(want.packed)
    np.testing.assert_array_equal(g[:, :w], j[:, :w])
    assert not g[:, w:].any() and not j[:, w:].any()
    np.testing.assert_array_equal(got.ingress_isolated, np.asarray(want.ingress_isolated))
    np.testing.assert_array_equal(got.egress_isolated, np.asarray(want.egress_isolated))


def _assert_blocks_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            _assert_blocks_equal(g, w)
        else:
            assert (g is None) == (w is None), f.name
            if w is not None:
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=f.name)


# ---------------------------------------------------------------------------
# host layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [7, 21, 33])
@pytest.mark.parametrize("headroom", [0, 3])
def test_split_and_layout_match_jax(seed, headroom):
    jenc, penc = _ported(90, seed)
    ji, je, jr = jax_tiled_mod._split_and_check_port_masks(jenc.ingress, jenc.egress, 128)
    pi, pe, pr = tiled_ports._split_and_check_port_masks(penc.ingress, penc.egress, 128)
    assert pr == jr
    # row duplication carries every leaf: ports, dst_restrict, rule_id, peer_id
    _assert_blocks_equal(pi, ji)
    _assert_blocks_equal(pe, je)
    assert pi.n > penc.ingress.n  # the run split did duplicate rows
    _assert_layouts_equal(ji, je, pi, pe, penc.n_policies, headroom, jr)


def _assert_layouts_equal(ji, je, pi, pe, P, headroom, R):
    """Pad both packages' split blocks to a multiple of 8 (one row at
    least, so the sink row is used) and hold the port's
    ``_build_port_layout`` to the JAX package's, array for array and dtype
    for dtype."""
    ji, je = (jax_pad_grants(b, 8 - b.n % 8, P, 0) for b in (ji, je))
    pi, pe = (pad_grants(b, 8 - b.n % 8, P, 0) for b in (pi, pe))

    def layout(mod, i, e):
        def restrict(b):
            return None if b.dst_restrict is None else np.asarray(b.dst_restrict)

        return mod._build_port_layout(
            np.asarray(i.ports), np.asarray(e.ports), np.asarray(i.pol),
            np.asarray(e.pol), sink_pol=P, ing_restrict=restrict(i),
            eg_restrict=restrict(e), headroom=headroom,
        )

    want = layout(jax_tiled_mod, ji, je)
    got = layout(tiled_ports, pi, pe)
    assert tuple(got[0]) == tuple(want[0])  # the PortLayout, field by field
    assert got[0].n_masks == R
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _synthetic_ports(G: int, Q: int, seed: int) -> np.ndarray:
    """bool [G, Q] port masks: every ninth row all-True, all-False or one
    atom; the rest unions of 1–3 runs from a library that has runs at atom
    0 and at atom Q − 1 and ones touching both, so rows split, repeat, and
    (Q > 64) differ only past the first word."""
    rng = np.random.default_rng(seed)
    lib = [(0, 0), (Q - 1, Q - 1), (0, 2), (Q - 3, Q - 1), (0, Q - 2), (1, Q - 1)]
    for _ in range(12):
        lo = int(rng.integers(0, Q))
        lib.append((lo, int(rng.integers(lo, min(Q, lo + 9)))))
    out = np.zeros((G, Q), dtype=bool)
    for g in range(G):
        kind = g % 9
        if kind == 0:
            out[g] = True
        elif kind == 2:
            out[g, rng.integers(0, Q)] = True
        elif kind != 1:  # kind 1 stays all-False
            for k in rng.choice(len(lib), size=int(rng.integers(1, 4)), replace=False):
                lo, hi = lib[k]
                out[g, lo : hi + 1] = True
    return out


@pytest.fixture(scope="module")
def wide_pair():
    """A generated cluster with ~1,900 grant rows after the run split, R >
    1 in both directions."""
    return _ported(240, 11, n_policies=400)


def _with_ports(jenc, penc, q):
    """Both packages' grant blocks, with ``_synthetic_ports`` of width
    ``q`` in place of the encoded masks unless ``q`` is ``"generated"``."""
    blocks = (jenc.ingress, jenc.egress, penc.ingress, penc.egress)
    if q == "generated":
        return blocks
    masks = [_synthetic_ports(b.n, q, seed) for seed, b in enumerate(blocks[2:])]
    masks = masks + [m.copy() for m in masks]
    return tuple(dataclasses.replace(b, ports=m) for b, m in zip(blocks, masks))


@pytest.mark.parametrize("headroom", [0, 128])
@pytest.mark.parametrize("q", ["generated", 13, 64, 70, 130])
def test_packed_key_split_and_layout_match_jax(wide_pair, q, headroom):
    """The packed-key grouping, the vectorised run split and the VP layout
    against the JAX package's loops and ``np.unique(axis=0)``: a generated
    cluster, and synthetic masks of Q not a multiple of 8, of one full word
    and of two and three words."""
    jenc, penc = wide_pair
    ji, je, pi, pe = _with_ports(jenc, penc, q)
    limit = 1 << 20  # the synthetic masks' R is over the path's cap
    ji, je, jr = jax_tiled_mod._split_and_check_port_masks(ji, je, limit)
    pi, pe, pr = tiled_ports._split_and_check_port_masks(pi, pe, limit)
    assert pr == jr > 1
    _assert_blocks_equal(pi, ji)
    _assert_blocks_equal(pe, je)
    assert pi.n + pe.n > 1000
    for b in (pi, pe):  # every direction has split rows and ported masks
        ports = np.asarray(b.ports)
        ported = ports[ports.any(axis=1) & ~ports.all(axis=1)]
        assert len(np.unique(ported, axis=0)) > 1
    assert pi.n > penc.ingress.n and pe.n > penc.egress.n
    both = np.concatenate([pi.ports, pe.ports])
    masks, inverse = np.unique(both, axis=0, return_inverse=True)
    first, got_inverse = tiled_ports._unique_rows(both)
    np.testing.assert_array_equal(both[first], masks)
    np.testing.assert_array_equal(got_inverse, inverse.reshape(-1))
    _assert_layouts_equal(ji, je, pi, pe, penc.n_policies, headroom, jr)


@pytest.mark.parametrize("q", ["generated", 70])
def test_split_without_multi_run_rows_is_the_same_object(wide_pair, q):
    """A block whose rows are each one run, empty or full comes back as the
    very object passed in (the engines split a change's rows on every
    change)."""
    _, _, pi, _ = _with_ports(*wide_pair, q)
    ports = np.asarray(pi.ports)
    starts = ports & ~np.concatenate([np.zeros((pi.n, 1), bool), ports[:, :-1]], 1)
    one = np.nonzero(starts.sum(axis=1) <= 1)[0]
    if q != "generated":
        assert ports[one].all(axis=1).any() and (~ports[one].any(axis=1)).any()
    block = tiled_ports._take_rows(pi, one)
    assert tiled_ports._split_grant_ports(block) is block


#: row picks of one and two grants, the engines' per-change shape: a
#: multi-run grant, a named-port grant (a ``dst_restrict`` row) and a full
#: one, alone and in pairs
_SMALL_BLOCKS = [("multi",), ("multi", "named"), ("named", "multi"), ("multi", "multi2"),
                 ("full", "multi"), ("named",)]


@pytest.mark.parametrize("pick", _SMALL_BLOCKS, ids=lambda p: "+".join(p))
def test_small_block_split_matches_jax(wide_pair, pick):
    jenc, penc = wide_pair
    jb, pb = jenc.ingress, penc.ingress
    ports = np.asarray(pb.ports)
    starts = ports & ~np.concatenate([np.zeros((pb.n, 1), bool), ports[:, :-1]], 1)
    multi = np.nonzero(starts.sum(axis=1) > 1)[0]
    rows = dict(
        multi=multi[0], multi2=multi[-1],
        named=np.nonzero(np.asarray(pb.dst_restrict) > 0)[0][0],
        full=np.nonzero(ports.all(axis=1))[0][0],
    )
    idx = np.asarray([rows[k] for k in pick])
    want = jax_tiled_mod._split_grant_ports(
        jax.tree.map(lambda x: np.asarray(x)[idx], jb)
    )
    got = tiled_ports._split_grant_ports(tiled_ports._take_rows(pb, idx))
    for leaf in ("dst_restrict", "rule_id", "peer_id"):
        assert getattr(got, leaf) is not None, leaf
    _assert_blocks_equal(got, want)
    assert got.n == want.n


@pytest.mark.parametrize("q", ["generated", 70])
def test_port_mask_cap_at_r_minus_one_and_r(wide_pair, q):
    ji, je, pi, pe = _with_ports(*wide_pair, q)
    _, _, R = tiled_ports._split_and_check_port_masks(pi, pe, 1 << 20)
    with pytest.raises(ValueError):
        jax_tiled_mod._split_and_check_port_masks(ji, je, R - 1)
    with pytest.raises(ConfigError, match=f"cap of {R - 1}"):
        tiled_ports._split_and_check_port_masks(pi, pe, R - 1)
    assert tiled_ports._split_and_check_port_masks(pi, pe, R)[2] == R


def test_port_mask_cap_raises(monkeypatch):
    jenc, penc = _ported(90, 7)
    _, _, R = tiled_ports._split_and_check_port_masks(penc.ingress, penc.egress, 128)
    with pytest.raises(ValueError):
        jax_tiled_mod._split_and_check_port_masks(jenc.ingress, jenc.egress, R - 1)
    with pytest.raises(ConfigError, match=f"cap of {R - 1}"):
        tiled_ports._split_and_check_port_masks(penc.ingress, penc.egress, R - 1)
    monkeypatch.setattr(tiled_ports, "_MAX_PORT_MASKS", R - 1)
    with pytest.raises(ConfigError, match=f"cap of {R - 1}"):
        tiled_k8s_reach(penc, device="cpu")
    monkeypatch.setattr(tiled_ports, "_MAX_PORT_MASKS", R)
    assert tiled_k8s_reach(penc, device="cpu").n_pods == 90


def test_peers_by_slot_matches_jax():
    from kubernetes_verification_tpu.ops.tiled import _peers_by_slot as jax_peers
    from kubernetes_verification_tpu_torch.ops.match import as_tensors
    from kubernetes_verification_tpu_torch.ops.tiled import _peers_by_slot, _with_sink

    jenc, penc = _ported(70, 21)
    P, chunk = penc.n_policies, 8
    jb = jax_pad_grants(jenc.egress, (chunk - jenc.egress.n % chunk) % chunk, P, 0)
    pb = pad_grants(penc.egress, (chunk - penc.egress.n % chunk) % chunk, P, 0)
    slots = np.random.default_rng(0).integers(0, 5, size=pb.n).astype(np.int32)
    want = jax_peers(
        jb, jnp.asarray(slots), 5, chunk, jnp.asarray(jenc.pod_kv),
        jnp.asarray(jenc.pod_key), jnp.asarray(jenc.ns_kv), jnp.asarray(jenc.ns_key),
        jnp.asarray(jenc.pod_ns), jnp.asarray(jenc.pol_ns),
    )
    t = torch.as_tensor
    got = _peers_by_slot(
        as_tensors(pb, "cpu"), t(slots), 5, chunk, t(penc.pod_kv), t(penc.pod_key),
        t(penc.ns_kv), t(penc.ns_key), t(penc.pod_ns), _with_sink(t(penc.pol_ns)),
    )
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the whole path, both routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pods,seed", [(61, 7), (100, 21)])
@pytest.mark.parametrize("flags", _FLAGS, ids=_FLAG_IDS)
def test_sweep_matches_jax_xla(n_pods, seed, flags):
    jenc, penc = _ported(n_pods, seed)
    kw = dict(tile=32, chunk=8, **flags)  # tile < N: several dst tiles
    want = jax_tiled(jenc, use_pallas=False, **kw)
    got = tiled_k8s_reach(penc, device="cpu", **kw)
    assert got.meta == {"kernel": "torch-ports-sweep"}
    _assert_same(got, want, n_pods)
    np.testing.assert_array_equal(got.selected, np.asarray(want.selected))
    lazy = tiled_k8s_reach(penc, device="cpu", fetch=False, **kw)
    assert lazy.timings["reachable_pairs"] == int(want.out_degree().sum())


@pytest.mark.parametrize("flags", _FLAGS[:3:2], ids=_FLAG_IDS[:3:2])
def test_kernel_route_matches_jax_pallas_interpret(flags):
    # a cluster whose ingress named-port restrictions change the answer
    jenc, penc = _ported(100, 21)
    want = jax_tiled(jenc, tile=32, chunk=8, use_pallas=True, **flags)
    before = fused_ports_reach.launches
    got = tiled_k8s_reach(penc, tile=32, chunk=8, device="cpu", use_kernel=True, **flags)
    assert fused_ports_reach.launches == before  # CPU: the plain version ran
    assert got.meta == {"kernel": "fused_ports_reach"}
    assert words(got.packed).shape[1] == 4  # N padded to the 128 kernel tile
    _assert_same(got, want, 100)
    np.testing.assert_array_equal(got.selected, np.asarray(want.selected))


def test_one_direction_without_grants():
    cluster = jax_random_cluster(JaxGeneratorConfig(**{
        k: v for k, v in _gen(50, 5).items() if k != "compute_ports"
    }))
    cluster.policies = [
        dataclasses.replace(p, egress=None, policy_types=("Ingress",))
        for p in cluster.policies
    ]
    jenc, penc = carry(jax_encode(cluster, compute_ports=True))
    assert len(penc.atoms) > 1 and penc.egress.n == 0
    want = jax_tiled(jenc, tile=32, chunk=8, use_pallas=False)
    for use_kernel in (False, True):
        got = tiled_k8s_reach(penc, tile=32, chunk=8, device="cpu", use_kernel=use_kernel)
        _assert_same(got, want, 50)


def test_port_kernel_operands_are_what_the_solve_contracts():
    _, penc = _ported(100, 21)
    ops = tiled_ports.port_kernel_operands(penc, tile=128, chunk=8, device="cpu")
    s = ops.stats
    assert s == tiled_ports.port_layout_stats(penc, tile=128, chunk=8)
    assert s["N"] == 128 and s["K_padded"] % K_STEP == 0
    assert s["K"] <= s["K_layout"] <= s["K_padded"]
    # K counts the real VP rows: every row but the sink-policy ones (the
    # segments' pad rows and each direction's final sink row)
    pro = tiled_ports._prologue(penc, tile=128, chunk=8, use_kernel=True)
    P = penc.n_policies
    assert s["K"] == int((pro.vp.pol_i != P).sum() + (pro.vp.pol_e != P).sum())
    assert s["K_layout"] + 2 == s["vp_rows_i"] + s["vp_rows_e"]
    words_ = fused_ports_reach(*ops.args, default_allow=True)
    from kubernetes_verification_tpu_torch.ops.bits import or_diagonal

    words_ = or_diagonal(words_) & ops.col_mask[None, :]
    got = tiled_k8s_reach(penc, tile=128, chunk=8, device="cpu", use_kernel=True,
                          fetch=False)
    assert torch.equal(words_[:100], got.packed)


def test_resident_check_refuses(monkeypatch):
    _, penc = _ported(61, 7)
    monkeypatch.setattr(tiled_ports, "_free_bytes", lambda dev: 1000)
    with pytest.raises(ConfigError, match="GB of"):
        tiled_k8s_reach(penc, device="cpu")


# ---------------------------------------------------------------------------
# the kernel's plain version against the TPU kernel in interpret mode
# ---------------------------------------------------------------------------

_N = 128
#: (kind, slab) per segment in K order, with each segment's length
_CASES = {
    "full-blocks-only": (0, [(1, 0, 13), (3, 0, 70)]),
    "one-mask": (1, [(0, 0, 5), (1, 1, 9), (2, 0, 64), (3, 1, 3)]),
    "four-masks": (4, [(0, 0, 7), (0, 2, 65), (0, 3, 1), (1, 4, 20),
                       (2, 0, 11), (2, 1, 30), (2, 3, 2), (3, 4, 17)]),
    "no-ingress": (2, [(0, 0, 9), (0, 1, 12), (1, 2, 8)]),
    "no-egress": (2, [(2, 0, 9), (2, 1, 12), (3, 2, 8)]),
    "no-grants": (0, []),
}


def _segment_operands(rng, segs, tk):
    """The segment rows, and JAX's K-row operands padded per segment to
    ``tk`` with the plan counted in ``tk`` chunks."""
    rows, a_parts, b_parts, plan, chunks = [], [], [], [], 0
    for kind, slab, length in segs:
        a = (rng.random((length, _N)) < 0.15).astype(np.int8)
        b = (rng.random((length, _N)) < 0.15).astype(np.int8)
        rows.append((kind, slab, a, b))
        pad = ((0, (-length) % tk), (0, 0))
        a_parts.append(np.pad(a, pad))
        b_parts.append(np.pad(b, pad))
        chunks += (length + (-length) % tk) // tk
        plan.append((chunks, kind, slab))
    if not segs:
        a_parts = b_parts = [np.zeros((tk, _N), np.int8)]
        plan = [(1, 0, 0)]
    return rows, np.concatenate(a_parts), np.concatenate(b_parts), tuple(plan)


def _port_operands(rows):
    """The same rows as the port's K-contiguous operands and plan."""
    kp = sum(a.shape[0] + (-a.shape[0]) % K_STEP for _, _, a, _ in rows) or K_STEP
    at = np.zeros((_N, kp), np.int8)
    bt = np.zeros((_N, kp), np.int8)
    plan, off = [], 0
    for kind, slab, a, b in rows:
        at[:, off : off + a.shape[0]] = a.T
        bt[:, off : off + a.shape[0]] = b.T
        off += a.shape[0] + (-a.shape[0]) % K_STEP
        plan.append((off // K_STEP, kind, slab))
    return at, bt, np.asarray(plan or [(1, 0, 0)], np.int32)


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("default_allow", [True, False])
def test_reference_matches_fused_ports_stripe(case, default_allow):
    R, segs = _CASES[case]
    rng = np.random.default_rng(len(segs) * 7 + R)
    rows, a_all, b_all, jplan = _segment_operands(rng, segs, tk=8)
    masks = rng.random((R, 5)) < 0.4
    ov_rows = tuple(
        tuple(int(j) for j in np.nonzero((masks[m] & masks).any(axis=1))[0])
        for m in range(R)
    )
    niso_i = (rng.random(_N) < 0.5).astype(np.int32)
    niso_e = (rng.random(_N) < 0.5).astype(np.int32)
    want = fused_ports_stripe(
        jnp.asarray(a_all), jnp.asarray(b_all),
        jnp.asarray(np.broadcast_to(niso_i, (8, _N)).copy()),
        jnp.asarray(np.broadcast_to(niso_e[:, None], (_N, 128)).copy()),
        tm=32, tk=8, r_masks=R, plan=jplan, ov_rows=ov_rows,
        default_allow=default_allow, interpret=True,
    )
    at, bt, plan = _port_operands(rows)
    ov = [sum(1 << j for j in row) | (1 << R) for row in ov_rows]
    t = torch.as_tensor
    got = fused_ports_reach(
        t(at), t(bt), t(plan), torch.tensor(ov, dtype=torch.int64), t(niso_i),
        t(niso_e), default_allow=default_allow,
    )
    expect = pack_bool_cols(torch.as_tensor(np.asarray(want) > 0))
    assert torch.equal(got, expect)


def test_fused_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(3)
    rows, *_ = _segment_operands(rng, [(1, 0, 10), (3, 0, 10)], tk=8)
    at, bt, plan = (torch.as_tensor(x) for x in _port_operands(rows))
    niso = torch.ones(_N, dtype=torch.int32)
    too_many = torch.zeros(FUSED_MAX_MASKS + 1, dtype=torch.int64)
    with pytest.raises(ConfigError, match=f"limit of {FUSED_MAX_MASKS}.*use_kernel=False"):
        fused_ports_reach(at, bt, plan, too_many, niso, niso, default_allow=True)
    none = torch.zeros(0, dtype=torch.int64)
    with pytest.raises(ConfigError, match="plan"):  # ends short of K'
        fused_ports_reach(at, bt, plan[:1], none, niso, niso, default_allow=True)
    with pytest.raises(ConfigError, match="bad plan row"):  # egress plane > R
        bad = plan.clone()
        bad[0, 2] = 3
        fused_ports_reach(at, bt, bad, none, niso, niso, default_allow=True)
    with pytest.raises(ConfigError, match="multiple"):
        fused_ports_reach(at[:96], bt[:96], plan, none, niso[:96], niso[:96],
                          default_allow=True)
    with pytest.raises(ConfigError, match="int8"):
        fused_ports_reach(at.to(torch.int32), bt, plan, none, niso, niso,
                          default_allow=True)
    # the plain version is what the wrapper ran on these CPU tensors
    assert torch.equal(
        fused_ports_reach(at, bt, plan, none, niso, niso, default_allow=False),
        fused_ports_reach_reference(at, bt, plan, none, niso, niso, default_allow=False),
    )


# ---------------------------------------------------------------------------
# named resolution in one pass, against a scan of every pod and atom
# ---------------------------------------------------------------------------


def _resolution_scan(atoms, pods, keys):
    """The per-pod, per-atom scan that defines ``named_resolution``."""
    out = {}
    for proto, name in keys:
        mask = np.zeros((len(pods), len(atoms)), dtype=bool)
        for d, pod in enumerate(pods):
            entry = pod.container_ports.get(name)
            if entry is None or entry[0] != proto:
                continue
            for q, atom in enumerate(atoms):
                if atom.name is None and atom.protocol == proto and atom.lo <= int(entry[1]) <= atom.hi:
                    mask[d, q] = True
        out[(proto, name)] = mask
    return out


def _named_cluster():
    """Named ports on an atom's bounds (8000, 8999) and past it (9000), one
    declared under the other protocol, and a name no policy uses."""
    web = kvt.Selector({"app": "web"})
    declared = [{"http": ("TCP", 8000)}, {"http": ("TCP", 8999)}, {"http": ("TCP", 9000)},
                {"http": ("UDP", 8000)}, {"http": ("TCP", 1), "grpc": ("TCP", 65535)},
                {"grpc": ("TCP", 50051), "metrics": ("UDP", 9100)}, {}]
    pods = [kvt.Pod(f"web-{i}", "prod", {"app": "web"}, container_ports=ports)
            for i, ports in enumerate(declared)]
    pol = kvt.NetworkPolicy("p", namespace="prod", pod_selector=web, ingress=(
        kvt.Rule(peers=(kvt.Peer(pod_selector=web),),
                 ports=(kvt.PortSpec("TCP", 8000, end_port=8999), kvt.PortSpec("TCP", "http"))),
        kvt.Rule(ports=(kvt.PortSpec("UDP", "metrics"), kvt.PortSpec("UDP", 53))),
    ))
    return kvt.Cluster(pods=pods, policies=[pol])


@pytest.mark.parametrize("refined", [True, False], ids=["resolution-atoms", "by-name-atoms"])
def test_named_resolution_matches_a_scan_of_every_pod_and_atom(refined):
    cluster = _named_cluster()
    pols, pods = cluster.policies, cluster.pods
    # without pods the atoms keep their ranges and carry by-name atoms, which
    # resolution must skip; the numbers then fall on the range's bounds
    atoms = compute_port_atoms(pols, pods if refined else None)
    assert any(a.lo == 8000 and a.hi == 8999 for a in atoms) != refined
    got = named_resolution(pols, atoms, pods)
    assert sorted(got) == [("TCP", "http"), ("UDP", "metrics")]
    keys = [("TCP", "http"), ("TCP", "grpc"), ("UDP", "http"), ("SCTP", "none")]
    got_keys = named_resolution(pols, atoms, pods, keys=keys)
    assert list(got_keys) == keys
    for res, ks in ((got, sorted(got)), (got_keys, keys)):
        want = _resolution_scan(atoms, pods, ks)
        for key in ks:
            assert res[key].dtype == bool and res[key].shape == (len(pods), len(atoms))
            np.testing.assert_array_equal(res[key], want[key], err_msg=str(key))
    http = got[("TCP", "http")]
    assert http[:3].sum(axis=1).tolist() == [1, 1, 1] and not http[3].any()
    if not refined:  # 8000 and 8999 share the range's atom, 9000 lies past it
        assert (http[0] == http[1]).all() and not (http[1] & http[2]).any()
    assert got_keys[("UDP", "http")][3].sum() == 1 and not got_keys[("SCTP", "none")].any()


def test_a_frozen_bank_raises_on_the_first_new_named_row():
    cluster = _named_cluster()
    enc = encode_cluster(cluster)
    bank = enc.restrict_bank_intern
    bank.frozen = True
    rows = list(bank.rows)
    vocab, ns_index = enc.vocab, cluster.namespace_index()
    pol = cluster.policies[0]
    # a policy whose named rows the bank holds: the same rows, no new one
    delta = encode_policy_delta(pol, vocab, enc.atoms, ns_index, cluster.pods,
                                enc.resolution, bank)
    np.testing.assert_array_equal(delta.ingress.dst_restrict, enc.ingress.dst_restrict)
    # a name the frozen universe resolves (resume's keys) but no row holds
    resolution = named_resolution(cluster.policies, enc.atoms, cluster.pods,
                                  keys=sorted(enc.resolution) + [("TCP", "grpc")])
    grpc = dataclasses.replace(pol, name="grpc", ingress=(
        kvt.Rule(ports=(kvt.PortSpec("TCP", "http"), kvt.PortSpec("TCP", "grpc"))),))
    with pytest.raises(FrozenBankMiss, match="'grpc'"):
        encode_policy_delta(grpc, vocab, enc.atoms, ns_index, cluster.pods,
                            resolution, bank)
    assert len(bank.rows) == len(rows) and bank.frozen
