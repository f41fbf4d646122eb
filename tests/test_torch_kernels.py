"""``packed_dir_allow`` / ``packed_reach``: the port's plain version against
the JAX package's Pallas kernel in interpret mode, the packed-word helpers
and the popcount against the JAX package's (exact: every output is integer
words). The CUDA kernel itself runs only on the card:
``tests/test_torch_cuda.py`` holds it against the plain version there."""
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
