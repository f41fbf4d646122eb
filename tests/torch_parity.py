"""Shared helpers of the ``test_torch_*`` parity tests: one seeded cluster,
encoded by the JAX package, carried into the PyTorch port as arrays, so both
packages solve exactly the same operands."""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import torch

import kubernetes_verification_tpu.models.core as jcore
import kubernetes_verification_tpu as jkv
from kubernetes_verification_tpu.encode.encoder import encode_cluster as jax_encode
from kubernetes_verification_tpu.harness.generate import (
    GeneratorConfig as JaxGeneratorConfig,
)
from kubernetes_verification_tpu.harness.generate import (
    random_cluster as jax_random_cluster,
)
from kubernetes_verification_tpu_torch.encode.carry import (
    encoding_from_arrays,
    encoding_to_arrays,
)
from torch_mesh_child import resolve_op

#: the parity tests run at toy sizes next to other xdist workers: two
#: intra-op threads are plenty, and all cores per worker would crowd the
#: timing-sensitive tests that share the machine
torch.set_num_threads(2)


def carried(**gen):
    """``(jax_encoding, port_encoding)`` of one generated cluster; ``gen``
    holds ``GeneratorConfig`` fields plus ``compute_ports``."""
    compute_ports = gen.pop("compute_ports", False)
    cluster = jax_random_cluster(JaxGeneratorConfig(**gen))
    return carry(jax_encode(cluster, compute_ports=compute_ports))


def carry(jenc):
    """``(jenc, port_encoding)``: the JAX package's encoding and the same
    arrays as the port's ``EncodedCluster``."""
    penc = encoding_from_arrays(
        encoding_to_arrays(jenc),
        n_pods=jenc.n_pods,
        n_namespaces=jenc.n_namespaces,
        n_policies=jenc.n_policies,
        atoms=jenc.atoms,
    )
    return jenc, penc


def words(x) -> np.ndarray:
    """Packed words of either package (int32 torch tensor, JAX or numpy
    uint32) as the reference's uint32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().view("<u4")
    return np.asarray(x).view("<u4")


def to_jax(x):
    """A model object of the port (or a container of them) as the JAX
    package's equal object, class by class and field by field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(jcore, type(x).__name__)
        return cls(**{f.name: to_jax(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(to_jax(v) for v in x)
    if isinstance(x, dict):
        return {k: to_jax(v) for k, v in x.items()}
    return x


# ---------------------------------------------------------------------------
# the mesh engines' op streams (tests/test_torch_mesh_engines*.py)
# ---------------------------------------------------------------------------

#: the JAX package's model classes and generator, as ``resolve_op`` reads them
JPKG = SimpleNamespace(Pod=jkv.Pod, Namespace=jkv.Namespace,
                       random_cluster=jax_random_cluster, GeneratorConfig=JaxGeneratorConfig)


def _jax_state(eng):
    """A JAX engine's state as the mesh child records the port's."""
    st = eng.state_dict()
    if isinstance(st, tuple):  # the ports engine: (arrays, meta)
        st, meta = st
        st = {**st, "__meta__": np.array(json.dumps(meta, sort_keys=True))}
    return st


def same_state(want, got, label):
    """Two recorded states: the same keys, and per key the same dtype, shape
    and bytes."""
    keys = sorted(want)
    assert sorted(got) == keys, (label, sorted(set(got) ^ set(keys)))
    for k in keys:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert (w.dtype, w.shape) == (g.dtype, g.shape), (label, k, w.dtype, g.dtype, w.shape, g.shape)
        assert w.tobytes() == g.tobytes(), (label, k)


def _states(res, i):
    """The state the mesh child recorded after op ``i`` (0: the build)."""
    pre = f"{i}."
    return {k[len(pre):]: v for k, v in res.items()
            if k.startswith(pre) and k[len(pre):].split(".")[0] not in ("ret", "sweep", "stripe", "rows")}


def _err(e):
    return f"{isinstance(e, ValueError)}|{e}"


def _port_err(x):
    _, is_value, msg = str(x).split("|", 2)
    return f"{is_value}|{msg}"


def replay_ops(res, eng, cluster, ops, save=None, label=""):
    """Apply the scripted ``ops`` (``torch_mesh_child.resolve_op``) to the
    JAX engine ``eng`` built from ``cluster``, holding its state against
    the port's recorded one (``res``) after the build and every op; the
    stripe, row and sweep re-solves and refusals too. ``save(eng, name)``
    writes the JAX engine's checkpoint for a ``save`` op."""
    same_state(_jax_state(eng), _states(res, 0), f"{label} build")
    for i, op in enumerate(ops, 1):
        where = f"{label} op {i} {op[0]}"
        if op[0] == "save":
            save(eng, op[1])
            continue
        if op[0] == "sweep":
            got = {int(k.split(".")[2]): v for k, v in res.items() if k.startswith(f"{i}.sweep.")}
            want = dict(eng.sweep_dirty(op[1]))
            assert sorted(got) == sorted(want), where
            for d0 in want:
                np.testing.assert_array_equal(got[d0], want[d0], err_msg=f"{where} {d0}")
            continue
        if op[0] in ("stripe", "rows"):
            try:
                want = eng.solve_stripe(op[1], op[2]) if op[0] == "stripe" else eng.solve_rows(op[1])
            except ValueError as e:
                assert _port_err(res[f"{i}.{op[0]}"]) == _err(e), where
                continue
            got = res[f"{i}.{op[0]}"]
            assert got.dtype == want.dtype, where
            np.testing.assert_array_equal(got, want, err_msg=where)
            continue
        method, args = resolve_op(op, eng, cluster, JPKG)
        ret = getattr(eng, method)(*args)
        if ret is not None:
            assert int(res[f"{i}.ret"]) == ret, where
        same_state(_jax_state(eng), _states(res, i), where)
