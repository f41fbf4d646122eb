"""Shared helpers of the ``test_torch_*`` parity tests: one seeded cluster,
encoded by the JAX package, carried into the PyTorch port as arrays, so both
packages solve exactly the same operands."""
import dataclasses

import numpy as np
import torch

import kubernetes_verification_tpu.models.core as jcore
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
