"""Shared helpers of the ``test_torch_*`` parity tests: one seeded cluster,
encoded by the JAX package, carried into the PyTorch port as arrays, so both
packages solve exactly the same operands."""
import numpy as np
import torch

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
