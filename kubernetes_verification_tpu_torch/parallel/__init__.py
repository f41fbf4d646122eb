"""Multi-rank geometry and the mesh-sharded solves of the PyTorch port.

``stripes`` is the contiguous pod-range stripe geometry the stripe fleet of
``serve/stripes.py`` routes by. ``mesh`` is the ``(pods, grants)`` mesh on
``torch.distributed`` (one process per rank, NCCL on the card, gloo on the
CPU), and ``sharded_ops`` / ``packed_sharded`` / ``sharded_closure`` the
dense, packed and closure solves over it, SPMD: every rank calls them with
the same encoding and gets the same global result. (The dense standalone
closure is ``sharded_ops.sharded_closure``; the name ``sharded_closure``
here is the packed closure's module.) ``engine_mesh`` is the SPMD half of
the serving engines' ``mesh=`` forms, on ``mesh``'s named collectives
(``gather_rows``, ``psum_counts``, ``barrier``).
"""
from .mesh import (
    GRANT_AXIS,
    POD_AXIS,
    Mesh,
    barrier,
    distributed_mesh,
    gather_rows,
    init_distributed,
    mesh_for,
    pad_amount,
    pad_rows,
    psum_counts,
)
from .packed_sharded import PackedShardedResult, sharded_packed_reach
from .sharded_closure import (
    ClosureBudgetError,
    check_closure_budget,
    estimate_closure_hbm,
    sharded_packed_closure,
)
from .sharded_ops import sharded_k8s_reach, sharded_kano_reach
from .stripes import parse_stripe, stripe_bounds, stripe_of, stripe_table

__all__ = [
    "GRANT_AXIS",
    "POD_AXIS",
    "ClosureBudgetError",
    "Mesh",
    "PackedShardedResult",
    "barrier",
    "check_closure_budget",
    "distributed_mesh",
    "estimate_closure_hbm",
    "gather_rows",
    "init_distributed",
    "mesh_for",
    "pad_amount",
    "pad_rows",
    "parse_stripe",
    "psum_counts",
    "sharded_k8s_reach",
    "sharded_kano_reach",
    "sharded_packed_closure",
    "sharded_packed_reach",
    "stripe_bounds",
    "stripe_of",
    "stripe_table",
]
