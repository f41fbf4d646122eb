"""Dense-tensor Datalog: the engine (z3-Fixedpoint role,
``kubesv/kubesv/constraint.py:114-133``) and the NetworkPolicy program built
on it (``define_model``/``define_pol_facts``, ``constraint.py:136-298``) —
the port of ``kubernetes_verification_tpu.datalog``, with the rules as
``torch.einsum`` on the card (``solve(use_torch=True)``, the ``datalog``
backend's default) or NumPy on the host."""
from .engine import Atom, Domain, Program, RuleDef, Solution, solve
from .k8s_program import DatalogBackend, build_k8s_program, build_kano_program

__all__ = [
    "Atom",
    "Domain",
    "Program",
    "RuleDef",
    "Solution",
    "solve",
    "DatalogBackend",
    "build_k8s_program",
    "build_kano_program",
]
