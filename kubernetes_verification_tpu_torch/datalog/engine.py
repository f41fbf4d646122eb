"""Dense-tensor Datalog engine — the role z3's ``Fixedpoint`` plays in the
reference (``kubesv/kubesv/constraint.py:114-133``).

The port of ``kubernetes_verification_tpu.datalog.engine``. The reference
hands its whole solve to z3's bottom-up Datalog evaluator over finite
bit-vector domains. Here the same model maps onto dense tensors:

* a **relation** over finite domains is a dense boolean tensor
  (``r(pod, pol)`` ⇒ ``bool[N, P]``) — the z3 finite-domain sorts
  (``constraint.py:33-35``) become tensor axes;
* a **rule** is one AND-OR contraction: the join over shared variables of the
  positive body atoms is a boolean einsum (fp32 counts, ``> 0``), negated
  atoms mask the result, and the projection onto the head variables is an
  any-reduction;
* **negation as failure** is stratified (the engine computes strata and
  rejects negative cycles), matching the semantics the reference gets from
  ``datalog.generate_explanations=False`` (``constraint.py:119-120``);
* the **fixpoint** iterates rule application per stratum until no relation
  changes — naive evaluation, which for these programs converges in a handful
  of sweeps (the recursive ``path`` rule dominates at ⌈log₂N⌉-ish sweeps since
  each sweep composes one more edge; see ``ops/closure.py`` for the
  repeated-squaring form used by the tensor backends).

``Program.dump()`` renders the program as readable Datalog text — the
``get_datalog`` SMT2-dump facility (``constraint.py:127-128``) — and
``Solution.query`` plays ``get_answer`` + ``parse_z3_or_and``
(``kubesv/sample/__init__.py:14-25``): it returns the matching index tuples of
a relation under a partial binding.

The engine evaluates with NumPy by default (exact, host-side) or with
PyTorch (``use_torch=True``) on an explicit device, where each rule's join
is one ``torch.einsum`` in fp32 (the counts are exact below 2²⁴) followed by
``> 0``, as the JAX package's jitted rule kernels compute it. Both routes
OR a rule's result into the head relation in place, over the region its
head addresses (a slice, or an index grid for a repeated head variable),
and detect change on that region alone: the same values, sweep for sweep,
as building a head-shaped array and OR-ing it in.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..runtime import resolve_device

__all__ = ["Domain", "Atom", "RuleDef", "Program", "Solution", "solve"]

Arg = Union[str, int]  # variable name or constant index


@dataclass(frozen=True)
class Domain:
    """A finite entity family — the analogue of a z3 finite-domain sort
    (``kubesv/kubesv/constraint.py:33-35``)."""

    name: str
    size: int


@dataclass(frozen=True)
class Atom:
    """``rel(args...)``, possibly negated. Args are variable names or integer
    constants (the reference interns label literals to integers the same way,
    ``constraint.py:51-55``)."""

    rel: str
    args: Tuple[Arg, ...]
    negated: bool = False

    def __str__(self) -> str:
        inner = f"{self.rel}({', '.join(map(str, self.args))})"
        return f"not {inner}" if self.negated else inner


@dataclass(frozen=True)
class RuleDef:
    head: Atom
    body: Tuple[Atom, ...]

    def __str__(self) -> str:
        if not self.body:
            return f"{self.head}."
        return f"{self.head} :- {', '.join(map(str, self.body))}."


class Program:
    """A Datalog program: domains, relations, facts, rules."""

    def __init__(self) -> None:
        self.domains: Dict[str, Domain] = {}
        self.relations: Dict[str, Tuple[Domain, ...]] = {}
        self.rules: List[RuleDef] = []
        self._facts: Dict[str, List[Tuple[int, ...]]] = {}
        self._fact_arrays: Dict[str, np.ndarray] = {}

    # -- declaration ------------------------------------------------------
    def domain(self, name: str, size: int) -> Domain:
        if name in self.domains:
            if self.domains[name].size != size:
                raise ValueError(f"domain {name} redeclared with new size")
            return self.domains[name]
        d = Domain(name, size)
        self.domains[name] = d
        return d

    def relation(self, name: str, *domains: Domain) -> str:
        if name in self.relations:
            if self.relations[name] != tuple(domains):
                raise ValueError(f"relation {name} redeclared with new schema")
            return name
        self.relations[name] = tuple(domains)
        return name

    # -- population -------------------------------------------------------
    def fact(self, rel: str, *indices: int) -> None:
        self._check_atom(Atom(rel, indices), head=True)
        self._facts.setdefault(rel, []).append(tuple(indices))

    def fact_array(self, rel: str, array: np.ndarray) -> None:
        """Bulk facts: OR a dense bool array into the relation's initial
        value (the tensorised ``define_pod_facts``,
        ``kubesv/kubesv/constraint.py:242-275``)."""
        shape = tuple(d.size for d in self.relations[rel])
        array = np.asarray(array, dtype=bool)
        if array.shape != shape:
            raise ValueError(f"{rel}: fact array shape {array.shape} != {shape}")
        if rel in self._fact_arrays:
            self._fact_arrays[rel] = self._fact_arrays[rel] | array
        else:
            self._fact_arrays[rel] = array

    def rule(self, head: Atom, *body: Atom) -> None:
        self._check_atom(head, head=True)
        head_vars = {a for a in head.args if isinstance(a, str)}
        bound = set()
        for atom in body:
            self._check_atom(atom)
            if not atom.negated:
                bound |= {a for a in atom.args if isinstance(a, str)}
        for atom in body:
            if atom.negated:
                free = {a for a in atom.args if isinstance(a, str)} - bound
                if free:
                    raise ValueError(
                        f"unsafe rule: negated {atom} uses unbound vars {free}"
                    )
        if head_vars - bound:
            raise ValueError(
                f"unsafe rule: head {head} uses unbound vars {head_vars - bound}"
            )
        self.rules.append(RuleDef(head, tuple(body)))

    def _check_atom(self, atom: Atom, head: bool = False) -> None:
        if atom.rel not in self.relations:
            raise KeyError(f"unknown relation {atom.rel!r}")
        schema = self.relations[atom.rel]
        if len(atom.args) != len(schema):
            raise ValueError(f"{atom}: arity {len(atom.args)} != {len(schema)}")
        for a, dom in zip(atom.args, schema):
            if isinstance(a, (int, np.integer)) and not 0 <= a < dom.size:
                raise ValueError(f"{atom}: constant {a} outside {dom}")
        if head and atom.negated:
            raise ValueError(f"negated head: {atom}")

    # -- introspection ----------------------------------------------------
    def dump(self) -> str:
        """The program as Datalog text (facts elided to counts) — the
        ``get_datalog`` debug facility (``constraint.py:127-128``)."""
        lines = [
            f"% domain {d.name}: {d.size}" for d in self.domains.values()
        ]
        for name, schema in self.relations.items():
            sig = ", ".join(d.name for d in schema)
            n_facts = len(self._facts.get(name, ()))
            if name in self._fact_arrays:
                n_facts += int(self._fact_arrays[name].sum())
            lines.append(f"% relation {name}({sig})  [{n_facts} facts]")
        lines.extend(str(r) for r in self.rules)
        return "\n".join(lines)

    # -- stratification ---------------------------------------------------
    def strata(self) -> Dict[str, int]:
        """Stratum per relation; raises on negation cycles (programs z3's
        Datalog engine would also reject)."""
        level = {name: 0 for name in self.relations}
        n = len(self.relations) or 1
        for _ in range(n * n + 1):
            changed = False
            for rule in self.rules:
                h = rule.head.rel
                for atom in rule.body:
                    need = level[atom.rel] + (1 if atom.negated else 0)
                    if level[h] < need:
                        level[h] = need
                        changed = True
            if not changed:
                return level
            if max(level.values(), default=0) > n:
                break
        raise ValueError("program is not stratifiable (negation cycle)")


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

_EINSUM_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"

#: the torch route's rule kernels, one per einsum spec: an fp32
#: ``torch.einsum`` then ``> 0``. LRU-bounded as the JAX package's jitted
#: kernels are: a long-lived process evaluating many generated programs
#: keeps at most this many specs.
_RULE_EINSUM_CACHE: "OrderedDict[str, object]" = OrderedDict()
_RULE_EINSUM_CACHE_MAX = 128


def _torch_rule_einsum(expr: str):
    fn = _RULE_EINSUM_CACHE.get(expr)
    if fn is None:

        def run(*ops, _expr=expr):
            return torch.einsum(_expr, *[o.to(torch.float32) for o in ops]) > 0

        fn = run
        _RULE_EINSUM_CACHE[expr] = fn
        while len(_RULE_EINSUM_CACHE) > _RULE_EINSUM_CACHE_MAX:
            _RULE_EINSUM_CACHE.popitem(last=False)
    else:
        _RULE_EINSUM_CACHE.move_to_end(expr)
    return fn


class _NumPy:
    """The host route's array operations."""

    @staticmethod
    def take(arr, i: int, axis: int):
        return np.take(arr, i, axis=axis)

    @staticmethod
    def join(expr: str, operands):
        counts = np.einsum(expr, *[o.astype(np.float32) for o in operands])
        return counts > 0

    @staticmethod
    def diagonal(expr: str, arr):
        return np.einsum(expr, arr)  # pure diagonal gather — works on bool

    @staticmethod
    def permute(arr, order):
        return np.transpose(arr, order)

    @staticmethod
    def any(arr, axes):
        return arr.any(axis=axes)

    @staticmethod
    def changed(new, old) -> bool:
        return not np.array_equal(new, old)

    @staticmethod
    def grid(sizes, like):
        return np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij")

    @staticmethod
    def ones(like):
        return np.ones((), dtype=bool)


class _Torch(_NumPy):
    """The torch route's array operations, on the relations' device."""

    @staticmethod
    def take(arr, i: int, axis: int):
        return arr.select(axis, i)

    @staticmethod
    def join(expr: str, operands):
        return _torch_rule_einsum(expr)(*operands)

    @staticmethod
    def diagonal(expr: str, arr):
        return torch.einsum(expr, arr.to(torch.float32)) > 0

    @staticmethod
    def permute(arr, order):
        return arr.permute(*order)

    @staticmethod
    def any(arr, axes):
        return arr.any(dim=axes)

    @staticmethod
    def changed(new, old) -> bool:
        return not torch.equal(new, old)

    @staticmethod
    def grid(sizes, like):
        return torch.meshgrid(
            *[torch.arange(s, device=like.device) for s in sizes], indexing="ij"
        )

    @staticmethod
    def ones(like):
        return torch.ones((), dtype=torch.bool, device=like.device)


def _align(arr, args, sub, xp):
    """``arr`` (a relation) with its constant arguments taken out; returns
    it and its einsum letters, one per variable argument."""
    letters = []
    for a in args:
        if isinstance(a, str):
            letters.append(sub[a])
        else:
            arr = xp.take(arr, a, len(letters))
    return arr, "".join(letters)


def _apply_rule(rule: RuleDef, rels: Mapping[str, object], xp) -> bool:
    """Evaluate one rule body against the current relation values and OR
    the result into the head relation in place; returns whether the head
    changed."""
    # order of appearance of variables across positive atoms
    var_order: List[str] = []
    for atom in rule.body:
        if atom.negated:
            continue
        for a in atom.args:
            if isinstance(a, str) and a not in var_order:
                var_order.append(a)
    if len(var_order) > len(_EINSUM_LETTERS):  # pragma: no cover
        raise ValueError("too many variables in one rule")
    sub = {v: _EINSUM_LETTERS[i] for i, v in enumerate(var_order)}

    # Only variables consumed downstream (head or negated atoms) survive the
    # einsum; join-only variables are contracted away inside it — this keeps
    # e.g. the doubling closure rule path(s,d) :- path(s,x), path(x,d) at
    # O(N²) memory (one boolean "matmul") instead of an N³ intermediate.
    needed = {a for a in rule.head.args if isinstance(a, str)}
    for atom in rule.body:
        if atom.negated:
            needed |= {a for a in atom.args if isinstance(a, str)}
    var_order = [v for v in var_order if v in needed]

    operands = []
    specs = []
    for atom in rule.body:
        if atom.negated:
            continue
        # a repeated variable inside one atom takes the diagonal by
        # einsum's repeated-subscript semantics (valid for input specs)
        arr, letters = _align(rels[atom.rel], atom.args, sub, xp)
        operands.append(arr)
        specs.append(letters)

    head = rels[rule.head.rel]
    out_letters = "".join(sub[v] for v in var_order)
    if operands:
        val = xp.join(",".join(specs) + "->" + out_letters, operands)
    else:  # fact-like rule with only negated atoms is rejected as unsafe
        val = xp.ones(head)

    for atom in rule.body:
        if not atom.negated:
            continue
        arr, perm_letters = _align(rels[atom.rel], atom.args, sub, xp)
        if len(set(perm_letters)) != len(perm_letters):
            # repeated variable in a negated atom (e.g. not r(x, x)): the
            # transpose/expand alignment below handles each letter once, so
            # first collapse the repeated axes to their diagonal
            uniq = "".join(dict.fromkeys(perm_letters))
            arr = xp.diagonal(f"{perm_letters}->{uniq}", arr)
            perm_letters = uniq
        # expand arr to the full var_order axes: val &= ~arr, aligned
        expand = [slice(None) if c in perm_letters else None for c in out_letters]
        order = [perm_letters.index(c) for c in out_letters if c in perm_letters]
        arr_t = xp.permute(arr, order) if order != list(range(arr.ndim)) else arr
        val = val & ~arr_t[tuple(expand)]

    # project onto head: any-reduce vars not in head
    keep = [a for a in rule.head.args if isinstance(a, str)]
    drop_axes = tuple(i for i, v in enumerate(var_order) if v not in keep)
    if drop_axes:
        val = xp.any(val, drop_axes)
    kept_vars = [v for v in var_order if v in keep]

    # the head's region: a slice per variable and the index per constant,
    # with val's axes in head order — or, for a repeated head variable
    # (e.g. edge(x, x) :- is_pod(x)), index grids over the distinct ones
    if len(set(keep)) == len(keep):
        order = [kept_vars.index(v) for v in keep]
        if order != list(range(len(order))):
            val = xp.permute(val, order)
        index = tuple(slice(None) if isinstance(a, str) else a for a in rule.head.args)
    else:
        sizes = [
            next(s for a, s in zip(rule.head.args, head.shape) if a == v)
            for v in kept_vars
        ]
        grid_of = dict(zip(kept_vars, xp.grid(sizes, head)))
        index = tuple(grid_of[a] if isinstance(a, str) else a for a in rule.head.args)
    old = head[index]
    new = old | val
    if not xp.changed(new, old):
        return False
    head[index] = new
    return True


@dataclass
class Solution:
    """Solved relation values + the ``get_answer``-style query API."""

    relations: Dict[str, np.ndarray]
    iterations: int
    program: Program = field(repr=False, default=None)

    def __getitem__(self, rel: str) -> np.ndarray:
        return self.relations[rel]

    def query(
        self, rel: str, pattern: Optional[Sequence[Optional[int]]] = None
    ) -> List[Tuple[int, ...]]:
        """Matching index tuples of ``rel`` under a partial binding — the
        decoded form of the reference's only result API
        (``kubesv/sample/__init__.py:14-25``). ``pattern`` entries are ints
        (bound) or None (free); omitted → all free."""
        arr = self.relations[rel]
        if pattern is not None:
            for axis, p in enumerate(pattern):
                if p is not None:
                    mask = np.zeros(arr.shape[axis], dtype=bool)
                    mask[p] = True
                    arr = arr & mask.reshape(
                        tuple(-1 if i == axis else 1 for i in range(arr.ndim))
                    )
        return [tuple(int(i) for i in t) for t in zip(*np.nonzero(arr))]


def solve(
    program: Program,
    use_torch: bool = False,
    max_iters: int = 10_000,
    device=None,
) -> Solution:
    """Naive stratified bottom-up evaluation to fixpoint. ``use_torch``
    evaluates the rules with PyTorch on ``device`` (``None`` is ``"cuda"``,
    which raises ``BackendError`` without a GPU); the default is the NumPy
    host evaluation."""
    xp = _Torch if use_torch else _NumPy
    dev = resolve_device(device) if use_torch else None

    rels: Dict[str, object] = {}
    for name, schema in program.relations.items():
        shape = tuple(d.size for d in schema)
        init = np.zeros(shape, dtype=bool)
        for t in program._facts.get(name, ()):
            init[t] = True
        if name in program._fact_arrays:
            init |= program._fact_arrays[name]
        rels[name] = torch.from_numpy(init).to(dev) if use_torch else init

    strata = program.strata()
    n_strata = max(strata.values(), default=0) + 1
    total_iters = 0
    for s in range(n_strata):
        stratum_rules = [r for r in program.rules if strata[r.head.rel] == s]
        if not stratum_rules:
            continue
        for _ in range(max_iters):
            total_iters += 1
            changed = False
            for rule in stratum_rules:
                changed |= _apply_rule(rule, rels, xp)
            if not changed:
                break
        else:  # pragma: no cover
            raise RuntimeError("fixpoint did not converge")
    out = {
        k: v.cpu().numpy() if use_torch else np.asarray(v) for k, v in rels.items()
    }
    return Solution(relations=out, iterations=total_iters, program=program)
