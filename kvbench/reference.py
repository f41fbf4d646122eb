"""The plain reference: Kubernetes NetworkPolicy reachability from the dicts.

Written from the Kubernetes API's semantics, in plain PyTorch, and sharing
nothing with the program: it imports neither JAX nor either package of this
repository, and works out every derived state (label codes, selector
matches, isolation, peer sets, port atoms, named-port resolution) again from
the plain dicts of ``generate.py``.

Semantics (the configuration's guarantees):

* a policy selects the pods of its namespace that its pod selector matches;
  it isolates them in each direction of its effective policy types
  (explicit ``policy_types``, else Ingress, plus Egress when an egress
  section is present), and only its rules of those directions grant;
* a peer with only a pod selector matches pods of the policy's namespace,
  with a namespace selector the pods of matching namespaces (and the pod
  selector, when it has one); a rule with no peers matches every pod, a rule
  with no ports (or an empty list) every port;
* a pod isolated in a direction accepts only what a rule grants; one not
  isolated accepts everything in it (``default_allow_unselected``); every
  pod reaches itself (``self_traffic``);
* with ports, ``a`` reaches ``b`` when one (protocol, port) is granted in
  both directions; a named port resolves on the destination pod's container
  ports. Without ports, rules grant regardless of their ports.

``solve_rows`` answers whole rows: the pods that each source in ``rows``
reaches, with the two isolation vectors. Destinations are taken in blocks,
so the work fits the device. On a CUDA device the 0/1 products run in
float16: every term is 0 or 1 and none is negative, so a sum is above zero
exactly when one term is, whatever the rounding; on the CPU they run in
float32 with TF32 irrelevant.

``control`` breaks one guarantee on purpose, for the check that the
comparison can fail: ``"no_egress"`` ignores egress policies,
``"ignore_ports"`` answers the any-port question where ports were asked.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PROTOCOLS = ("TCP", "UDP", "SCTP")
_MAX_PORT = 65535
_OPS = ("In", "NotIn", "Exists", "DoesNotExist")


# ---------------------------------------------------------------------------
# the evolving cluster
# ---------------------------------------------------------------------------


def apply_change(cl: Dict, ch: Dict) -> None:
    """Apply one churn change to a working copy of the cluster's dicts."""
    op = ch["op"]
    if op == "pod_relabel":
        cl["pods"][ch["index"]] = {**cl["pods"][ch["index"]], "labels": dict(ch["labels"])}
    elif op == "policy_add":
        key = (ch["policy"]["namespace"], ch["policy"]["name"])
        if any((p["namespace"], p["name"]) == key for p in cl["policies"]):
            raise ValueError(f"policy {key} exists")
        cl["policies"].append(ch["policy"])
    elif op in ("policy_update", "policy_remove"):
        key = (
            (ch["policy"]["namespace"], ch["policy"]["name"])
            if op == "policy_update" else (ch["namespace"], ch["name"])
        )
        at = [i for i, p in enumerate(cl["policies"]) if (p["namespace"], p["name"]) == key]
        if len(at) != 1:
            raise ValueError(f"policy {key} is not resident")
        if op == "policy_update":
            cl["policies"][at[0]] = ch["policy"]
        else:
            del cl["policies"][at[0]]
    else:
        raise ValueError(f"unknown change {op!r}")


def evolve(cluster: Dict, changes: Sequence[Dict]) -> Dict:
    """The cluster after ``changes``, in order; ``cluster`` is untouched."""
    cl = {
        "pods": list(cluster["pods"]),
        "namespaces": list(cluster["namespaces"]),
        "policies": list(cluster["policies"]),
    }
    for ch in changes:
        apply_change(cl, copy.deepcopy(ch))
    return cl


# ---------------------------------------------------------------------------
# selectors
# ---------------------------------------------------------------------------


class _Labels:
    """Label codes: per key a column, per value a code (0 = key absent)."""

    def __init__(self, label_dicts, selectors):
        keys, values = {}, {}

        def see(k, v=None):
            keys.setdefault(k, len(keys))
            vals = values.setdefault(k, {})
            if v is not None:
                vals.setdefault(v, len(vals) + 1)

        for labels in label_dicts:
            for k, v in labels.items():
                see(k, v)
        for s in selectors:
            for k, v in s["match_labels"].items():
                see(k, v)
            for e in s["match_expressions"]:
                see(e["key"])
                for v in e["values"]:
                    see(e["key"], v)
        self.keys, self.values = keys, values
        self.width = 1 + max([len(v) for v in values.values()] or [0])

    def codes(self, label_dicts) -> np.ndarray:
        out = np.zeros((len(label_dicts), max(1, len(self.keys))), dtype=np.int64)
        for i, labels in enumerate(label_dicts):
            for k, v in labels.items():
                out[i, self.keys[k]] = self.values[k][v]
        return out

    def constraints(self, s) -> List[Tuple[int, np.ndarray]]:
        """A selector as (key column, allowed codes) pairs, all of which a
        label set has to meet."""
        out = []
        for k, v in s["match_labels"].items():
            ok = np.zeros(self.width, dtype=bool)
            ok[self.values[k][v]] = True
            out.append((self.keys[k], ok))
        for e in s["match_expressions"]:
            k, op = e["key"], e["op"]
            if op not in _OPS:
                raise ValueError(f"unknown operator {op!r}")
            listed = np.zeros(self.width, dtype=bool)
            listed[[self.values[k][v] for v in e["values"]]] = True
            present = np.ones(self.width, dtype=bool)
            present[0] = False
            ok = {"In": listed & present, "NotIn": ~listed,
                  "Exists": present, "DoesNotExist": ~present}[op]
            out.append((self.keys[k], ok))
        return out


def match_selectors(labels: _Labels, codes: torch.Tensor, selectors,
                    chunk: int = 1024) -> torch.Tensor:
    """bool [S, M]: which of the M label sets (``codes``) each selector
    matches. A selector matches when none of its constraints fails."""
    dev = codes.device
    S, M = len(selectors), codes.shape[0]
    out = torch.zeros((S, M), dtype=torch.bool, device=dev)
    cons = [(si, k, ok) for si, s in enumerate(selectors) for k, ok in labels.constraints(s)]
    if not cons:
        out[:] = True
        return out
    sel_of = torch.tensor([c[0] for c in cons], device=dev)
    key_of = torch.tensor([c[1] for c in cons], device=dev)
    table = torch.tensor(np.stack([c[2] for c in cons]), device=dev)  # [C, W]
    flat = table.reshape(-1)
    base = torch.arange(len(cons), device=dev) * labels.width
    for m0 in range(0, M, chunk):
        v = codes[m0 : m0 + chunk]
        ok = flat[base[None, :] + v[:, key_of]]  # [m, C]
        fails = torch.zeros((v.shape[0], S), dtype=torch.int32, device=dev)
        fails.index_add_(1, sel_of, (~ok).to(torch.int32))
        out[:, m0 : m0 + chunk] = (fails == 0).T
    return out


# ---------------------------------------------------------------------------
# ports
# ---------------------------------------------------------------------------


def _atoms(rules, pods, compute_ports: bool):
    """Port atoms: per protocol, the intervals between every boundary a
    numeric spec draws, cut again at every container port a referenced
    named port can resolve to. ``None`` when ports are not in play."""
    if not compute_ports:
        return None
    bounds = {p: {1, _MAX_PORT + 1} for p in PROTOCOLS}
    named, any_spec = set(), False
    for r in rules:
        for s in r["ports"] or ():
            any_spec = True
            if isinstance(s["port"], str):
                named.add((s["protocol"], s["port"]))
            elif s["port"] is not None:
                hi = s["end_port"] if s["end_port"] is not None else s["port"]
                bounds[s["protocol"]] |= {s["port"], hi + 1}
    if not any_spec:
        return None
    for p in pods:
        for name, (proto, num) in p["container_ports"].items():
            if (proto, name) in named:
                bounds[proto] |= {int(num), int(num) + 1}
    atoms = []
    for proto in PROTOCOLS:
        b = sorted(bounds[proto])
        atoms += [(proto, lo, nxt - 1) for lo, nxt in zip(b, b[1:])]
    return atoms


def _coverage(rules, atoms) -> Tuple[np.ndarray, List[List[Tuple[str, str]]]]:
    """bool [R, Q] atoms each rule's numeric specs cover (all of them for a
    rule without ports), and each rule's named (protocol, name) specs."""
    Q = len(atoms)
    cov = np.zeros((len(rules), Q), dtype=bool)
    named = []
    for i, r in enumerate(rules):
        keys = []
        if not r["ports"]:
            cov[i] = True
        for s in r["ports"] or ():
            if isinstance(s["port"], str):
                keys.append((s["protocol"], s["port"]))
                continue
            lo = 1 if s["port"] is None else s["port"]
            hi = _MAX_PORT if s["port"] is None else (
                s["end_port"] if s["end_port"] is not None else s["port"])
            for q, (proto, alo, ahi) in enumerate(atoms):
                if proto == s["protocol"] and lo <= alo and ahi <= hi:
                    cov[i, q] = True
        named.append(keys)
    return cov, named


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------


def _effective_types(pol) -> Tuple[bool, bool]:
    if pol["policy_types"] is not None:
        types = set(pol["policy_types"])
    else:
        types = {"Ingress"} | ({"Egress"} if pol["egress"] is not None else set())
    return "Ingress" in types, "Egress" in types


def solve_rows(cluster: Dict, rows: Sequence[int], *, compute_ports: bool,
               device="cpu", control: Optional[str] = None,
               col_block: int = 8192) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """``(ingress_isolated, egress_isolated, reach)``: two bool [N] numpy
    vectors and the bool [len(rows), N] rows of the reach matrix (on the
    CPU) for the source pods ``rows``."""
    if control not in (None, "no_egress", "ignore_ports"):
        raise ValueError(f"unknown control {control!r}")
    if control == "ignore_ports":
        compute_ports = False
    dev = torch.device(device)
    half = torch.float16 if dev.type == "cuda" else torch.float32
    pods, pols = cluster["pods"], cluster["policies"]
    nss = {ns["name"]: ns["labels"] for ns in cluster["namespaces"]}
    for p in list(pods) + list(pols):
        nss.setdefault(p["namespace"], {})
    ns_index = {name: i for i, name in enumerate(nss)}
    N, P = len(pods), len(pols)
    rows_t = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=dev)

    # rules per direction, with their policy; the peers of each
    rules = {"in": [], "eg": []}
    aff = np.zeros((2, P), dtype=bool)
    for pi, pol in enumerate(pols):
        aff[0, pi], aff[1, pi] = _effective_types(pol)
        for d, key, a in (("in", "ingress", aff[0, pi]), ("eg", "egress", aff[1, pi])):
            if a:
                rules[d] += [(pi, r) for r in pol[key] or ()]
    peers = [(d, ri, pe) for d in rules for ri, (_, r) in enumerate(rules[d])
             for pe in r["peers"] or ()]
    for _, _, pe in peers:
        if pe.get("ip_block") is not None:
            raise NotImplementedError("ipBlock peers are not part of this configuration")

    pod_sels = [pol["pod_selector"] for pol in pols] + [
        pe["pod_selector"] for _, _, pe in peers if pe["pod_selector"] is not None]
    ns_sels = [pe["namespace_selector"] for _, _, pe in peers
               if pe["namespace_selector"] is not None]
    labels = _Labels([p["labels"] for p in pods] + list(nss.values()), pod_sels + ns_sels)
    pod_codes = torch.as_tensor(labels.codes([p["labels"] for p in pods]), device=dev)
    ns_codes = torch.as_tensor(labels.codes(list(nss.values())), device=dev)
    pod_match = match_selectors(labels, pod_codes, pod_sels)  # [P + peers', N]
    ns_match = match_selectors(labels, ns_codes, ns_sels)  # [peers'', NS]
    pod_ns = torch.as_tensor([ns_index[p["namespace"]] for p in pods], device=dev)
    pol_ns = torch.as_tensor([ns_index[p["namespace"]] for p in pols], device=dev)

    sel = pod_match[:P] & (pod_ns[None, :] == pol_ns[:, None])  # [P, N]
    aff_t = torch.as_tensor(aff, device=dev)
    iso_in = (sel & aff_t[0, :, None]).any(0)
    iso_eg = (sel & aff_t[1, :, None]).any(0)

    # bool [R, N] peer set of every rule: a rule's peers ORed, slot by slot
    rule_peers = {}
    pi_ = ps_ = 0  # running indices into the peers' pod and namespace selectors
    for d in rules:
        rp = torch.zeros((len(rules[d]), N), dtype=torch.bool, device=dev)
        for ri, (_, r) in enumerate(rules[d]):
            if not r["peers"]:
                rp[ri] = True
        by_slot: Dict[int, list] = {}
        for ri, (pi, r) in enumerate(rules[d]):
            for j, pe in enumerate(r["peers"] or ()):
                has_pod = pe["pod_selector"] is not None
                has_ns = pe["namespace_selector"] is not None
                by_slot.setdefault(j, []).append(
                    (ri, pi, P + pi_ if has_pod else -1, ps_ if has_ns else -1))
                pi_ += has_pod
                ps_ += has_ns
        for entries in by_slot.values():
            for c0 in range(0, len(entries), 2048):
                e = torch.as_tensor(entries[c0 : c0 + 2048], dtype=torch.int64, device=dev)
                ri, pi, psel, nsel = e.T
                ns_ok = torch.where(
                    (nsel >= 0)[:, None],
                    ns_match[nsel.clamp(min=0)][:, pod_ns] if len(ns_sels) else False,
                    pod_ns[None, :] == pol_ns[pi][:, None],
                )
                pod_ok = torch.where((psel >= 0)[:, None], pod_match[psel.clamp(min=0)], True)
                rp[ri] |= ns_ok & pod_ok
        rule_peers[d] = rp
    del pod_match

    # port atoms, each rule's coverage, and named-port resolution on dsts
    atoms = _atoms([r for d in rules for _, r in rules[d]], pods, compute_ports)
    if atoms is None:
        groups = [None]
        cov = {d: np.ones((len(rules[d]), 1), dtype=bool) for d in rules}
        named = {d: [[] for _ in rules[d]] for d in rules}
        resolve = {}
    else:
        cov, named = {}, {}
        for d in rules:
            cov[d], named[d] = _coverage([r for _, r in rules[d]], atoms)
        keys = sorted({k for d in rules for ks in named[d] for k in ks})
        resolve = {}
        for proto, name in keys:
            at = np.full(N, -1, dtype=np.int64)
            for b, p in enumerate(pods):
                e = p["container_ports"].get(name)
                if e is not None and e[0] == proto:
                    num = int(e[1])
                    at[b] = next(q for q, (pr, lo, hi) in enumerate(atoms)
                                 if pr == proto and lo <= num <= hi)
            resolve[(proto, name)] = torch.as_tensor(at, device=dev)
        # atoms that no named port resolves to and that every rule covers
        # alike give the same answer: one of each such group is enough
        hit = set()
        for at in resolve.values():
            hit |= set(int(q) for q in torch.unique(at).tolist() if q >= 0)
        sig = np.concatenate([cov["in"], cov["eg"]], axis=0).T  # [Q, R]
        groups, seen = [], set()
        for q in range(len(atoms)):
            key = ("hit", q) if q in hit else sig[q].tobytes()
            if key not in seen:
                seen.add(key)
                groups.append(q)
    cov_t = {d: torch.as_tensor(cov[d], device=dev) for d in rules}
    # the rules with named ports, and which of the named keys each holds
    key_list = sorted(resolve)
    named_rows = {}
    for d in rules:
        idx = [ri for ri, ks in enumerate(named[d]) if ks]
        inc = np.zeros((len(idx), len(key_list)), dtype=np.float32)
        for row, ri in enumerate(idx):
            for k in named[d][ri]:
                inc[row, key_list.index(k)] = 1
        named_rows[d] = (torch.as_tensor(idx, dtype=torch.int64, device=dev),
                         torch.as_tensor(inc, device=dev).to(half))

    pol_of = {d: torch.as_tensor([pi for pi, _ in rules[d]], dtype=torch.int64, device=dev)
              for d in rules}
    # egress: source rows × rules (the source selected by the rule's policy)
    left_eg = sel[:, rows_t][pol_of["eg"]].T.to(half)  # [A, Re]
    # ingress: source rows × rules (the source among the rule's peers)
    left_in = rule_peers["in"][:, rows_t].T.to(half)  # [A, Ri]
    sel_in = sel[pol_of["in"]]  # [Ri, N]
    not_iso_src = ~iso_eg[rows_t][:, None]

    A = len(rows)
    reach = torch.zeros((A, N), dtype=torch.bool, device=dev)
    for b0 in range(0, N, col_block):
        b1 = min(N, b0 + col_block)
        out = torch.zeros((A, b1 - b0), dtype=torch.bool, device=dev)
        for q in groups:
            allow = {}
            for d, right, left in (("eg", rule_peers["eg"][:, b0:b1], left_eg),
                                   ("in", sel_in[:, b0:b1], left_in)):
                g = right & cov_t[d][:, 0 if q is None else q][:, None]
                idx, inc = named_rows[d]
                if len(idx) and q is not None:
                    hits = torch.stack([resolve[k][b0:b1] == q for k in key_list]).to(half)
                    g[idx] |= right[idx] & ((inc @ hits) > 0)
                if len(rules[d]):
                    allow[d] = (left @ g.to(half)) > 0
                else:
                    allow[d] = torch.zeros_like(out)
            e = allow["eg"] | not_iso_src
            i = allow["in"] | ~iso_in[None, b0:b1]
            if control == "no_egress":
                e = torch.ones_like(e)
            out |= e & i
        reach[:, b0:b1] = out
    diag = (rows_t >= 0) & (rows_t < N)
    reach[torch.arange(A, device=dev)[diag], rows_t[diag]] = True
    return iso_in.cpu().numpy(), iso_eg.cpu().numpy(), reach.cpu()


# ---------------------------------------------------------------------------
# judging the program's words
# ---------------------------------------------------------------------------


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """bool [R, 32·W]: bit ``j`` of word ``w`` of a row is pod ``32·w + j``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1).bool()


def pack_rows(reach: torch.Tensor, width: int) -> torch.Tensor:
    """The inverse of ``unpack_words``: bool [R, n] rows as int32 [R, width]
    words, the bits past ``n`` clear."""
    bits = torch.zeros(reach.shape[0], 32 * width, dtype=torch.int64)
    bits[:, : reach.shape[1]] = reach.cpu().to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64)
    words = (bits.reshape(reach.shape[0], width, 32) << shifts).sum(-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def popcount(words: torch.Tensor, chunk: int = 4096) -> int:
    """Set bits of an int32 word matrix, counted in int64."""
    total = 0
    for r0 in range(0, words.shape[0], chunk):
        w = words[r0 : r0 + chunk].to(torch.int64) & 0xFFFFFFFF
        for s in range(32):
            total += int(((w >> s) & 1).sum())
    return total


def compare_rows(words: torch.Tensor, reach: torch.Tensor, n: int) -> Tuple[int, int]:
    """``(rows that differ, bits that differ)`` between the program's words
    of the sampled rows and the reference's rows; set bits past the last pod
    count as differing."""
    got = unpack_words(words.cpu())
    want = torch.zeros_like(got)
    want[:, :n] = reach[:, :n]
    diff = got != want
    return int(diff.any(1).sum()), int(diff.sum())
