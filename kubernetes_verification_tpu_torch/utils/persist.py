"""Checkpoint / resume and artifact export.

The reference's only persistence is debug dumps of SMT2 programs and answers
into a gitignored directory (``kubesv/tests/test_basic.py:24-36``). Here
persistence is first-class:

* ``save_result`` / ``load_result`` — a :class:`VerifyResult` round-trips
  through one ``.npz`` (arrays) + embedded JSON (config/meta);
* ``save_packed`` / ``load_packed`` — the large-N :class:`PackedReach`
  bitmap, 1.25 GB at 100k pods, stored as raw packed words;
* ``save_incremental`` / ``load_incremental`` — an
  :class:`IncrementalVerifier`'s full state (count matrices, per-policy
  contribution vectors, cluster manifests via ``dump_cluster``) so a
  long-lived re-verify service resumes without re-solving (BASELINE
  config 5);
* ``save_stripe_incremental`` / ``load_stripe_incremental`` — a stripe
  engine's ``[S, N]`` row stripes with a ``__stripe__`` geometry member;
* ``save_packed_incremental`` / ``load_packed_incremental`` and
  ``save_ports_incremental`` / ``load_ports_incremental`` — the packed
  serving engines' ``state_dict`` plus the slot-ordered manifest;
* ``export_encoding`` — the encoded tensors + a human-readable summary: the
  tensor-era analogue of the reference's ``get_datalog`` "explain the model"
  dump (``kubesv/kubesv/constraint.py:127-128``).

The port's own copy of ``kubernetes_verification_tpu.utils.persist``: every
artifact has the same members, dtypes and checksum envelope, so a
checkpoint written by either package loads in the other. Two differences
of form, both read by the JAX package: the ``.npz`` members are stored,
not deflated, and an engine checkpoint's cluster manifests are JSON
(``ingest.yaml_io._dump_cluster_json``, no PyYAML needed) — at the flagship
the deflate and PyYAML's emitter took minutes. Device state is copied to
the host on save (packed words as the reference's uint32) and to the
engine's device on load (``device=None`` means ``cuda``). Every checkpoint
carries its semantic flags, and a resume under other flags is refused
(``_check_saved_config``). Host-only.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import zipfile
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..backends.base import PortAtom, VerifyConfig, VerifyResult
from ..ops.bits import to_host_words
from ..resilience.errors import PersistError

__all__ = [
    "PersistError",
    "save_result",
    "load_result",
    "save_packed",
    "load_packed",
    "save_incremental",
    "load_incremental",
    "save_stripe_incremental",
    "load_stripe_incremental",
    "save_packed_incremental",
    "load_packed_incremental",
    "save_ports_incremental",
    "load_ports_incremental",
    "export_encoding",
]

_SEMANTIC_KEYS = (
    "self_traffic",
    "default_allow_unselected",
    "direction_aware_isolation",
    "compute_ports",
    "closure",
)


def _config_json(cfg: VerifyConfig) -> str:
    return json.dumps(
        {"backend": cfg.backend, **{k: getattr(cfg, k) for k in _SEMANTIC_KEYS}}
    )


def _check_saved_config(
    saved: dict,
    config: Optional[VerifyConfig],
    where: str,
    path: Optional[str] = None,
) -> VerifyConfig:
    missing = [k for k in _SEMANTIC_KEYS if k not in saved]
    if missing:
        raise PersistError(
            f"{where}: checkpoint lacks semantic config keys {missing} — "
            "written by an incompatible framework version; re-verify from "
            "scratch instead of resuming",
            path=path,
        )
    if config is None:
        return VerifyConfig(
            **{k: saved[k] for k in _SEMANTIC_KEYS},
            backend=saved.get("backend", "cpu"),
        )
    mismatched = {
        k: (saved[k], getattr(config, k))
        for k in _SEMANTIC_KEYS
        if getattr(config, k) != saved[k]
    }
    if mismatched:
        raise PersistError(
            f"{where}: config overrides the checkpointed semantic flags "
            f"{mismatched}; resume with matching flags or re-verify from "
            "scratch",
            path=path,
        )
    return config


# ------------------------------------------------------------- checksums
#: JSON envelope key carrying per-array sha256 digests inside every .npz
_CHECKSUM_KEY = "__checksums__"


def _digest(arr: np.ndarray) -> str:
    """sha256 over dtype + shape + bytes — a dtype/shape flip with identical
    raw bytes must not verify."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(f"{a.dtype.str}|{a.shape}|".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _savez(path: str, **arrays: np.ndarray) -> None:
    """``np.savez`` with a ``__checksums__`` JSON envelope: ``{array name:
    sha256}`` for every member, so a truncated write or bit-rotted artifact
    is caught at load instead of surfacing as a shape error three layers
    later. The members are stored, not deflated as the JAX package's are
    (``np.load`` reads both): packed reach words barely compress, and
    deflating a flagship engine's ~1.8 GB of state took minutes."""
    sums = {k: _digest(np.asarray(v)) for k, v in arrays.items()}
    np.savez(
        path,
        **arrays,
        **{
            _CHECKSUM_KEY: np.frombuffer(
                json.dumps(sums).encode(), dtype=np.uint8
            )
        },
    )


@contextlib.contextmanager
def _load_npz(path: str) -> Iterator["np.lib.npyio.NpzFile"]:
    """``np.load`` that raises :class:`PersistError` (with the offending
    path) on unreadable/truncated files and on checksum mismatches, instead
    of leaking raw ``zipfile``/``json``/``KeyError`` tracebacks. Artifacts
    written before the checksum envelope existed load unverified."""
    try:
        z = np.load(path)
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
        raise PersistError(
            f"{path}: unreadable or truncated checkpoint: {e}", path=path
        ) from e
    try:
        if _CHECKSUM_KEY in z.files:
            try:
                sums: Dict[str, str] = json.loads(bytes(z[_CHECKSUM_KEY]).decode())
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise PersistError(
                    f"{path}: corrupt checksum envelope: {e}", path=path
                ) from e
            for name, want in sums.items():
                if name not in z.files:
                    raise PersistError(
                        f"{path}: checkpoint is missing array {name!r} "
                        "named by its checksum envelope (truncated write?)",
                        path=path,
                    )
                try:
                    got = _digest(z[name])
                except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
                    raise PersistError(
                        f"{path}: array {name!r} is unreadable: {e}",
                        path=path,
                    ) from e
                if got != want:
                    raise PersistError(
                        f"{path}: sha256 mismatch on array {name!r} "
                        f"(stored {want[:12]}…, computed {got[:12]}…) — "
                        "artifact corrupt; rebuild the checkpoint",
                        path=path,
                    )
        yield z
    finally:
        z.close()


def _member(z, path: str, name: str) -> np.ndarray:
    """Fetch a required array, raising :class:`PersistError` when absent."""
    if name not in z.files:
        raise PersistError(
            f"{path}: checkpoint lacks required array {name!r}", path=path
        )
    return z[name]


def _json_member(z, path: str, name: str) -> dict:
    try:
        return json.loads(bytes(_member(z, path, name)).decode())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise PersistError(
            f"{path}: corrupt JSON envelope {name!r}: {e}", path=path
        ) from e


def _member_dict(arrays: dict, path: str, name: str) -> np.ndarray:
    if name not in arrays:
        raise PersistError(
            f"{path}: checkpoint lacks required array {name!r}", path=path
        )
    return arrays[name]

_OPT = ("reach_ports", "src_sets", "dst_sets", "selected",
        "ingress_isolated", "egress_isolated", "closure")


def save_result(result: VerifyResult, path: str) -> None:
    meta = {
        "n_pods": result.n_pods,
        "mode": result.mode,
        "backend": result.backend,
        "config": {
            "backend": result.config.backend,
            "self_traffic": result.config.self_traffic,
            "default_allow_unselected": result.config.default_allow_unselected,
            "direction_aware_isolation": result.config.direction_aware_isolation,
            "compute_ports": result.config.compute_ports,
            "closure": result.config.closure,
        },
        "port_atoms": [
            [a.protocol, a.lo, a.hi, a.name] for a in result.port_atoms
        ],
        "timings": result.timings,
    }
    arrays = {"reach": result.reach}
    for name in _OPT:
        v = getattr(result, name)
        if v is not None:
            arrays[name] = v
    _savez(
        path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **arrays,
    )


def load_result(path: str) -> VerifyResult:
    with _load_npz(path) as z:
        meta = _json_member(z, path, "__meta__")
        arrays = {
            k: z[k]
            for k in z.files
            if k not in ("__meta__", _CHECKSUM_KEY)
        }
    try:
        return VerifyResult(
            n_pods=meta["n_pods"],
            mode=meta["mode"],
            backend=meta["backend"],
            config=VerifyConfig(**meta["config"]),
            reach=_member_dict(arrays, path, "reach"),
            port_atoms=[
                PortAtom(protocol=p, lo=lo, hi=hi, name=n)
                for p, lo, hi, n in meta["port_atoms"]
            ],
            timings=meta.get("timings") or {},
            **{k: arrays.get(k) for k in _OPT},
        )
    except (KeyError, TypeError) as e:
        raise PersistError(
            f"{path}: result envelope is missing/invalid: {e!r}", path=path
        ) from e


def save_packed(packed_reach, path: str) -> None:
    """Persist a :class:`~..ops.tiled.PackedReach`."""
    words = packed_reach.packed
    _savez(
        path,
        packed=to_host_words(words) if isinstance(words, torch.Tensor) else np.asarray(words),
        n_pods=np.int64(packed_reach.n_pods),
        ingress_isolated=packed_reach.ingress_isolated,
        egress_isolated=packed_reach.egress_isolated,
    )


def load_packed(path: str):
    from ..ops.tiled import PackedReach

    with _load_npz(path) as z:
        return PackedReach(
            packed=_member(z, path, "packed"),
            n_pods=int(_member(z, path, "n_pods")),
            ingress_isolated=_member(z, path, "ingress_isolated"),
            egress_isolated=_member(z, path, "egress_isolated"),
        )


#: an engine checkpoint's manifest files under ``<dir>/cluster``, one per kind
_MANIFEST_STEMS = ("namespaces", "networkpolicies", "pods")


def _write_manifests(cluster, directory: str) -> None:
    """An engine checkpoint's JSON manifests. A directory the JAX package's
    writer saved into holds its YAML set; that set goes first, or it would
    load beside this one."""
    from ..ingest.yaml_io import _dump_cluster_json

    for stem in _MANIFEST_STEMS:
        stale = os.path.join(directory, stem + ".yaml")
        if os.path.exists(stale):
            os.remove(stale)
    _dump_cluster_json(cluster, directory)


def _read_manifests(directory: str):
    """An engine checkpoint's cluster. Where the directory holds both
    packages' manifest sets (the JAX package's writer saves its YAML set
    beside this package's JSON one), the newer set is the checkpoint's."""
    from ..ingest import load_cluster
    from ..ingest.yaml_io import _load_cluster_files

    sets = {
        ext: [os.path.join(directory, stem + ext) for stem in _MANIFEST_STEMS
              if os.path.exists(os.path.join(directory, stem + ext))]
        for ext in (".json", ".yaml")
    }
    if not (sets[".json"] and sets[".yaml"]):
        return load_cluster(directory)[0]
    newest = max(sets, key=lambda ext: max(os.stat(f).st_mtime_ns for f in sets[ext]))
    return _load_cluster_files(sets[newest])[0]


def save_incremental(inc, directory: str) -> None:
    """Checkpoint an :class:`~..incremental.IncrementalVerifier` — including
    its semantic config, so a resume can't silently flip flags."""
    os.makedirs(directory, exist_ok=True)
    _write_manifests(inc.as_cluster(), os.path.join(directory, "cluster"))
    keys = list(inc.policies)
    vec = {
        f"vec_{i}": np.stack(inc._vectors[k]) for i, k in enumerate(keys)
    }
    config_json = _config_json(inc.config)
    _savez(
        os.path.join(directory, "state.npz"),
        ing_count=inc._ing_count.cpu().numpy(),
        eg_count=inc._eg_count.cpu().numpy(),
        ing_iso=inc._ing_iso,
        eg_iso=inc._eg_iso,
        keys=np.array(keys),
        update_count=np.int64(inc.update_count),
        __config__=np.frombuffer(config_json.encode(), dtype=np.uint8),
        **vec,
    )


def load_incremental(directory: str, config: Optional[VerifyConfig] = None,
                     device=None):
    """Resume an :class:`~..incremental.IncrementalVerifier` from a
    checkpoint without re-solving."""
    from ..incremental import IncrementalVerifier
    from ..models.core import Cluster

    cluster = _read_manifests(os.path.join(directory, "cluster"))
    state_path = os.path.join(directory, "state.npz")
    with _load_npz(state_path) as z:
        saved = _json_member(z, state_path, "__config__")
        # The checkpointed counts were derived under the saved semantic
        # flags; reinterpreting them under different flags is silent
        # corruption. Only the backend/device choice may differ on resume.
        config = _check_saved_config(
            saved, config, "load_incremental", state_path
        )
        inc = IncrementalVerifier(
            Cluster(pods=cluster.pods, namespaces=cluster.namespaces, policies=[]),
            config,
            device=device,
        )
        inc._ing_count = torch.tensor(
            _member(z, state_path, "ing_count"), device=inc.device
        )
        inc._eg_count = torch.tensor(
            _member(z, state_path, "eg_count"), device=inc.device
        )
        inc._ing_iso = _member(z, state_path, "ing_iso").copy()
        inc._eg_iso = _member(z, state_path, "eg_iso").copy()
        inc.update_count = int(_member(z, state_path, "update_count"))
        keys = [str(k) for k in _member(z, state_path, "keys")]
        by_key = {f"{p.namespace}/{p.name}": p for p in cluster.policies}
        for i, key in enumerate(keys):
            v = _member(z, state_path, f"vec_{i}")
            if key not in by_key:
                raise PersistError(
                    f"{state_path}: state names policy {key!r} absent from "
                    "the checkpoint manifest — state/manifest mismatch",
                    path=state_path,
                )
            inc.policies[key] = by_key[key]
            inc._vectors[key] = tuple(row.copy() for row in v.astype(bool))
    inc._reach_dirty = True
    return inc


def save_stripe_incremental(inc, directory: str) -> None:
    """Checkpoint a :class:`~..serve.stripes.StripeEngine`: the same
    envelope as :func:`save_incremental` but the count arrays are the
    engine's ``[S, N]`` row stripes, and a ``__stripe__`` JSON member
    records the geometry — a resume into a different stripe index/count
    (or a drifted pod count) is refused instead of landing rows off by
    one. File for file the JAX package's (the cluster manifest is JSON,
    which it reads too)."""
    os.makedirs(directory, exist_ok=True)
    _write_manifests(inc.as_cluster(), os.path.join(directory, "cluster"))
    keys = list(inc.policies)
    vec = {
        f"vec_{i}": np.stack(inc._vectors[k]) for i, k in enumerate(keys)
    }
    lo, hi = inc.stripe_rows
    stripe_json = json.dumps(
        {
            "index": int(inc.stripe_index),
            "count": int(inc.stripe_count),
            "lo": int(lo),
            "hi": int(hi),
            "n": len(inc.pods),
        }
    )
    config_json = _config_json(inc.config)
    _savez(
        os.path.join(directory, "state.npz"),
        ing_count=inc._ing_count.cpu().numpy(),
        eg_count=inc._eg_count.cpu().numpy(),
        ing_iso=inc._ing_iso,
        eg_iso=inc._eg_iso,
        keys=np.array(keys),
        update_count=np.int64(inc.update_count),
        __config__=np.frombuffer(config_json.encode(), dtype=np.uint8),
        __stripe__=np.frombuffer(stripe_json.encode(), dtype=np.uint8),
        **vec,
    )


def load_stripe_incremental(
    directory: str,
    stripe,
    config: Optional[VerifyConfig] = None,
    device=None,
):
    """Resume a :class:`~..serve.stripes.StripeEngine` for ``stripe =
    (index, count)`` from a stripe-sliced checkpoint. The snapshot's
    recorded geometry must match the requested stripe exactly — the
    count rows are positional, so any drift is refused as
    :class:`PersistError`, never reinterpreted. ``device=None`` means
    ``"cuda"``; a checkpoint of either package loads here."""
    from ..models.core import Cluster
    from ..serve.stripes import StripeEngine

    k, count = int(stripe[0]), int(stripe[1])
    cluster = _read_manifests(os.path.join(directory, "cluster"))
    state_path = os.path.join(directory, "state.npz")
    with _load_npz(state_path) as z:
        saved = _json_member(z, state_path, "__config__")
        config = _check_saved_config(
            saved, config, "load_stripe_incremental", state_path
        )
        geo = _json_member(z, state_path, "__stripe__")
        if (
            int(geo.get("index", -1)) != k
            or int(geo.get("count", -1)) != count
            or int(geo.get("n", -1)) != len(cluster.pods)
        ):
            raise PersistError(
                f"{state_path}: stripe geometry mismatch — snapshot holds "
                f"stripe {geo.get('index')}/{geo.get('count')} of "
                f"{geo.get('n')} pods, caller asked for {k}/{count} of "
                f"{len(cluster.pods)}; rebuild instead of resuming",
                path=state_path,
            )
        inc = StripeEngine(
            Cluster(
                pods=cluster.pods, namespaces=cluster.namespaces, policies=[]
            ),
            config,
            device=device,
            stripe=(k, count),
        )
        lo, hi = inc.stripe_rows
        if (int(geo["lo"]), int(geo["hi"])) != (lo, hi):
            raise PersistError(
                f"{state_path}: stripe bounds drifted — snapshot rows "
                f"[{geo['lo']}, {geo['hi']}), geometry says [{lo}, {hi})",
                path=state_path,
            )
        ing = _member(z, state_path, "ing_count")
        if ing.shape != (hi - lo, len(cluster.pods)):
            raise PersistError(
                f"{state_path}: stripe count shape {ing.shape} does not "
                f"match rows [{lo}, {hi}) over {len(cluster.pods)} pods",
                path=state_path,
            )
        inc._ing_count = torch.tensor(ing, device=inc.device)
        inc._eg_count = torch.tensor(
            _member(z, state_path, "eg_count"), device=inc.device
        )
        inc._ing_iso = _member(z, state_path, "ing_iso").copy()
        inc._eg_iso = _member(z, state_path, "eg_iso").copy()
        inc.update_count = int(_member(z, state_path, "update_count"))
        keys = [str(kk) for kk in _member(z, state_path, "keys")]
        by_key = {f"{p.namespace}/{p.name}": p for p in cluster.policies}
        for i, key in enumerate(keys):
            v = _member(z, state_path, f"vec_{i}")
            if key not in by_key:
                raise PersistError(
                    f"{state_path}: state names policy {key!r} absent from "
                    "the checkpoint manifest — state/manifest mismatch",
                    path=state_path,
                )
            inc.policies[key] = by_key[key]
            inc._vectors[key] = tuple(row.copy() for row in v.astype(bool))
    inc._reach_dirty = True
    return inc


def save_packed_incremental(inc, directory: str) -> None:
    """Checkpoint a :class:`~..packed_incremental.PackedIncrementalVerifier`
    — the config-5 diff engine: cluster manifest + bit-packed per-policy
    maps + isolation counts + (when kept) the packed matrix + slot layout +
    dirty bookkeeping. ~8× smaller than the device state thanks to the
    bit-packing. An engine on a mesh is saved by every rank together (its
    ``state_dict`` gathers the shards): rank 0 writes the files, and no
    rank returns before they exist."""
    state = inc.state_dict()
    if _writes(inc):
        os.makedirs(directory, exist_ok=True)
        # include_inactive: the manifest's pod list position IS the slot
        # index, so tombstoned pod slots must keep their place
        # (state["pod_active"] marks them on resume)
        _write_manifests(
            inc.as_cluster(include_inactive=True), os.path.join(directory, "cluster")
        )
        _savez(
            os.path.join(directory, "state.npz"),
            __config__=np.frombuffer(
                _config_json(inc.config).encode(), dtype=np.uint8
            ),
            **state,
        )
    _saved(inc)


def _writes(inc) -> bool:
    """Whether this process writes an engine's checkpoint: always on one
    device, rank 0 of a mesh."""
    mesh = getattr(inc, "mesh", None)
    return mesh is None or mesh.rank == 0


def _saved(inc) -> None:
    """On a mesh, wait until rank 0 has written the checkpoint."""
    mesh = getattr(inc, "mesh", None)
    if mesh is not None:
        from ..parallel.mesh import barrier

        barrier(mesh)


def load_packed_incremental(
    directory: str,
    config: Optional[VerifyConfig] = None,
    device=None,
    mesh=None,
    keep_matrix: Optional[bool] = None,
):
    """Resume a :class:`~..packed_incremental.PackedIncrementalVerifier`
    from a checkpoint without re-solving: state arrays upload straight to
    the device, or each rank's block of them onto ``mesh`` (every rank
    calls this; a checkpoint saved on one factorisation resumes on another,
    or on one device, and the reverse); only the host vectorizer re-freezes
    on the manifest's labels."""
    from ..packed_incremental import PackedIncrementalVerifier

    cluster = _read_manifests(os.path.join(directory, "cluster"))
    state_path = os.path.join(directory, "state.npz")
    with _load_npz(state_path) as z:
        saved = _json_member(z, state_path, "__config__")
        config = _check_saved_config(
            saved, config, "load_packed_incremental", state_path
        )
        state = {
            k: z[k]
            for k in z.files
            if k not in ("__config__", _CHECKSUM_KEY)
        }
    return PackedIncrementalVerifier.from_state(
        cluster, state, config, device=device, mesh=mesh, keep_matrix=keep_matrix,
    )


def save_ports_incremental(inc, directory: str) -> None:
    """Checkpoint a :class:`~..packed_incremental_ports.
    PackedPortsIncrementalVerifier`: cluster manifest + bit-packed VP
    operands + counts + packed matrix + frozen layout/universe metadata. On
    a mesh every rank saves together, as ``save_packed_incremental``."""
    arrays, meta = inc.state_dict()
    if _writes(inc):
        os.makedirs(directory, exist_ok=True)
        # slot-ordered manifest: tombstoned pods stay in place so list
        # position == slot index on resume (paired with the saved pod_active
        # map)
        _write_manifests(
            inc.as_cluster(include_inactive=True), os.path.join(directory, "cluster")
        )
        _savez(
            os.path.join(directory, "state.npz"),
            __config__=np.frombuffer(
                _config_json(inc.config).encode(), dtype=np.uint8
            ),
            __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **arrays,
        )
    _saved(inc)


def load_ports_incremental(
    directory: str,
    config: Optional[VerifyConfig] = None,
    device=None,
    mesh=None,
):
    """Resume a port-bitmap incremental verifier without re-solving (onto
    ``mesh`` as ``load_packed_incremental`` does); the frozen universe
    re-derives deterministically from the manifest."""
    from ..packed_incremental_ports import PackedPortsIncrementalVerifier

    cluster = _read_manifests(os.path.join(directory, "cluster"))
    state_path = os.path.join(directory, "state.npz")
    with _load_npz(state_path) as z:
        saved = _json_member(z, state_path, "__config__")
        config = _check_saved_config(
            saved, config, "load_ports_incremental", state_path
        )
        meta = _json_member(z, state_path, "__meta__")
        arrays = {
            k: z[k]
            for k in z.files
            if k not in ("__config__", "__meta__", _CHECKSUM_KEY)
        }
    return PackedPortsIncrementalVerifier.from_state(
        cluster, arrays, meta, config, device=device, mesh=mesh
    )


def export_encoding(enc, path_prefix: str) -> str:
    """Dump an :class:`~..encode.encoder.EncodedCluster` as ``.npz`` + a text
    summary — the debug/"explain" facility (SURVEY.md §5.5)."""
    arrays = {
        "pod_kv": enc.pod_kv, "pod_key": enc.pod_key, "pod_ns": enc.pod_ns,
        "ns_kv": enc.ns_kv, "ns_key": enc.ns_key, "pol_ns": enc.pol_ns,
        "pol_affects_ingress": enc.pol_affects_ingress,
        "pol_affects_egress": enc.pol_affects_egress,
    }
    for prefix, block in (("ingress", enc.ingress), ("egress", enc.egress)):
        arrays[f"{prefix}_pol"] = block.pol
        arrays[f"{prefix}_match_all"] = block.match_all
        arrays[f"{prefix}_ports"] = block.ports
        arrays[f"{prefix}_is_ipblock"] = block.is_ipblock
        if block.dst_restrict is not None:
            arrays[f"{prefix}_dst_restrict"] = block.dst_restrict
    if enc.restrict_bank is not None:
        arrays["restrict_bank"] = enc.restrict_bank
    _savez(path_prefix + ".npz", **arrays)

    lines = [
        f"EncodedCluster: {enc.n_pods} pods, {enc.n_namespaces} namespaces, "
        f"{enc.n_policies} policies",
        f"vocab: {enc.vocab.n_pairs} label pairs, {enc.vocab.n_keys} keys",
        f"port atoms ({len(enc.atoms)}):",
    ]
    for a in enc.atoms:
        lines.append(f"  {a.protocol} {a.name or f'{a.lo}-{a.hi}'}")
    for prefix, block in (("ingress", enc.ingress), ("egress", enc.egress)):
        restricted = (
            int((block.dst_restrict > 0).sum())
            if block.dst_restrict is not None
            else 0
        )
        lines.append(
            f"{prefix}: {block.n} grant rows "
            f"({int(block.match_all.sum())} match-all, "
            f"{int(block.is_ipblock.sum())} ipBlock, "
            f"{restricted} named-port restricted)"
        )
    if enc.restrict_bank is not None:
        lines.append(
            f"named-port restriction bank: {enc.restrict_bank.shape[0]} rows"
        )
    txt = path_prefix + ".txt"
    with open(txt, "w") as fh:  # kvtpu: ignore[atomic-write] human-readable export summary, regenerated on demand
        fh.write("\n".join(lines) + "\n")
    return txt
