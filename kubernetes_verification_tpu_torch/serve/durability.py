"""Crash-safe checkpoints and recovery for the serving loop.

The PyTorch port of ``kubernetes_verification_tpu.serve.durability``. A
checkpoint written by either package is recovered by the other: the
snapshot trees are ``utils/persist``'s (file for file the JAX package's),
the manifests and the WAL are byte-compatible.

One part of the JAX module is not here: there is no warm executable pack
to ship beside a checkpoint or to load before recovery. The port's warm
start is the build cache of ``ops/cuda_build.py``, so ``inspect`` (and a
replica's ``/healthz``) reports the pack as absent, with that reason.

The serving loop's contract is: kill the process at any instant and a
restart recovers to exactly the state a from-scratch verification of the
surviving event log would produce. Two pieces deliver it:

* :class:`CheckpointManager` — writes *atomic* checkpoint generations.
  Each generation is an engine snapshot (``utils/persist.save_incremental``
  written into a tmp directory, fsynced, promoted with ``os.replace``)
  plus a JSON manifest binding the snapshot's content digest to the event
  log's path, byte offset and last-applied WAL sequence number — the
  manifest itself carries a sha256 self-checksum and is also written
  tmp + fsync + ``os.replace``. Because the manifest is the *last* thing
  to appear, a crash anywhere in the write path leaves either the previous
  generation intact or a complete new one; there is no observable torn
  state. Rotation keeps the newest ``retain`` generations (the recovery
  ladder's depth).
* :class:`RecoveryManager` — walks the manifest ladder newest-first,
  skipping generations whose manifest checksum, snapshot digest or
  persisted arrays fail verification; loads the first valid one; replays
  the event log from the recorded byte offset, skipping records whose
  sequence number was already applied (zero duplicate application); and
  degrades to a from-scratch rebuild — fresh engine from the initial
  cluster, full log replay — when every checkpoint is corrupt.

Outcomes are counted on ``kvtpu_recoveries_total{outcome}``
(newest / fallback / rebuild), checkpoints on ``kvtpu_checkpoints_total``.
The named kill-points (``after-tmp-write``, ``before-rename``,
``after-manifest`` here; ``mid-log-append`` in :class:`~.events.WalWriter`)
let the fault harness crash the process at every interesting instant of
this write path — ``scripts/check_error_taxonomy.py`` lints this file so
every write stays behind the tmp + ``os.replace`` discipline.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observe import log_event
from ..observe.metrics import CHECKPOINTS_TOTAL, RECOVERIES_TOTAL
from ..resilience.errors import PersistError
from ..resilience.faults import kill_point
from ..runtime import resolve_device
from .events import EventSource, WalInfo, scan_wal

__all__ = [
    "MANIFEST_FORMAT",
    "CLOSURE_FORMAT",
    "CheckpointInfo",
    "CheckpointManager",
    "RecoveryManager",
    "RecoveryResult",
    "load_closure_checkpoint",
    "load_manifest",
]

MANIFEST_FORMAT = 1
#: snapshot format tag for long-closure pass checkpoints (packed matrix +
#: pass counter) — same atomic generation discipline, different payload
CLOSURE_FORMAT = "closure-v1"
_GEN_RE = re.compile(r"^gen-(\d{8})$")
_MANIFEST_RE = re.compile(r"^manifest-(\d{8})\.json$")


def aot_pack_status() -> dict:
    """What ``inspect`` and a replica's ``/healthz`` report for the warm
    executable pack: absent, with the reason (the port ships none)."""
    return {
        "present": False,
        "reason": "no AOT pack: the warm start is the kernel build cache "
        "of ops/cuda_build.py",
    }


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    # directory fsync makes the rename itself durable; not all platforms
    # allow it — degrade silently (the data-file fsyncs still happened)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_tree(directory: str) -> None:
    for root, _dirs, files in os.walk(directory):
        for fname in files:
            _fsync_file(os.path.join(root, fname))
        _fsync_dir(root)


def _tree_digest(directory: str) -> str:
    """sha256 over every file's (relative path, content hash), sorted —
    one string that pins the whole snapshot tree bit-for-bit."""
    h = hashlib.sha256()
    entries: List[Tuple[str, str]] = []
    for root, _dirs, files in os.walk(directory):
        for fname in files:
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, directory).replace(os.sep, "/")
            fh_hash = hashlib.sha256()
            with open(path, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 20), b""):
                    fh_hash.update(block)
            entries.append((rel, fh_hash.hexdigest()))
    for rel, digest in sorted(entries):
        h.update(f"{rel}\0{digest}\n".encode())
    return h.hexdigest()


def _manifest_checksum(manifest: dict) -> str:
    body = {k: v for k, v in manifest.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()
    ).hexdigest()


def _atomic_write_json(path: str, obj: dict, *, fsync: bool = True) -> None:
    """The only write primitive in this module: tmp file + fsync +
    ``os.replace``, so a crash leaves either the old file or the new one,
    never a prefix."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, sort_keys=True, indent=2)
        fh.write("\n")
        if fsync:
            fh.flush()
            os.fsync(fh.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(os.path.dirname(path) or ".")


def load_manifest(path: str) -> dict:
    """Read and checksum-verify one checkpoint manifest; raises
    :class:`PersistError` (with the path) on any damage."""
    try:
        with open(path) as fh:
            manifest = json.load(fh)
    except FileNotFoundError:
        raise
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise PersistError(
            f"{path}: unreadable checkpoint manifest: {e}", path=path
        ) from e
    if not isinstance(manifest, dict) or "checksum" not in manifest:
        raise PersistError(
            f"{path}: checkpoint manifest lacks a checksum", path=path
        )
    if _manifest_checksum(manifest) != manifest["checksum"]:
        raise PersistError(
            f"{path}: checkpoint manifest checksum mismatch — torn or "
            "corrupted write",
            path=path,
        )
    return manifest


@dataclass(frozen=True)
class CheckpointInfo:
    """One committed checkpoint generation (returned by
    :meth:`CheckpointManager.checkpoint`)."""

    generation: int
    manifest_path: str
    snapshot_dir: str
    snapshot_digest: str
    log_path: Optional[str]
    log_offset: int
    last_seq: int


class CheckpointManager:
    """Writes atomic, rotated checkpoint generations into ``directory``.

    Layout: ``gen-<NNNNNNNN>/`` (a ``save_incremental`` tree) next to
    ``manifest-<NNNNNNNN>.json``. The manifest is written last; its
    presence *is* the commit. ``retain`` bounds the ladder depth (old
    generations are deleted manifest-first, so a partially deleted
    generation is never mistaken for a live one).
    """

    def __init__(
        self, directory: str, *, retain: int = 3, fsync: bool = True
    ) -> None:
        self.directory = directory
        self.retain = max(1, int(retain))
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- listing
    def generations(self) -> List[int]:
        """Committed (manifest-bearing) generations, newest first."""
        out = []
        for name in os.listdir(self.directory):
            m = _MANIFEST_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out, reverse=True)

    def manifest_path(self, generation: int) -> str:
        return os.path.join(
            self.directory, f"manifest-{generation:08d}.json"
        )

    def snapshot_dir(self, generation: int) -> str:
        return os.path.join(self.directory, f"gen-{generation:08d}")

    def _next_generation(self) -> int:
        # consider orphan gen-* dirs too: a crash after the snapshot rename
        # but before the manifest leaves one, and its number is burnt
        latest = 0
        for name in os.listdir(self.directory):
            m = _GEN_RE.match(name) or _MANIFEST_RE.match(name)
            if m:
                latest = max(latest, int(m.group(1)))
        return latest + 1

    # ---------------------------------------------------------- checkpoint
    def checkpoint(
        self,
        engine,
        *,
        log_path: Optional[str] = None,
        log_offset: int = 0,
        last_seq: int = -1,
    ) -> CheckpointInfo:
        """Commit one atomic checkpoint generation of ``engine`` (an
        :class:`~..incremental.IncrementalVerifier` or a
        :class:`~..packed_incremental.PackedIncrementalVerifier` — the
        snapshot format records which, and recovery re-detects it),
        binding it to the event-log position (``log_offset`` bytes
        consumed, ``last_seq`` the highest applied WAL sequence number,
        -1 for unsequenced streams)."""
        from ..utils.persist import save_incremental, save_packed_incremental

        gen = self._next_generation()
        snap_dir = self.snapshot_dir(gen)
        tmp_dir = os.path.join(self.directory, f".tmp-gen-{gen:08d}")
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        if getattr(engine, "metrics_engine", "dense") == "packed":
            save_packed_incremental(engine, tmp_dir)
        else:
            save_incremental(engine, tmp_dir)
        digest = _tree_digest(tmp_dir)
        kill_point("after-tmp-write")
        if self.fsync:
            _fsync_tree(tmp_dir)
        kill_point("before-rename")
        os.replace(tmp_dir, snap_dir)
        if self.fsync:
            _fsync_dir(self.directory)
        manifest = {
            "format": MANIFEST_FORMAT,
            "generation": gen,
            "snapshot": os.path.basename(snap_dir),
            "snapshot_digest": digest,
            "event_log": os.path.abspath(log_path) if log_path else None,
            "log_offset": int(log_offset),
            "last_seq": int(last_seq),
        }
        manifest["checksum"] = _manifest_checksum(manifest)
        _atomic_write_json(
            self.manifest_path(gen), manifest, fsync=self.fsync
        )
        kill_point("after-manifest")
        CHECKPOINTS_TOTAL.inc()
        log_event(
            "checkpoint", generation=gen, directory=self.directory,
            log_offset=int(log_offset), last_seq=int(last_seq),
        )
        self._rotate()
        return CheckpointInfo(
            generation=gen,
            manifest_path=self.manifest_path(gen),
            snapshot_dir=snap_dir,
            snapshot_digest=digest,
            log_path=manifest["event_log"],
            log_offset=int(log_offset),
            last_seq=int(last_seq),
        )

    def checkpoint_closure(
        self, packed, passes: int, *, pairs: Optional[int] = None
    ) -> CheckpointInfo:
        """Commit one atomic generation of a long closure job's state: the
        bit-packed reachability matrix plus the squaring-pass counter. Same
        write discipline as :meth:`checkpoint` (tmp tree → digest → fsync →
        rename → manifest last), so a kill at any instant leaves either the
        previous pass checkpoint or a complete new one. The manifest is
        tagged ``kind: closure`` — :class:`RecoveryManager` refuses to load
        it as a serving snapshot, and :func:`load_closure_checkpoint` walks
        the same ladder to resume the loop at the recorded pass. ``packed``
        is an int32 tensor (the port's words) or host uint32 words; it is
        saved as the reference's uint32."""
        gen = self._next_generation()
        snap_dir = self.snapshot_dir(gen)
        tmp_dir = os.path.join(self.directory, f".tmp-gen-{gen:08d}")
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        if isinstance(packed, torch.Tensor):
            arr = packed.cpu().numpy().view("<u4")
        else:
            arr = np.asarray(packed)
        np.savez_compressed(os.path.join(tmp_dir, "packed.npz"), packed=arr)
        state = {
            "format": CLOSURE_FORMAT,
            "passes": int(passes),
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "pairs": None if pairs is None else int(pairs),
        }
        _atomic_write_json(
            os.path.join(tmp_dir, "closure.json"), state, fsync=self.fsync
        )
        digest = _tree_digest(tmp_dir)
        kill_point("after-tmp-write")
        if self.fsync:
            _fsync_tree(tmp_dir)
        kill_point("before-rename")
        os.replace(tmp_dir, snap_dir)
        if self.fsync:
            _fsync_dir(self.directory)
        manifest = {
            "format": MANIFEST_FORMAT,
            "kind": "closure",
            "generation": gen,
            "snapshot": os.path.basename(snap_dir),
            "snapshot_digest": digest,
            "event_log": None,
            "log_offset": 0,
            "last_seq": -1,
            "passes": int(passes),
        }
        manifest["checksum"] = _manifest_checksum(manifest)
        _atomic_write_json(
            self.manifest_path(gen), manifest, fsync=self.fsync
        )
        kill_point("after-manifest")
        CHECKPOINTS_TOTAL.inc()
        log_event(
            "closure_checkpoint", generation=gen, directory=self.directory,
            passes=int(passes),
            pairs=None if pairs is None else int(pairs),
        )
        self._rotate()
        return CheckpointInfo(
            generation=gen,
            manifest_path=self.manifest_path(gen),
            snapshot_dir=snap_dir,
            snapshot_digest=digest,
            log_path=None,
            log_offset=0,
            last_seq=-1,
        )

    def checkpoint_stripe(
        self,
        engine,
        *,
        log_path: Optional[str] = None,
        log_offset: int = 0,
        last_seq: int = -1,
    ) -> CheckpointInfo:
        """Commit one atomic generation of a
        :class:`~.stripes.StripeEngine`: the stripe-sliced snapshot
        (``utils/persist.save_stripe_incremental`` — ``[S, N]`` counts,
        never the whole matrix) bound to the WAL position, manifest
        tagged ``kind: stripe`` with the geometry block so recovery can
        refuse a generation written under a different stripe layout.
        Same write discipline (and kill-points) as :meth:`checkpoint`."""
        from ..utils.persist import save_stripe_incremental

        gen = self._next_generation()
        snap_dir = self.snapshot_dir(gen)
        tmp_dir = os.path.join(self.directory, f".tmp-gen-{gen:08d}")
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        save_stripe_incremental(engine, tmp_dir)
        digest = _tree_digest(tmp_dir)
        kill_point("after-tmp-write")
        if self.fsync:
            _fsync_tree(tmp_dir)
        kill_point("before-rename")
        os.replace(tmp_dir, snap_dir)
        if self.fsync:
            _fsync_dir(self.directory)
        lo, hi = engine.stripe_rows
        manifest = {
            "format": MANIFEST_FORMAT,
            "kind": "stripe",
            "generation": gen,
            "snapshot": os.path.basename(snap_dir),
            "snapshot_digest": digest,
            "event_log": os.path.abspath(log_path) if log_path else None,
            "log_offset": int(log_offset),
            "last_seq": int(last_seq),
            "stripe": {
                "index": int(engine.stripe_index),
                "count": int(engine.stripe_count),
                "lo": int(lo),
                "hi": int(hi),
                "n": len(engine.pods),
            },
        }
        manifest["checksum"] = _manifest_checksum(manifest)
        _atomic_write_json(
            self.manifest_path(gen), manifest, fsync=self.fsync
        )
        kill_point("after-manifest")
        CHECKPOINTS_TOTAL.inc()
        log_event(
            "stripe_checkpoint", generation=gen, directory=self.directory,
            stripe=f"{engine.stripe_index + 1}/{engine.stripe_count}",
            log_offset=int(log_offset), last_seq=int(last_seq),
        )
        self._rotate()
        return CheckpointInfo(
            generation=gen,
            manifest_path=self.manifest_path(gen),
            snapshot_dir=snap_dir,
            snapshot_digest=digest,
            log_path=manifest["event_log"],
            log_offset=int(log_offset),
            last_seq=int(last_seq),
        )

    def _rotate(self) -> None:
        """Keep the newest ``retain`` committed generations; delete the
        manifest before its snapshot so readers never see a manifest whose
        snapshot is mid-deletion. Leftover tmp dirs and orphan snapshots
        older than the retained set are garbage from crashes — collected
        here too."""
        gens = self.generations()
        keep = set(gens[: self.retain])
        for gen in gens[self.retain:]:
            try:
                os.remove(self.manifest_path(gen))
            except FileNotFoundError:
                pass
            shutil.rmtree(self.snapshot_dir(gen), ignore_errors=True)
        newest = max(keep) if keep else 0
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.startswith(".tmp-gen-") and os.path.isdir(full):
                m = re.match(r"^\.tmp-gen-(\d{8})$", name)
                if m and int(m.group(1)) < newest:
                    shutil.rmtree(full, ignore_errors=True)
            m = _GEN_RE.match(name)
            if m and int(m.group(1)) not in keep and int(m.group(1)) < newest:
                shutil.rmtree(full, ignore_errors=True)


def load_closure_checkpoint(directory: str):
    """Resume state for a long closure job: walk the checkpoint ladder in
    ``directory`` newest-first, skip generations whose manifest checksum or
    tree digest fail (same damage tolerance as :class:`RecoveryManager`),
    and return ``(packed, passes, manifest)`` from the first valid
    ``kind: closure`` generation (``packed`` as host uint32 words). Raises
    :class:`PersistError` when no generation holds — the caller restarts
    the closure from pass 0."""
    cm = CheckpointManager(directory)
    errors: List[Tuple[int, str]] = []
    for gen in cm.generations():
        mpath = cm.manifest_path(gen)
        try:
            manifest = load_manifest(mpath)
            if manifest.get("kind") != "closure":
                raise PersistError(
                    f"{mpath}: not a closure checkpoint", path=mpath
                )
            snap = os.path.join(directory, manifest["snapshot"])
            if not os.path.isdir(snap):
                raise PersistError(
                    f"{mpath}: snapshot {manifest['snapshot']} missing",
                    path=snap,
                )
            if _tree_digest(snap) != manifest["snapshot_digest"]:
                raise PersistError(
                    f"{snap}: snapshot digest mismatch", path=snap
                )
            with open(os.path.join(snap, "closure.json")) as fh:
                state = json.load(fh)
            if state.get("format") != CLOSURE_FORMAT:
                raise PersistError(
                    f"{snap}: unknown closure format "
                    f"{state.get('format')!r}",
                    path=snap,
                )
            with np.load(os.path.join(snap, "packed.npz")) as z:
                arr = z["packed"]
            log_event(
                "closure_resume",
                directory=directory,
                generation=gen,
                passes=int(state["passes"]),
            )
            return arr, int(state["passes"]), manifest
        except (
            PersistError, FileNotFoundError, KeyError, OSError, ValueError,
        ) as e:
            errors.append((gen, str(e)))
            log_event("recovery_skip", generation=gen, reason=str(e))
    detail = "; ".join(f"gen {g}: {why}" for g, why in errors)
    raise PersistError(
        f"{directory}: no usable closure checkpoint "
        f"({detail or 'none found'})",
        path=directory,
    )


@dataclass
class RecoveryResult:
    """What :meth:`RecoveryManager.recover` produced."""

    #: the recovered, replay-complete service
    service: object
    #: 'newest' | 'fallback' | 'rebuild'
    outcome: str
    #: generation loaded (-1 on rebuild)
    generation: int
    #: events re-applied from the log after the checkpoint position
    replayed: int
    #: already-applied records skipped by sequence number during replay —
    #: the zero-duplicate-application audit wants this to be 0 when the
    #: checkpoint offset and the WAL agree
    duplicates_skipped: int
    #: highest applied sequence number after replay (-1 = unsequenced)
    last_seq: int
    #: WAL scan summary (None when there was no log to scan)
    wal: Optional[WalInfo]
    #: the positioned EventSource — keep tailing it to resume serving
    source: Optional[EventSource]
    #: (generation, reason) for every ladder rung that was rejected
    errors: List[Tuple[int, str]] = field(default_factory=list)


class RecoveryManager:
    """Recovers a serving engine from a :class:`CheckpointManager`
    directory: newest valid generation, older generations on damage,
    from-scratch rebuild when nothing on the ladder holds."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self._cm = CheckpointManager(directory)

    def inspect(self, *, log_path: Optional[str] = None) -> dict:
        """Validity report for `kv-tpu recover`: every generation's
        manifest/snapshot health plus (optionally) a read-only WAL scan —
        nothing is loaded into an engine and nothing is repaired."""
        report: Dict[str, object] = {"directory": self.directory}
        gens = []
        for gen in self._cm.generations():
            entry: Dict[str, object] = {"generation": gen}
            try:
                manifest = load_manifest(self._cm.manifest_path(gen))
                entry.update(
                    kind=manifest.get("kind", "serve"),
                    log_offset=manifest["log_offset"],
                    last_seq=manifest["last_seq"],
                    event_log=manifest["event_log"],
                )
                if "stripe" in manifest:
                    entry["stripe"] = manifest["stripe"]
                snap = os.path.join(self.directory, manifest["snapshot"])
                if not os.path.isdir(snap):
                    entry["valid"] = False
                    entry["error"] = f"snapshot {manifest['snapshot']} missing"
                elif _tree_digest(snap) != manifest["snapshot_digest"]:
                    entry["valid"] = False
                    entry["error"] = "snapshot digest mismatch"
                else:
                    entry["valid"] = True
            except (PersistError, FileNotFoundError, KeyError) as e:
                entry["valid"] = False
                entry["error"] = str(e)
            gens.append(entry)
        report["generations"] = gens
        report["usable"] = any(g["valid"] for g in gens)
        if log_path:
            try:
                wal = scan_wal(log_path, repair=False)
                report["wal"] = {
                    "path": log_path,
                    "records": wal.records,
                    "sequenced": wal.sequenced,
                    "last_seq": wal.last_seq,
                    "last_epoch": wal.last_epoch,
                    "valid_bytes": wal.valid_bytes,
                    "torn": wal.torn,
                    "torn_bytes": wal.truncated_bytes,
                }
            except Exception as e:  # noqa: BLE001 — report, don't die
                report["wal"] = {"path": log_path, "error": str(e)}
        # replication status: lease/epoch triage rides the same report
        # (import deferred — replication imports this module at top level)
        from .replication import LeaseFile, lease_path

        lp = lease_path(self.directory)
        if os.path.exists(lp):
            report["lease"] = LeaseFile(lp).describe()
        report["aot_pack"] = aot_pack_status()
        return report

    def recover(
        self,
        *,
        log_path: Optional[str] = None,
        initial_cluster=None,
        config=None,
        serve_config=None,
        device=None,
        strict_wal: bool = False,
        batch_size: int = 256,
        engine_factory=None,
    ) -> "RecoveryResult":
        """Load the newest valid checkpoint (falling back down the ladder
        on damage), scan-and-repair the WAL, replay the log from the
        recorded offset skipping already-applied sequence numbers, and
        return the replay-complete service.

        ``log_path`` overrides the manifest's recorded event log (None =
        use the manifest's; rebuilds need it explicitly or there is
        nothing to replay). ``initial_cluster`` enables the from-scratch
        rebuild rung; without it, an all-corrupt ladder raises
        :class:`PersistError`. ``engine_factory`` — an optional
        ``(cluster, config, device) -> engine`` hook applied on the
        rebuild rung, so a follower can rebuild onto a packed
        (matrix-free) engine instead of the dense default; checkpoint
        rungs pick the engine kind from the snapshot itself.

        ``device=None`` means ``"cuda"``: without a GPU this raises
        ``BackendError`` before any rung is read; the CPU runs only when
        the caller passes ``device="cpu"``.
        """
        from .service import VerificationService

        device = resolve_device(device)

        errors: List[Tuple[int, str]] = []
        chosen: Optional[dict] = None
        service = None
        gens = self._cm.generations()
        for gen in gens:
            mpath = self._cm.manifest_path(gen)
            try:
                manifest = load_manifest(mpath)
                if manifest.get("kind") == "closure":
                    raise PersistError(
                        f"{mpath}: closure pass checkpoint, not a serving "
                        "snapshot",
                        path=mpath,
                    )
                if manifest.get("kind") == "stripe":
                    raise PersistError(
                        f"{mpath}: stripe-sliced checkpoint (partial rows) "
                        "— recover it with recover_stripe, not as a "
                        "whole-state serving snapshot",
                        path=mpath,
                    )
                snap = os.path.join(self.directory, manifest["snapshot"])
                if not os.path.isdir(snap):
                    raise PersistError(
                        f"{mpath}: snapshot {manifest['snapshot']} missing",
                        path=snap,
                    )
                digest = _tree_digest(snap)
                if digest != manifest["snapshot_digest"]:
                    raise PersistError(
                        f"{snap}: snapshot digest mismatch (manifest "
                        f"{manifest['snapshot_digest'][:12]}…, tree "
                        f"{digest[:12]}…)",
                        path=snap,
                    )
                service = VerificationService.from_snapshot(
                    snap, serve_config=serve_config,
                    config=config, device=device,
                )
                chosen = manifest
                break
            except (PersistError, FileNotFoundError, KeyError) as e:
                errors.append((gen, str(e)))
                log_event("recovery_skip", generation=gen, reason=str(e))
                continue
        if chosen is not None:
            outcome = "newest" if chosen["generation"] == gens[0] else "fallback"
            offset = int(chosen["log_offset"])
            after_seq = int(chosen["last_seq"])
            generation = int(chosen["generation"])
            replay_path = log_path or chosen["event_log"]
        else:
            if initial_cluster is None:
                detail = "; ".join(f"gen {g}: {why}" for g, why in errors)
                raise PersistError(
                    f"{self.directory}: no usable checkpoint generation "
                    f"({detail or 'none found'}) and no initial cluster to "
                    "rebuild from",
                    path=self.directory,
                )
            if engine_factory is not None:
                service = VerificationService(
                    engine=engine_factory(initial_cluster, config, device),
                    serve_config=serve_config,
                )
            else:
                service = VerificationService(
                    initial_cluster, config, serve_config, device=device
                )
            outcome = "rebuild"
            offset, after_seq, generation = 0, -1, -1
            replay_path = log_path
        wal: Optional[WalInfo] = None
        source: Optional[EventSource] = None
        replayed = 0
        if replay_path and os.path.exists(replay_path):
            wal = scan_wal(replay_path, strict=strict_wal)
            source = EventSource(
                replay_path, offset=offset, start_after_seq=after_seq
            )
            for batch in source.batches(batch_size):
                service.apply(batch)
                replayed += len(batch)
        RECOVERIES_TOTAL.labels(outcome=outcome).inc()
        log_event(
            "recovery", outcome=outcome, generation=generation,
            replayed=replayed,
            duplicates_skipped=source.skipped if source else 0,
            rejected_generations=len(errors),
        )
        return RecoveryResult(
            service=service,
            outcome=outcome,
            generation=generation,
            replayed=replayed,
            duplicates_skipped=source.skipped if source else 0,
            last_seq=source.last_seq if source else after_seq,
            wal=wal,
            source=source,
            errors=errors,
        )

    def recover_stripe(
        self,
        stripe,
        *,
        log_path: Optional[str] = None,
        initial_cluster=None,
        config=None,
        device=None,
        strict_wal: bool = False,
        batch_size: int = 256,
        replica: str = "stripe",
    ) -> "RecoveryResult":
        """Recover ONE stripe owner: walk the ladder newest-first
        accepting only ``kind: stripe`` generations whose recorded
        geometry matches ``stripe = (index, count)`` exactly (a serving
        or closure generation, a different stripe's snapshot, or a
        drifted pod count are all rung failures, not silent loads),
        bootstrap the :class:`~.stripes.StripeEngine` from the sliced
        snapshot, then replay the WAL from the recorded position —
        skipping already-applied sequence numbers like :meth:`recover`.
        Degrades to a rebuild from ``initial_cluster`` (full log replay)
        when no rung holds. ``result.service`` is the positioned
        :class:`~.stripes.StripeFollower`. ``device=None`` means
        ``"cuda"``, as for :meth:`recover`."""
        from ..utils.persist import load_stripe_incremental
        from .stripes import StripeFollower

        device = resolve_device(device)
        k, count = int(stripe[0]), int(stripe[1])
        errors: List[Tuple[int, str]] = []
        chosen: Optional[dict] = None
        engine = None
        gens = self._cm.generations()
        for gen in gens:
            mpath = self._cm.manifest_path(gen)
            try:
                manifest = load_manifest(mpath)
                if manifest.get("kind") != "stripe":
                    raise PersistError(
                        f"{mpath}: not a stripe checkpoint "
                        f"(kind={manifest.get('kind', 'serve')!r})",
                        path=mpath,
                    )
                geo = manifest.get("stripe") or {}
                if (
                    int(geo.get("index", -1)) != k
                    or int(geo.get("count", -1)) != count
                ):
                    raise PersistError(
                        f"{mpath}: stripe {geo.get('index')}"
                        f"/{geo.get('count')} snapshot, caller owns "
                        f"{k}/{count}",
                        path=mpath,
                    )
                snap = os.path.join(self.directory, manifest["snapshot"])
                if not os.path.isdir(snap):
                    raise PersistError(
                        f"{mpath}: snapshot {manifest['snapshot']} missing",
                        path=snap,
                    )
                digest = _tree_digest(snap)
                if digest != manifest["snapshot_digest"]:
                    raise PersistError(
                        f"{snap}: snapshot digest mismatch (manifest "
                        f"{manifest['snapshot_digest'][:12]}…, tree "
                        f"{digest[:12]}…)",
                        path=snap,
                    )
                engine = load_stripe_incremental(
                    snap, (k, count), config=config, device=device
                )
                chosen = manifest
                break
            except (PersistError, FileNotFoundError, KeyError) as e:
                errors.append((gen, str(e)))
                log_event("recovery_skip", generation=gen, reason=str(e))
                continue
        if chosen is not None:
            outcome = (
                "newest" if chosen["generation"] == gens[0] else "fallback"
            )
            offset = int(chosen["log_offset"])
            after_seq = int(chosen["last_seq"])
            generation = int(chosen["generation"])
            replay_path = log_path or chosen["event_log"]
        else:
            if initial_cluster is None:
                detail = "; ".join(f"gen {g}: {why}" for g, why in errors)
                raise PersistError(
                    f"{self.directory}: no usable stripe checkpoint for "
                    f"stripe {k + 1}/{count} ({detail or 'none found'}) "
                    "and no initial cluster to rebuild from",
                    path=self.directory,
                )
            from .stripes import StripeEngine

            engine = StripeEngine(
                initial_cluster, config, device, stripe=(k, count)
            )
            outcome = "rebuild"
            offset, after_seq, generation = 0, -1, -1
            replay_path = log_path
        wal: Optional[WalInfo] = None
        replayed = 0
        follower = StripeFollower(engine=engine, replica=replica)
        source: Optional[EventSource] = None
        if replay_path and os.path.exists(replay_path):
            wal = scan_wal(replay_path, strict=strict_wal)
            source = EventSource(
                replay_path, offset=offset, start_after_seq=after_seq
            )
            follower.log_path = replay_path
            follower.source = source
            replayed = 0
            for batch in source.batches(batch_size):
                follower.apply(batch)
                replayed += len(batch)
        RECOVERIES_TOTAL.labels(outcome=outcome).inc()
        log_event(
            "stripe_recovery", outcome=outcome, generation=generation,
            stripe=f"{k + 1}/{count}", replayed=replayed,
            duplicates_skipped=source.skipped if source else 0,
            rejected_generations=len(errors),
        )
        return RecoveryResult(
            service=follower,
            outcome=outcome,
            generation=generation,
            replayed=replayed,
            duplicates_skipped=source.skipped if source else 0,
            last_seq=source.last_seq if source else after_seq,
            wal=wal,
            source=source,
            errors=errors,
        )
