"""The port's warm kernel pack (``observe/aot.py``) on the CPU: a pack
round trip loads the built libraries with no compiler run and zero misses
and gives identical results; environment drift is a counted miss and a
build from the sources; a changed shape is a new dispatch key and never a
stale hit; a corrupt or truncated entry or manifest never raises; a
checkpoint ships the pack and a recovery installs it; a JAX package's pack
is foreign. Here, where there is no ``nvcc``, a stub library built with
``g++`` stands in for a kernel's build, through ``cuda_build._run_compiler``
(the one function that runs the compiler); with no compiler at all a
library lookup raises ``BackendError`` and never falls back."""
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.observe import aot
from kubernetes_verification_tpu_torch.ops import cuda_build
from kubernetes_verification_tpu_torch.resilience.errors import BackendError
from kubernetes_verification_tpu_torch.serve import (
    CheckpointManager,
    RecoveryManager,
    VerificationService,
)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ for the stub library")

_STUB = "extern \"C\" int kv_stub_word(int x) { return 2 * x + %d; }\n"


@pytest.fixture
def fresh_aot(monkeypatch, tmp_path):
    """A private manifest, an empty build directory, fresh per-process
    library state and a stub compiler, so pack round trips see only this
    test's libraries and keys."""
    build = tmp_path / "build"
    runs = []

    def stub_compiler(name, out_path, verbose):
        src = tmp_path / f"{name}.c"
        src.write_text(_STUB % (len(name)))
        runs.append(name)
        return subprocess.Popen(["g++", "-shared", "-fPIC", "-o", out_path, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(cuda_build, "_run_compiler", stub_compiler)
    monkeypatch.setattr(cuda_build, "_HANDLES", {})
    monkeypatch.setattr(cuda_build, "_COMPILED", set())
    monkeypatch.setattr(cuda_build, "_COUNTS", {"nvcc_runs": 0, "hits": 0})
    monkeypatch.setattr(aot, "_MANIFEST", {})
    aot.set_aot(True)
    yield build, runs
    aot.set_aot(None)


def _register(name):
    def _fn(x):
        return x * 2 + 1

    return aot.register_kernel("aot-test", name, _fn)


def _miss(engine, fn, reason):
    return aot.AOT_CACHE_MISSES_TOTAL.labels(engine=engine, fn=fn, reason=reason).value


def _hits(fn):
    return aot.AOT_CACHE_HITS_TOTAL.labels(engine="cuda", fn=fn).value


def _word(name="packed_dir_allow", x=20):
    return cuda_build.load_library(name).kv_stub_word(x)


def _fresh_process(build):
    """What a new process in front of the pack would see: nothing loaded,
    nothing compiled, an empty build directory."""
    aot.drop_executables()
    shutil.rmtree(build, ignore_errors=True)


# ----------------------------------------------------- warm-path round trip
def test_warm_roundtrip_is_zero_miss_and_identical(fresh_aot, tmp_path):
    build, runs = fresh_aot
    k = _register("rt")
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    cold = k(x)
    c0 = _miss("cuda", "packed_dir_allow", "cold")
    cold_word = _word()
    assert runs == ["packed_dir_allow"]
    assert _miss("cuda", "packed_dir_allow", "cold") == c0 + 1  # the build is a miss
    saved = aot.save_pack(str(tmp_path / "pack"))
    assert saved["libraries"] == ["packed_dir_allow"] and saved["bytes"] > 0
    assert saved["entries"] == 2 and saved["dispatch"] == 1
    _fresh_process(build)
    m0, h0 = aot.miss_total(), _hits("packed_dir_allow")
    loaded = aot.load_pack(str(tmp_path / "pack"))
    assert loaded["present"] and loaded["loaded"] == 1 and loaded["dispatch"] == 1
    assert loaded["mismatched"] == 0 and loaded["corrupt"] == 0
    assert _hits("packed_dir_allow") == h0 + 1  # loaded with no compiler run
    assert _word() == cold_word and torch.equal(k(x), cold)
    assert runs == ["packed_dir_allow"] and aot.miss_total() == m0
    assert cuda_build.counts() == {"nvcc_runs": 1, "hits": 1}
    assert os.listdir(build) == [cuda_build.target_name("packed_dir_allow")]


def test_static_args_and_shapes_are_separate_dispatch_keys(fresh_aot, tmp_path):
    """A torch function has nothing to compile: its calls record one key per
    (static value, abstract signature) and are never counted as hits."""
    def _fn(x, *, k):
        return x * k

    kern = aot.register_kernel("aot-test", "st", _fn, static_argnames=("k",))
    h0 = aot.hit_total()
    x = torch.arange(8, dtype=torch.float32)
    for value in (x, x + 1, torch.arange(5.0)):
        for k in (3, 5):
            assert torch.equal(kern(value, k=k), value * k)
    assert len(kern.recorded_keys()) == 4  # 2 shapes x 2 statics
    assert aot.hit_total() == h0
    assert aot.save_pack(str(tmp_path))["dispatch"] == 4
    status = aot.pack_status(str(tmp_path))
    assert status["present"] and status["env_match"] and status["matching"] == 4


# ------------------------------------------------------- key-mismatch walk
@pytest.mark.parametrize("drift", [
    {"device_name": "NVIDIA Imaginary"},
    {"torch": "99.0.0"},
    {"driver": 99999},
])
def test_env_drift_is_a_counted_miss_and_a_build(fresh_aot, tmp_path, monkeypatch, drift):
    build, runs = fresh_aot
    cold_word = _word()
    aot.save_pack(str(tmp_path / "pack"))
    _fresh_process(build)
    drifted = dict(aot.current_env(), **drift)
    monkeypatch.setattr(aot, "current_env", lambda: drifted)
    mm0 = _miss("cuda", "packed_dir_allow", "key-mismatch")
    loaded = aot.load_pack(str(tmp_path / "pack"))
    # built for a different world: counted, never installed
    assert loaded["loaded"] == 0 and loaded["mismatched"] == 1
    assert _miss("cuda", "packed_dir_allow", "key-mismatch") == mm0 + 1
    assert not build.exists() or os.listdir(build) == []
    assert not aot.pack_status(str(tmp_path / "pack"))["env_match"]
    c0 = _miss("cuda", "packed_dir_allow", "cold")
    assert _word() == cold_word  # built again from the sources
    assert _miss("cuda", "packed_dir_allow", "cold") == c0 + 1 and len(runs) == 2


def test_a_host_without_nvcc_matches_any_toolkit_but_nothing_else():
    env = {"torch": "2.11", "nvcc": "release 12.8", "driver": 12080}
    assert aot._env_match(env, dict(env, nvcc=None))
    assert not aot._env_match(env, dict(env, nvcc="release 12.9"))
    assert not aot._env_match(env, dict(env, driver=12090, nvcc=None))
    assert not aot._env_match(dict(env, extra=1), env)


def test_a_library_of_other_sources_is_never_loaded(fresh_aot, tmp_path):
    """The target name carries the sources' hash: a pack entry built from
    other sources is a mismatch, not a load."""
    build, runs = fresh_aot
    _word()
    pack = tmp_path / "pack"
    aot.save_pack(str(pack))
    man_path = pack / aot.PACK_MANIFEST_NAME
    man = json.loads(man_path.read_text())
    (lib,) = [e for e in man["entries"] if e["kind"] == "library"]
    lib["target"] = "libpacked_dir_allow-000000000000.so"
    man_path.write_text(json.dumps(man))
    _fresh_process(build)
    loaded = aot.load_pack(str(pack))
    assert loaded["loaded"] == 0 and loaded["mismatched"] == 1
    assert aot.pack_status(str(pack))["mismatched"] == 1


def test_changed_shape_is_a_new_key_not_a_stale_hit(fresh_aot, tmp_path):
    k = _register("shape")
    k(torch.arange(6.0))
    aot.save_pack(str(tmp_path))
    h0 = aot.hit_total()
    y = torch.arange(10.0)
    assert torch.equal(k(y), y * 2 + 1)
    assert len(k.recorded_keys()) == 2 and aot.hit_total() == h0


# ----------------------------------------------------------- damaged packs
def _packed_library(pack):
    (name,) = [n for n in os.listdir(pack) if n.endswith(".so")]
    return os.path.join(pack, name)


def test_corrupt_pack_entry_is_a_counted_miss_then_a_build(fresh_aot, tmp_path):
    build, runs = fresh_aot
    cold_word = _word()
    pack = str(tmp_path / "pack")
    aot.save_pack(pack)
    path = _packed_library(pack)
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:  # flip bytes: the digest check must catch it
        fh.write(blob[:-8] + b"XXXXXXXX")
    _fresh_process(build)
    cr0 = _miss("cuda", "packed_dir_allow", "corrupt")
    with pytest.warns(RuntimeWarning, match="unusable"):
        loaded = aot.load_pack(pack)
    assert loaded["loaded"] == 0 and loaded["corrupt"] == 1
    assert _miss("cuda", "packed_dir_allow", "corrupt") == cr0 + 1
    assert not build.exists() or os.listdir(build) == []  # never handed to ctypes
    assert _word() == cold_word and len(runs) == 2  # built from the sources


def test_a_digest_mismatch_is_the_jax_packages_internal_marker(fresh_aot, tmp_path):
    """A pack entry whose bytes fail their digest is reported as the JAX
    package reports it (its ``PersistenceDamage`` marker, not a builtin
    ``ValueError``: ROADMAP §3 F6), and stays a counted miss."""
    build, _runs = fresh_aot
    _word()
    pack = str(tmp_path / "pack")
    aot.save_pack(pack)
    path = _packed_library(pack)
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(blob[:-8] + b"XXXXXXXX")
    _fresh_process(build)
    with pytest.warns(RuntimeWarning,
                      match=r"unusable \(PersistenceDamage: payload digest mismatch\)"):
        loaded = aot.load_pack(pack)
    assert loaded["corrupt"] == 1 and issubclass(aot.PersistenceDamage, Exception)


def test_truncated_entry_and_manifest_never_raise(fresh_aot, tmp_path):
    build, runs = fresh_aot
    cold_word = _word()
    pack = str(tmp_path / "pack")
    aot.save_pack(pack)
    path = _packed_library(pack)
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(blob[: len(blob) // 2])
    _fresh_process(build)
    with pytest.warns(RuntimeWarning):
        assert aot.load_pack(pack)["corrupt"] == 1
    assert aot.pack_status(pack)["corrupt"] == 1
    assert _word() == cold_word
    with open(os.path.join(pack, aot.PACK_MANIFEST_NAME), "w") as fh:
        fh.write("not json{{")
    with pytest.warns(RuntimeWarning):
        assert aot.load_pack(pack)["present"] is False
    with pytest.warns(RuntimeWarning):
        assert aot.pack_status(pack)["present"] is False


def test_no_compiler_after_a_failed_pack_raises_and_never_falls_back(
    fresh_aot, tmp_path, monkeypatch
):
    """A corrupt pack on a host with no ``nvcc``: the library lookup raises
    ``BackendError`` (as ``cuda_build._nvcc`` does), counted as a miss."""
    build, _ = fresh_aot
    _word()
    pack = str(tmp_path / "pack")
    aot.save_pack(pack)
    os.remove(_packed_library(pack))
    _fresh_process(build)

    def no_nvcc(name, out_path, verbose):
        raise BackendError("nvcc not found: the CUDA kernels cannot be built",
                           backend="torch")

    monkeypatch.setattr(cuda_build, "_run_compiler", no_nvcc)
    with pytest.warns(RuntimeWarning, match="unusable"):
        assert aot.load_pack(pack)["corrupt"] == 1
    with pytest.raises(BackendError, match="nvcc not found"):
        cuda_build.load_library("packed_dir_allow")


# ------------------------------------------------------- randomized parity
def test_randomized_warm_cold_parity(fresh_aot, tmp_path):
    build, runs = fresh_aot
    k = _register("fuzz")
    rng = np.random.default_rng(0)
    operands = [
        torch.as_tensor(rng.standard_normal((8,)).astype(np.float32)),
        torch.as_tensor(rng.standard_normal((4, 4)).astype(np.float32)),
        torch.as_tensor(rng.integers(-50, 50, size=(16,), dtype=np.int32)),
        torch.as_tensor(rng.standard_normal((2, 3, 5)).astype(np.float32)),
    ]
    cold = [k(x) for x in operands]
    words = {name: _word(name, 7) for name in cuda_build.SOURCES}
    saved = aot.save_pack(str(tmp_path / "pack"))
    assert saved["dispatch"] == len(operands) and len(saved["libraries"]) == 2
    _fresh_process(build)
    loaded = aot.load_pack(str(tmp_path / "pack"))
    assert loaded["loaded"] == 2 and loaded["dispatch"] == len(operands)
    m0 = aot.miss_total()
    for x, ref in zip(operands, cold):
        assert torch.equal(k(x), ref)
    assert {name: _word(name, 7) for name in cuda_build.SOURCES} == words
    assert aot.miss_total() == m0 and len(runs) == 2


def test_disabled_flag_records_nothing(fresh_aot):
    k = _register("off")
    aot.set_aot(False)
    m0, h0 = aot.miss_total(), aot.hit_total()
    x = torch.arange(3.0)
    assert torch.equal(k(x), x * 2 + 1)
    assert aot.miss_total() == m0 and aot.hit_total() == h0
    assert k.recorded_keys() == []  # nothing recorded, nothing to pack


def test_recording_a_key_costs_microseconds(fresh_aot):
    """The served stream is host-bound: a wrapper call at a seen signature
    must stay cheap."""
    import time

    k = _register("cheap")
    args = [torch.zeros(4) for _ in range(8)]
    k(*[args[0]])
    t0 = time.perf_counter()
    for _ in range(2000):
        k(args[0])
    per_call = (time.perf_counter() - t0) / 2000
    assert per_call < 200e-6, per_call


# ------------------------------------------- checkpoint / recover shipping
def test_checkpoint_ships_the_pack_and_recovery_installs_it(fresh_aot, tmp_path):
    build, runs = fresh_aot
    cold_word = _word()
    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=16, n_policies=6, n_namespaces=2, seed=11, p_ipblock_peer=0.0,
        min_selector_labels=1))
    svc = VerificationService(cluster, device="cpu")
    ckdir = str(tmp_path / "ck")
    CheckpointManager(ckdir).checkpoint(svc.engine)
    pack = aot.pack_dir(ckdir)
    assert os.path.exists(os.path.join(pack, aot.PACK_MANIFEST_NAME))
    _fresh_process(build)
    report = RecoveryManager(ckdir).inspect()["aot_pack"]
    assert report["present"] and report["env_match"] and report["corrupt"] == 0
    assert report["libraries"] == ["packed_dir_allow"] and report["entries"] >= 1
    assert report["matching"] == report["entries"]
    h0 = _hits("packed_dir_allow")
    res = RecoveryManager(ckdir).recover(device="cpu")  # installs the pack itself
    assert res.service is not None
    assert _hits("packed_dir_allow") == h0 + 1
    assert _word() == cold_word and runs == ["packed_dir_allow"]


def test_a_pack_failure_never_fails_a_checkpoint(fresh_aot, tmp_path, monkeypatch):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=12, n_policies=4, seed=3))
    svc = VerificationService(cluster, device="cpu")

    def broken(directory):
        raise OSError("disk full")

    monkeypatch.setattr(aot, "save_pack", broken)
    info = CheckpointManager(str(tmp_path / "ck")).checkpoint(svc.engine)
    assert os.path.isdir(info.snapshot_dir)


def test_on_the_cpu_the_pack_holds_the_manifest_and_no_library(fresh_aot, tmp_path):
    _register("cpu-only")(torch.ones(2))
    saved = aot.save_pack(str(tmp_path))
    assert saved["libraries"] == [] and saved["bytes"] == 0 and saved["dispatch"] == 1
    assert os.listdir(str(tmp_path)) == [aot.PACK_MANIFEST_NAME]


def test_a_jax_package_pack_is_foreign(fresh_aot, tmp_path, monkeypatch):
    """A JAX package's checkpoint ships its own pack: the port reads it as
    foreign (a warning and counted misses), loads nothing, and recovers."""
    import kubernetes_verification_tpu as jkv
    from kubernetes_verification_tpu.observe import aot as jaot
    from kubernetes_verification_tpu.serve import CheckpointManager as JaxCheckpointManager
    from kubernetes_verification_tpu.serve import VerificationService as JaxService
    from torch_parity import to_jax

    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=12, n_policies=4, seed=3))
    # the JAX package's own manifest tables, private to this test, so its
    # pack holds only what this test dispatched (nothing else to compile)
    for table in ("_MANIFEST", "_LOADED", "_PAYLOADS"):
        monkeypatch.setattr(jaot, table, {})
    jsvc = JaxService(to_jax(cluster), jkv.VerifyConfig(backend="cpu"))
    ckdir = str(tmp_path / "ck")
    JaxCheckpointManager(ckdir).checkpoint(jsvc.engine)
    m0 = aot.miss_total()
    with pytest.warns(RuntimeWarning, match="not a torch kernel pack"):
        loaded = aot.load_pack(aot.pack_dir(ckdir))
    assert loaded["present"] and loaded["loaded"] == 0
    assert aot.miss_total() == m0 + loaded["mismatched"]
    status = aot.pack_status(aot.pack_dir(ckdir))
    assert status["present"] and not status["env_match"] and status["matching"] == 0
