"""The port's front door (``serve/admission.py``, ``serve/ingress.py``,
``serve/autoscale.py``) and fleet plane (``observe/fleet.py``) against the
JAX package's, on the CPU. Under one fake clock per scenario, the token
buckets, the admission decisions (admitted, or the typed rejection with its
reason and retry-after), the brown-out ladder and the autoscaler's
decisions are the same in both packages; an ``Ingress`` over each package's
query engine answers the same probes and sheds alike, also over HTTP
(``POST /v1/query``, 429 with ``Retry-After``); SLO burn rates and the
rendered fleet table are the same. Exact throughout."""
import http.client
import json

import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
from kubernetes_verification_tpu.observe import fleet as jfleet
from kubernetes_verification_tpu.resilience import errors as jerrors
from kubernetes_verification_tpu.serve import admission as jadm
from kubernetes_verification_tpu.serve import autoscale as jauto
from kubernetes_verification_tpu.serve import ingress as jing
from kubernetes_verification_tpu.serve import queries as jqueries
from kubernetes_verification_tpu.serve import service as jax_service
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.observe import fleet as pfleet
from kubernetes_verification_tpu_torch.resilience import errors as perrors
from kubernetes_verification_tpu_torch.serve import VerificationService
from kubernetes_verification_tpu_torch.serve import admission as padm
from kubernetes_verification_tpu_torch.serve import autoscale as pauto
from kubernetes_verification_tpu_torch.serve import ingress as ping
from kubernetes_verification_tpu_torch.serve import queries as pqueries
from kubernetes_verification_tpu_torch.serve.transport import ReplicationServer
from torch_serve_parity import clusters, install_clock

_PKGS = {"port": (padm, ping, pauto, pfleet, perrors),
         "jax": (jadm, jing, jauto, jfleet, jerrors)}


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _admission_trace(pkg):
    """One scripted admission session; returns every decision."""
    adm, _, _, _, errors = _PKGS[pkg]
    clock = FakeClock()
    ctl = adm.AdmissionController(
        [adm.TenantQuota("tiny", rate=10.0, burst=10.0),
         adm.TenantQuota("batch", rate=1e6, burst=1e6, priority=0),
         adm.TenantQuota("prod", rate=1e6, burst=1e6, priority=2)],
        config=adm.AdmissionConfig(max_concurrency=16, escalate_ticks=1,
                                   recover_ticks=2, high_water=0.8,
                                   shed_priority_below=1),
        clock=clock,
    )
    out, held = [], []
    script = [("tiny", 10), ("tiny", 4), ("adv", 0.5), ("tiny", 4), ("prod", 12),
              ("batch", 8), ("release",), ("batch", 8), ("p", 0.9), ("p", 0.9),
              ("batch", 1), ("prod", 1), ("p", 0.9), ("prod", 1), ("p", 0.1),
              ("p", 0.1), ("prod", 1), ("unknown", 3)]
    for step in script:
        if step[0] == "adv":
            clock.advance(step[1])
            continue
        if step[0] == "release":
            for t in held:
                t.release()
            held.clear()
            continue
        if step[0] == "p":
            out.append(("level", ctl.observe_pressure(step[1])))
            continue
        try:
            held.append(ctl.admit(*step))
            out.append(("admitted", step, ctl.in_flight))
        except errors.AdmissionRejectedError as e:
            out.append(("rejected", step, e.reason, e.tenant, round(e.retry_after_s, 9)))
    for t in held:
        t.release()
    out.append(("describe", json.dumps(ctl.describe(), sort_keys=True, default=str)))
    return out


def test_admission_decisions_equal_jax():
    mine, theirs = _admission_trace("port"), _admission_trace("jax")
    assert mine == theirs
    reasons = {d[2] for d in mine if d[0] == "rejected"}
    assert {"over-quota", "concurrency", "brownout"} <= reasons


def _bucket_trace(pkg):
    adm = _PKGS[pkg][0]
    clock = FakeClock()
    b = adm.TokenBucket(rate=10.0, burst=20.0, clock=clock)
    out = [b.take(20), b.take(1), b.retry_after(5)]
    clock.advance(0.5)
    out += [b.take(5), b.retry_after(10_000), b.utilization]
    clock.advance(7.25)
    out += [b.utilization, b.take(19.5), b.retry_after(3)]
    return out


def test_token_bucket_equal_jax():
    assert _bucket_trace("port") == _bucket_trace("jax")
    with pytest.raises(perrors.ConfigError):
        padm.TokenBucket(rate=0.0, burst=5.0)


def _brownout_trace(pkg):
    b = _PKGS[pkg][0].BrownoutController(high_water=0.8, low_water=0.3, escalate_ticks=2,
                                         recover_ticks=3, shed_priority_below=1)
    out = []
    for p in (0.9, 0.5, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.1, 0.1, 0.1, 0.5, 0.1):
        out.append((b.observe(p), b.whatif_enabled, b.sheds(0), b.sheds(99)))
    out.append(json.dumps(b.describe(), sort_keys=True))
    return out


def test_brownout_ladder_equal_jax():
    mine = _brownout_trace("port")
    assert mine == _brownout_trace("jax")
    assert max(level for level, *_ in mine[:-1]) == 3


def _autoscale_trace(pkg):
    _, _, auto, fleet, _ = _PKGS[pkg]
    clock = FakeClock()
    sizes = []
    a = auto.FleetAutoscaler(lambda: sizes.append("+"), lambda: sizes.append("-"),
                             config=auto.AutoscaleConfig(min_fleet=1, max_fleet=2,
                                                         hysteresis_ticks=2,
                                                         cooldown_s=10.0),
                             initial_fleet=1, clock=clock)
    out = [a.observe(burn=5.0), a.observe(burn=0.0, lag_s=0.0), a.observe(burn=5.0),
           a.observe(burn=5.0), a.observe(burn=5.0)]
    clock.advance(11.0)
    out.append(a.observe(burn=5.0))
    clock.advance(11.0)
    out += [a.observe(burn=0.0, lag_s=0.0, pressure=0.0) for _ in range(2)]
    clock.advance(11.0)
    out += [a.observe(burn=0.0), a.observe(pressure=0.99), a.observe(lag_s=1e3)]
    down = fleet.ReplicaScrape(url="http://127.0.0.1:1", ok=False, error="boom")
    mon = fleet.SloMonitor([fleet.parse_slo_spec("availability=0.5")])
    clock.advance(100.0)
    out.append(a.observe_fleet(mon, [down]))
    out.append((sizes, a.fleet_size, json.dumps(a.describe(), sort_keys=True)))
    return out


def test_autoscale_decisions_equal_jax():
    mine = _autoscale_trace("port")
    assert mine == _autoscale_trace("jax")
    assert {"scale-up", "scale-down", "clamped", "hold"} <= set(mine[:-1])
    with pytest.raises(perrors.ConfigError):
        pauto.AutoscaleConfig(min_fleet=3, max_fleet=1).validate()


def _slo_trace(pkg):
    fleet = _PKGS[pkg][3]
    mon = fleet.SloMonitor([fleet.parse_slo_spec("availability=0.9"),
                            fleet.parse_slo_spec("staleness=0.95@2.0")])
    for i, ok in enumerate((False, False, True, False, True, True)):
        mon.record("availability", ok, ts=100.0 + i, source=f"http://r{i % 2}:1")
    up = fleet.ReplicaScrape(url="http://a:1", ok=True,
                             health={"role": "leader", "replica": "a", "epoch": 3,
                                     "last_seq": 41, "lag": {"seconds": 0.5, "seq": 0},
                                     "breakers": {}},
                             metrics={})
    down = fleet.ReplicaScrape(url="http://b:1", ok=False, error="down")
    for scrape in (up, down):
        mon.observe_scrape(scrape)
    rates = mon.evaluate(windows=(60.0, 3600.0), now=110.0)
    later = mon.burn_rate("availability", 30.0, now=200.0)
    return rates, later, fleet.render_fleet([up, down]), repr(
        fleet.parse_slo_spec("availability=0.99"))


def test_slo_burn_rates_and_fleet_table_equal_jax():
    assert _slo_trace("port") == _slo_trace("jax")


@pytest.fixture(scope="module")
def engines():
    pcluster, jcluster = clusters(n_pods=30, n_policies=8, n_namespaces=3, seed=9)
    psvc = VerificationService(pcluster, kvt.VerifyConfig(compute_ports=False), device="cpu")
    jsvc = jax_service.VerificationService(jcluster, jkv.VerifyConfig(compute_ports=False))
    names = [f"{p.namespace}/{p.name}" for p in pcluster.pods]
    return pqueries.QueryEngine(psvc), jqueries.QueryEngine(jsvc), names


def test_ingress_answers_and_sheds_alike(engines, monkeypatch):
    install_clock(monkeypatch)
    pq, jq, names = engines
    rng = np.random.default_rng(2)
    requests = [[(names[a], names[b]) for a, b in rng.integers(0, 30, (k + 1, 2))]
                for k in range(6)]
    out = {}
    for pkg, q in (("port", pq), ("jax", jq)):
        adm, ing_mod, _, _, errors = _PKGS[pkg]
        clock = FakeClock()
        ctl = adm.AdmissionController([adm.TenantQuota("t", rate=1.0, burst=12.0)],
                                      clock=clock)
        rec = []
        with ing_mod.Ingress(q, admission=ctl,
                             config=ing_mod.IngressConfig(batch_size=4, max_wait_s=0.001)) as ing:
            for ps in requests:
                try:
                    rec.append(ing.submit(ps, tenant="t"))
                except errors.AdmissionRejectedError as e:
                    rec.append((e.reason, e.tenant, round(e.retry_after_s, 9)))
            with pytest.raises(errors.ConfigError):
                ing_mod.Ingress(object())
            rec.append(ing.answered)
        out[pkg] = rec
    assert out["port"] == out["jax"]
    assert ("over-quota", "t", 3.0) in out["port"]


def test_http_query_through_the_port_ingress_is_typed(engines, tmp_path):
    pq, _, names = engines
    clock = FakeClock()
    ctl = padm.AdmissionController([padm.TenantQuota("t", rate=1.0, burst=2.0)], clock=clock)
    log = str(tmp_path / "events.jsonl")
    open(log, "w").close()
    with ping.Ingress(pq, admission=ctl) as ing, \
            ReplicationServer(str(tmp_path), log, port=0, ingress=ing) as server:
        probes = [[names[0], names[1]], [names[2], names[3]]]
        conn = http.client.HTTPConnection(server.host, server.port, timeout=5.0)
        try:
            body = json.dumps({"probes": probes, "tenant": "t"})
            conn.request("POST", "/v1/query", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            doc = json.loads(resp.read())
            assert resp.status == 200
            assert doc["answers"] == [bool(v) for v in pq.can_reach_batch(
                [tuple(p) for p in probes])]
            conn.request("POST", "/v1/query", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            doc = json.loads(resp.read())
            assert resp.status == 429 and doc["reason"] == "over-quota"
            assert float(resp.getheader("Retry-After")) == pytest.approx(2.0)
        finally:
            conn.close()
        assert server.health()["ingress"]["answered"] == 1
