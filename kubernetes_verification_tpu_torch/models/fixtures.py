"""Reference scenarios used as correctness oracles in tests and benchmarks.

``kano_paper_example`` rebuilds the Kano HOTI'20 paper scenario
(``kano_py/sample/example.py:4-60``); ``kubesv_paper_example`` rebuilds the
Datalog verifier's 2-namespace × 12-pod scenario
(``kubesv/sample/example.py:110-175``) in our self-contained model (the
reference needed a live kube-config to even parse it,
``kubesv/kubesv/parser.py:10``). The port's own copy of
``kubernetes_verification_tpu.models.fixtures``.
"""
from __future__ import annotations

from itertools import product
from typing import List, Tuple

from .core import (
    Cluster,
    Container,
    Expr,
    KanoPolicy,
    Namespace,
    NetworkPolicy,
    Peer,
    Pod,
    PortSpec,
    Rule,
    Selector,
)

__all__ = [
    "kano_paper_example",
    "kano_paper_example_as_cluster",
    "kubesv_paper_example",
]


def kano_paper_example() -> Tuple[List[Container], List[KanoPolicy]]:
    """5 containers + 4 ingress policies: Nginx→DB, User→Tomcat, Tomcat→Nginx,
    Alice→Nginx. Ground truth (derived by hand from the reference semantics,
    asserted in ``kano_py/tests/test_basic.py:27-37``):

    * reach pairs include (A→B), (C→A), (E→C)
    * ``all_reachable == []``, ``all_isolated == [4]``
    * ``user_crosscheck(app) == [1, 2, 3]``
    * ``policy_shadow == [(2, 3), (3, 2)]``
    """
    containers = [
        Container("A", {"app": "Alice", "role": "Nginx"}),
        Container("B", {"app": "Alice", "role": "DB"}),
        Container("C", {"app": "Alice", "role": "Tomcat"}),
        Container("D", {"app": "Bob", "role": "Nginx"}),
        Container("E", {"app": "User", "role": "User"}),
    ]
    policies = [
        KanoPolicy("A", select={"role": "DB"}, allow={"role": "Nginx"},
                   ingress=True, protocols=("TCP", "3306")),
        KanoPolicy("B", select={"role": "Tomcat"}, allow={"role": "User"},
                   ingress=True, protocols=("TCP", "8080")),
        KanoPolicy("C", select={"role": "Nginx"}, allow={"role": "Tomcat"},
                   ingress=True, protocols=("TCP", "3306")),
        KanoPolicy("D", select={"role": "Nginx"}, allow={"app": "Alice"},
                   ingress=True, protocols=("TCP", "3306")),
    ]
    return containers, policies


def kano_paper_example_as_cluster() -> Cluster:
    """The same scenario expressed at the k8s level: one single-rule ingress
    NetworkPolicy per kano policy, all in one namespace. Under full k8s
    semantics the *unselected* pods (e.g. E) default to allow-all, so the two
    levels agree only on policy-granted edges — tests use this to pin down the
    semantic difference between the two modes."""
    containers, kano_pols = kano_paper_example()
    pods = [Pod(c.name, "default", dict(c.labels)) for c in containers]
    policies = [
        NetworkPolicy(
            name=p.name,
            namespace="default",
            pod_selector=Selector(match_labels=dict(p.select)),
            policy_types=("Ingress",),
            ingress=(Rule(peers=(Peer(pod_selector=Selector(match_labels=dict(p.allow))),)),),
        )
        for p in kano_pols
    ]
    return Cluster(pods=pods, namespaces=[Namespace("default")], policies=policies)


def kubesv_paper_example() -> Cluster:
    """2 namespaces × 12 pods (role × ns × env product) + 1 matchExpressions
    policy (``kubesv/sample/example.py:110-175``): the policy lives in
    ``default``, selects pods with role NotIn [tomcat, nginx] (i.e. db pods),
    allows ingress from tomcat pods of namespaces labelled nonsense=default on
    TCP/6379, and egress to role NotIn [db, nginx] pods in namespaces where
    key ``l`` does not exist, on TCP/5978."""
    namespaces = [
        Namespace("default", {"nonsense": "default"}),
        Namespace("minikube", {"nonsense": "emmm", "l": "minikube"}),
    ]
    pods = []
    for idx, (role, ns, env) in enumerate(
        product(["db", "nginx", "tomcat"], ["default", "minikube"], ["prod", "test"])
    ):
        pods.append(Pod(f"{role}_{idx}", ns, {"env": env, "role": role}))

    policy = NetworkPolicy(
        name="allow-default-nginx",
        namespace="default",
        pod_selector=Selector(
            match_expressions=(Expr("role", "NotIn", ("tomcat", "nginx")),)
        ),
        policy_types=("Ingress", "Egress"),
        ingress=(
            Rule(
                peers=(
                    Peer(
                        namespace_selector=Selector({"nonsense": "default"}),
                        pod_selector=Selector({"role": "tomcat"}),
                    ),
                ),
                ports=(PortSpec("TCP", 6379),),
            ),
        ),
        egress=(
            Rule(
                peers=(
                    Peer(
                        pod_selector=Selector(
                            match_expressions=(Expr("role", "NotIn", ("db", "nginx")),)
                        ),
                        namespace_selector=Selector(
                            match_expressions=(Expr("l", "DoesNotExist"),)
                        ),
                    ),
                ),
                ports=(PortSpec("TCP", 5978),),
            ),
        ),
    )
    return Cluster(pods=pods, namespaces=namespaces, policies=[policy])
