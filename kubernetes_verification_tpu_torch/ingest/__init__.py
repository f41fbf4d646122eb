"""Cluster ingestion: YAML → model objects, no cluster/kube-config required.

The reference needed a loadable ``~/.kube/config`` just to *parse* YAML
(``kubesv/kubesv/parser.py:10``); here ingestion is self-contained. The port's own copy of
``kubernetes_verification_tpu.ingest``: host-only, it needs PyYAML for YAML
manifests (JSON ones need nothing), and the package's ``__init__`` does not
import it.
"""
from .yaml_io import (
    IngestError,
    SkipDiagnostic,
    dump_cluster,
    load_cluster,
    load_kano,
    namespace_to_dict,
    network_policy_to_dict,
    parse_network_policy,
    parse_namespace,
    parse_pod,
    pod_to_dict,
)

__all__ = [
    "IngestError",
    "SkipDiagnostic",
    "dump_cluster",
    "load_cluster",
    "load_kano",
    "namespace_to_dict",
    "network_policy_to_dict",
    "parse_network_policy",
    "parse_namespace",
    "parse_pod",
    "pod_to_dict",
]
