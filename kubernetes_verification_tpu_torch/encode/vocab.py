"""Label vocabulary interning.

Labels are ragged string dicts; the device kernels need dense axes. The vocab
interns every (key, value) pair and every key seen on any pod or namespace to
integer ids — the tensorised analogue of the reference's dynamic per-key Z3
relations and 32-bit value literals (``kubesv/kubesv/constraint.py:36-38,51-55``
and ``:242-275``). Pods and namespaces share one vocabulary (the reference
instead disambiguates namespace keys with a ``__namespace`` suffix,
``kubesv/kubesv/constraint.py:266``; sharing is harmless here because entity
kind is carried by which tensor a row lives in).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

__all__ = ["Vocab"]


@dataclass
class Vocab:
    pair_ids: Dict[Tuple[str, str], int] = field(default_factory=dict)
    key_ids: Dict[str, int] = field(default_factory=dict)

    @property
    def n_pairs(self) -> int:
        return len(self.pair_ids)

    @property
    def n_keys(self) -> int:
        return len(self.key_ids)

    def intern(self, labels: Mapping[str, str]) -> None:
        for k, v in labels.items():
            if k not in self.key_ids:
                self.key_ids[k] = len(self.key_ids)
            if (k, v) not in self.pair_ids:
                self.pair_ids[(k, v)] = len(self.pair_ids)

    @classmethod
    def build(cls, label_dicts: Iterable[Mapping[str, str]]) -> "Vocab":
        v = cls()
        for d in label_dicts:
            v.intern(d)
        return v

    def pair(self, key: str, value: str) -> Optional[int]:
        return self.pair_ids.get((key, value))

    def key(self, key: str) -> Optional[int]:
        return self.key_ids.get(key)

    def encode_labels(self, labels: Mapping[str, str]) -> Tuple[np.ndarray, np.ndarray]:
        """(bool[V] pair one-hots, bool[K] key one-hots) for one entity."""
        kv = np.zeros(self.n_pairs, dtype=bool)
        key = np.zeros(self.n_keys, dtype=bool)
        for k, v in labels.items():
            kv[self.pair_ids[(k, v)]] = True
            key[self.key_ids[k]] = True
        return kv, key

    def encode_label_matrix(
        self, label_dicts: Iterable[Mapping[str, str]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Stack ``encode_labels`` over entities → bool[N, V], bool[N, K]."""
        dicts = list(label_dicts)
        kv = np.zeros((len(dicts), self.n_pairs), dtype=bool)
        key = np.zeros((len(dicts), self.n_keys), dtype=bool)
        for i, d in enumerate(dicts):
            for k, v in d.items():
                kv[i, self.pair_ids[(k, v)]] = True
                key[i, self.key_ids[k]] = True
        return kv, key
