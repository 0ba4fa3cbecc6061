"""HNSW-lite graph baseline (paper Table 4, HNSW/NSG rows), the port's own
copy of ``repro/baselines/hnsw_lite.py``.

A compact single-layer NSW graph (numpy; graph indices are host structures
in Faiss too), walked and pruned exactly as the reference does; the one
baseline with no device. Search results are CPU tensors with the
reference's dtypes (float32 distances, int64 labels); tensors given to it
are read on the host. It reproduces the streaming pathology the paper
measures: no native delete — eviction forces a full graph REBUILD over the
surviving vectors, which is why graph indices post 10^2-10^5 ms deletion
latencies in Table 4.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.baselines import ProtocolEngine
from repro_torch.core.api import SearchResult


def _host(x) -> np.ndarray:
    """``x`` (numpy, list or a tensor on any device) as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class HNSWLite(ProtocolEngine):
    def __init__(self, dim: int, m: int = 8, ef: int = 32,
                 metric: str = "l2"):
        self.dim, self.m, self.ef, self.metric = dim, m, ef, metric
        self.vecs: dict[int, np.ndarray] = {}
        self.links: dict[int, list[int]] = {}
        self.entry: int | None = None

    def _d(self, a: np.ndarray, b: np.ndarray) -> float:
        if self.metric == "ip":
            return -float(a @ b)
        diff = a - b
        return float(diff @ diff)

    def _greedy(self, q: np.ndarray, ef: int) -> list[tuple[float, int]]:
        if self.entry is None:
            return []
        visited = {self.entry}
        d0 = self._d(q, self.vecs[self.entry])
        cand = [(d0, self.entry)]
        best = [(-d0, self.entry)]
        while cand:
            d, u = heapq.heappop(cand)
            if d > -best[0][0] and len(best) >= ef:
                break
            for v in self.links[u]:
                if v in visited:
                    continue
                visited.add(v)
                dv = self._d(q, self.vecs[v])
                if len(best) < ef or dv < -best[0][0]:
                    heapq.heappush(cand, (dv, v))
                    heapq.heappush(best, (-dv, v))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted((-nd, u) for nd, u in best)

    def _insert_one(self, i: int, v: np.ndarray) -> None:
        self.vecs[i] = v
        near = self._greedy(v, self.ef)[: self.m]
        self.links[i] = [u for _, u in near]
        for _, u in near:
            self.links[u].append(i)
            if len(self.links[u]) > 2 * self.m:   # prune to closest
                self.links[u].sort(
                    key=lambda w: self._d(self.vecs[u], self.vecs[w]))
                self.links[u] = self.links[u][: 2 * self.m]
        if self.entry is None:
            self.entry = i

    def insert(self, vecs, ids) -> None:
        for v, i in zip(_host(vecs).astype(np.float32), _host(ids)):
            self._insert_one(int(i), v)

    def delete(self, ids) -> None:
        """Full rebuild over survivors (graph topology must be repaired)."""
        drop = set(int(i) for i in _host(ids).reshape(-1))
        survivors = [(i, v) for i, v in self.vecs.items() if i not in drop]
        self.vecs, self.links, self.entry = {}, {}, None
        for i, v in survivors:
            self._insert_one(i, v)

    def search(self, qs, k, nprobe=None):
        """Graph search; ``nprobe`` accepted for IndexProtocol, unused."""
        qs = _host(qs).astype(np.float32)
        out_d = np.full((len(qs), k), np.inf, np.float32)
        out_l = np.full((len(qs), k), -1, np.int64)
        for qi, q in enumerate(qs):
            res = self._greedy(q, max(self.ef, k))[:k]
            for j, (d, u) in enumerate(res):
                out_d[qi, j] = d
                out_l[qi, j] = u
        return SearchResult(distances=torch.from_numpy(out_d),
                            labels=torch.from_numpy(out_l), k=k, nprobe=0,
                            padded_to=len(qs))

    @property
    def n_live(self) -> int:
        return len(self.vecs)
