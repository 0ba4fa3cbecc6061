"""Pure-python reference model of SIVF semantics (the port's own copy of
``repro/core/reference.py``, numpy only).

Used as the oracle for unit and hypothesis property tests: a dict of live
vectors plus the same coarse assignment rule. Any observable behaviour of
the index (search results, live counts, overwrite semantics) must match
this model exactly (up to distance ties).
"""
from __future__ import annotations

import numpy as np


class ReferenceIndex:
    def __init__(self, centroids: np.ndarray, metric: str = "l2"):
        self.centroids = np.asarray(centroids, np.float32)
        self.metric = metric
        self.store: dict[int, np.ndarray] = {}

    # -- routing (must match quantizer.assign / probe tie-breaking) --------
    def _dists(self, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
        if self.metric == "ip":
            return -(xs @ ys.T)
        aa = np.sum(xs * xs, axis=-1, keepdims=True)
        bb = np.sum(ys * ys, axis=-1, keepdims=True).T
        return aa - 2.0 * (xs @ ys.T) + bb

    def assign(self, xs: np.ndarray) -> np.ndarray:
        return np.argmin(self._dists(np.asarray(xs, np.float32),
                                     self.centroids), axis=1)

    def probe(self, qs: np.ndarray, nprobe: int) -> np.ndarray:
        d = self._dists(np.asarray(qs, np.float32), self.centroids)
        return np.argsort(d, axis=1, kind="stable")[:, :nprobe]

    # -- mutation -----------------------------------------------------------
    def insert(self, vecs: np.ndarray, ids) -> None:
        for v, i in zip(np.asarray(vecs, np.float32), ids):
            i = int(i)
            if i < 0:
                continue
            self.store[i] = v.copy()     # delete-then-insert == overwrite

    def delete(self, ids) -> None:
        for i in ids:
            self.store.pop(int(i), None)  # idempotent

    @property
    def n_live(self) -> int:
        return len(self.store)

    # -- search -------------------------------------------------------------
    def search(self, qs: np.ndarray, k: int, nprobe: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """Brute force over live vectors restricted to probed lists."""
        qs = np.asarray(qs, np.float32)
        nq = qs.shape[0]
        out_d = np.full((nq, k), np.inf, np.float32)
        out_l = np.full((nq, k), -1, np.int64)
        if not self.store:
            return out_d, out_l
        ids = np.fromiter(self.store.keys(), np.int64)
        vecs = np.stack([self.store[int(i)] for i in ids])
        lists = self.assign(vecs)
        probes = self.probe(qs, nprobe)
        d_all = self._dists(qs, vecs)                       # [Q, N]
        for q in range(nq):
            mask = np.isin(lists, probes[q])
            if not mask.any():
                continue
            cand = np.nonzero(mask)[0]
            dq = d_all[q, cand]
            order = np.argsort(dq, kind="stable")[:k]
            out_d[q, :len(order)] = dq[order]
            out_l[q, :len(order)] = ids[cand[order]]
        return out_d, out_l
