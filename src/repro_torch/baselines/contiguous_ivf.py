"""Contiguous-layout IVF — the paper's primary baseline (Faiss GPU IVFFlat),
for PyTorch.

Inverted lists are stored in per-list contiguous buffers [n_lists, cap, D].
This reproduces the two pathologies the paper measures:

  * **Insert** — when any list outgrows its capacity the whole structure is
    re-laid-out with 2x capacity growth ("dynamic arrays reserve up to 2x
    capacity to amortize resizing", paper §3.5.3) — the analogue of the
    cudaMalloc/copy churn in Table 3.
  * **Delete** — contiguous layouts require O(N) data shifting (paper
    Fig. 1a): every list is compacted with a stable partition, i.e. the
    memmove the Faiss CPU fallback performs after the PCIe round trip.
    Here it runs on the device, with no round trip.

Search scans the probed lists from the padded dense layout: the gathered
``[Q, P, cap, D]`` rows (in query chunks), then the k smallest of each
``[P * cap]`` row through the port's top-k. Counterpart of
``repro/baselines/contiguous_ivf.py``, quirks 1 and 4 of
``repro_torch.baselines`` included.
"""
from __future__ import annotations

import torch

from repro_torch.baselines import (
    ProtocolEngine,
    as_device,
    neg_dot,
    query_chunks,
    rank_in_run,
    scatter_kept,
    squared_l2,
)
from repro_torch.core import quantizer
from repro_torch.core.api import SearchResult
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.utils import resolve_device


class ContiguousIVF(ProtocolEngine):
    def __init__(self, centroids, list_cap: int = 64, metric: str = "l2",
                 device="cuda"):
        self.device = resolve_device(device)
        self.centroids = as_device(centroids, torch.float32, self.device)
        self.metric = metric
        nl, d = self.centroids.shape
        self.buf = torch.zeros((nl, list_cap, d), dtype=torch.float32,
                               device=self.device)
        self.ids = torch.full((nl, list_cap), -1, dtype=torch.int32,
                              device=self.device)
        self.counts = torch.zeros((nl,), dtype=torch.int32,
                                  device=self.device)
        self.n_relayouts = 0

    def _scatter_insert(self, vecs, ids, lists) -> bool:
        """Append within per-list capacity, in place; True on overflow.

        The rows are stably sorted by list and ranked within it; a row is
        written where its id is not ``-1`` and its slot is inside the
        capacity (a ``-1`` still takes its rank: quirk 1). Reads the
        overflow flag on the host, as the reference does."""
        nl, cap, d = self.buf.shape
        order = torch.sort(lists, stable=True).indices
        sl = lists[order].long()
        sid = ids[order]
        pos = self.counts[sl].long() + rank_in_run(sl)
        ok = (sid >= 0) & (pos < cap)
        overflow = bool(torch.any((sid >= 0) & (pos >= cap)))
        keep = torch.nonzero(ok).flatten()
        slot = sl[keep] * cap + pos[keep]
        self.buf.view(-1, d)[slot] = vecs[order[keep]]
        self.ids.view(-1)[slot] = sid[keep]
        self.counts += torch.bincount(sl[keep], minlength=nl).to(torch.int32)
        return overflow

    def _compact_lists(self, del_ids: torch.Tensor) -> None:
        """O(N) per-list stable compaction (the memmove)."""
        nl, cap, d = self.buf.shape
        slot = torch.arange(cap, device=self.device)[None, :]
        live = (slot < self.counts[:, None]) & ~torch.isin(self.ids, del_ids)
        row = torch.arange(nl, device=self.device)[:, None] * cap
        tgt = torch.where(live, row + torch.cumsum(live, 1) - 1,
                          nl * cap).reshape(-1)
        self.buf = scatter_kept(nl * cap, tgt, self.buf.view(-1, d),
                                0.0).view(nl, cap, d)
        self.ids = scatter_kept(nl * cap, tgt, self.ids.view(-1),
                                -1).view(nl, cap)
        self.counts = live.sum(1, dtype=torch.int32)

    def _grow(self) -> None:
        """2x capacity re-layout: allocate + full copy (the paper's resizing
        overhead; counted so benchmarks can report it)."""
        nl, cap, d = self.buf.shape
        buf = torch.zeros((nl, cap * 2, d), dtype=torch.float32,
                          device=self.device)
        buf[:, :cap] = self.buf
        ids = torch.full((nl, cap * 2), -1, dtype=torch.int32,
                         device=self.device)
        ids[:, :cap] = self.ids
        self.buf, self.ids = buf, ids
        self.n_relayouts += 1

    def insert(self, vecs, ids) -> None:
        vecs = as_device(vecs, torch.float32, self.device)
        ids = as_device(ids, torch.int32, self.device).reshape(-1)
        lists = quantizer.assign(self.centroids, vecs, self.metric)
        while self._scatter_insert(vecs, ids, lists):
            self.delete(ids)            # undo the partial insert (quirk 4)
            self._grow()

    def delete(self, ids) -> None:
        self._compact_lists(as_device(ids, torch.int32,
                                      self.device).reshape(-1))

    def query_bytes(self, nprobe=None) -> int:
        """Bytes a search gathers per query: ``nprobe`` lists (every list
        where ``None``) of rows and their squares, ids and distances."""
        nl, cap, d = self.buf.shape
        nprobe = nl if nprobe is None else min(int(nprobe), nl)
        return nprobe * cap * (8 * d + 12)

    def search(self, qs, k: int, nprobe=None) -> SearchResult:
        """IVF search; ``nprobe=None`` probes every list."""
        nl, cap, _ = self.buf.shape
        nprobe = nl if nprobe is None else min(int(nprobe), nl)
        qs = as_device(qs, torch.float32, self.device)
        probes = quantizer.probe(self.centroids, qs, nprobe, self.metric)
        slot = torch.arange(cap, device=self.device)
        out_d, out_l = [], []
        for sl in query_chunks(qs.shape[0], self.query_bytes(nprobe)):
            q, p = qs[sl], probes[sl].long()
            x, xi = self.buf[p], self.ids[p]     # [q, P, cap, D], [q, P, cap]
            d = neg_dot(q, x) if self.metric == "ip" else squared_l2(q, x)
            ok = (slot < self.counts[p][..., None]) & (xi >= 0)
            d = torch.where(ok, d, float("inf"))
            dk, lk = topk_ops.topk(d.reshape(q.shape[0], -1),
                                   xi.reshape(q.shape[0], -1), k)
            out_d.append(dk)
            out_l.append(lk)
        return SearchResult(distances=torch.cat(out_d),
                            labels=torch.cat(out_l), k=k, nprobe=nprobe,
                            padded_to=qs.shape[0])

    def stats(self) -> dict:
        return {"engine": type(self).__name__, "n_live": self.n_live,
                "list_cap": int(self.buf.shape[1]),
                "n_relayouts": self.n_relayouts}

    @property
    def n_live(self) -> int:
        return int(self.counts.sum())
