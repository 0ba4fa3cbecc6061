"""Flat (brute-force) baseline — the paper's "GPU Flat", for PyTorch.

Storage is one contiguous [cap, D] buffer. Insert appends at a cursor;
delete performs the O(N) physical compaction that contiguous layouts force
(paper Fig. 1a / Table 4): every live row is moved into a fresh dense
prefix. Search is an exact matmul, then the k smallest through the port's
top-k. Counterpart of ``repro/baselines/flat.py``; the cursor is kept on
the host (a Python int), since every append needs it there to place its
rows and the reference reads it back after every mutation anyway.
"""
from __future__ import annotations

import torch

from repro_torch.baselines import (
    ProtocolEngine,
    as_device,
    query_chunks,
    scatter_kept,
)
from repro_torch.core.api import SearchResult
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.utils import resolve_device


class FlatIndex(ProtocolEngine):
    def __init__(self, dim: int, capacity: int, metric: str = "l2",
                 device="cuda"):
        self.device = resolve_device(device)
        self.metric = metric
        self.buf = torch.zeros((capacity, dim), dtype=torch.float32,
                               device=self.device)
        self.ids = torch.full((capacity,), -1, dtype=torch.int32,
                              device=self.device)
        self.cursor = 0

    def insert(self, vecs, ids) -> None:
        """Append at the cursor; rows past the capacity are dropped, and
        ``-1`` ids are appended like any other (quirk 2)."""
        vecs = as_device(vecs, torch.float32, self.device)
        ids = as_device(ids, torch.int32, self.device).reshape(-1)
        m = max(min(vecs.shape[0], self.buf.shape[0] - self.cursor), 0)
        self.buf[self.cursor:self.cursor + m] = vecs[:m]
        self.ids[self.cursor:self.cursor + m] = ids[:m]
        self.cursor += m

    def delete(self, ids) -> None:
        """O(N) compaction: drop deleted rows, shift live rows down (a
        stable partition by a prefix sum, memmove semantics)."""
        n = self.buf.shape[0]
        del_ids = as_device(ids, torch.int32, self.device).reshape(-1)
        written = torch.arange(n, device=self.device) < self.cursor
        alive = ~torch.isin(self.ids, del_ids) & written
        tgt = torch.where(alive, torch.cumsum(alive, 0) - 1, n)
        self.buf = scatter_kept(n, tgt, self.buf, 0.0)
        self.ids = scatter_kept(n, tgt, self.ids, -1)
        self.cursor = int(alive.sum())

    def query_bytes(self, nprobe=None) -> int:
        """Bytes a search gathers per query: its distance row and its
        label row (``[cap]`` float32 and int32); ``nprobe`` unused."""
        return 8 * self.buf.shape[0]

    def search(self, qs, k: int, nprobe=None) -> SearchResult:
        """Exact search; ``nprobe`` accepted for IndexProtocol, unused."""
        qs = as_device(qs, torch.float32, self.device)
        n = self.buf.shape[0]
        live = (torch.arange(n, device=self.device) < self.cursor) & \
            (self.ids >= 0)
        bb = None if self.metric == "ip" else torch.sum(self.buf * self.buf,
                                                        -1)
        out_d, out_l = [], []
        for sl in query_chunks(qs.shape[0], self.query_bytes()):
            q = qs[sl]
            d = q @ self.buf.T                                  # [q, cap]
            if self.metric == "ip":
                d.neg_()
            else:   # |q|^2 - 2 q.x + |x|^2, in the reference's order
                d.mul_(-2.0).add_(torch.sum(q * q, -1, keepdim=True))
                d.add_(bb)
            d.masked_fill_(~live, float("inf"))
            lab = self.ids.expand(q.shape[0], n).contiguous()
            dk, lk = topk_ops.topk(d, lab, k)
            out_d.append(dk)
            out_l.append(lk)
        return SearchResult(distances=torch.cat(out_d),
                            labels=torch.cat(out_l), k=k, nprobe=0,
                            padded_to=qs.shape[0])

    @property
    def n_live(self) -> int:
        return self.cursor
