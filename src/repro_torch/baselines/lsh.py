"""LSH baseline (paper Table 4): sign-random-projection hash tables, for
PyTorch.

L tables x 2^bits buckets with fixed bucket capacity; insert appends to the
matching bucket in every table (rows past a full bucket are dropped);
delete tombstones by id (the legacy-LSH behaviour the paper contrasts with:
cheap deletes, weak recall). Counterpart of ``repro/baselines/lsh.py``;
the planes are drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch

from repro_torch.baselines import (
    ProtocolEngine,
    as_device,
    neg_dot,
    query_chunks,
    rank_in_run,
    squared_l2,
)
from repro_torch.core.api import SearchResult
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.utils import resolve_device


def codes_of(planes: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """planes [L, bits, D]; vecs [B, D] -> bucket ids [B, L] (int64): bit
    ``b`` of table ``l`` is set where ``planes[l, b] . v > 0``."""
    s = torch.einsum("lbd,nd->nlb", planes, vecs) > 0
    w = 2 ** torch.arange(planes.shape[1], device=planes.device)
    return torch.sum(s.long() * w, -1)


class LSHIndex(ProtocolEngine):
    def __init__(self, gen: torch.Generator, dim: int, n_tables: int = 4,
                 bits: int = 8, bucket_cap: int = 64, metric: str = "l2",
                 device="cuda"):
        self.device = resolve_device(device)
        self.metric = metric
        self.planes = torch.randn((n_tables, bits, dim), generator=gen,
                                  device=gen.device).to(self.device)
        nb = 2 ** bits
        self.bucket_vecs = torch.zeros((n_tables, nb, bucket_cap, dim),
                                       dtype=torch.float32,
                                       device=self.device)
        self.bucket_ids = torch.full((n_tables, nb, bucket_cap), -1,
                                     dtype=torch.int32, device=self.device)
        self.cursors = torch.zeros((n_tables, nb), dtype=torch.int32,
                                   device=self.device)

    def insert(self, vecs, ids) -> None:
        """Each table: rows stably sorted by bucket, ranked within it, and
        written where the id is not ``-1`` and the rank fits."""
        vecs = as_device(vecs, torch.float32, self.device)
        ids = as_device(ids, torch.int32, self.device).reshape(-1)
        nl, nb, cap, _ = self.bucket_vecs.shape
        codes = codes_of(self.planes, vecs)                     # [B, L]
        for li in range(nl):                                    # L is small
            order = torch.sort(codes[:, li], stable=True).indices
            cs = codes[order, li]
            pos = self.cursors[li, cs].long() + rank_in_run(cs)
            keep = torch.nonzero((ids[order] >= 0) & (pos < cap)).flatten()
            b, p, rows = cs[keep], pos[keep], order[keep]
            self.bucket_vecs[li, b, p] = vecs[rows]
            self.bucket_ids[li, b, p] = ids[rows]
            self.cursors[li] += torch.bincount(b, minlength=nb).to(
                torch.int32)

    def delete(self, ids) -> None:
        del_ids = as_device(ids, torch.int32, self.device).reshape(-1)
        self.bucket_ids.masked_fill_(torch.isin(self.bucket_ids, del_ids),
                                     -1)

    def query_bytes(self, nprobe=None) -> int:
        """Bytes a search gathers per query: its bucket in every table
        (rows and their squares, ids, distances, the dedupe's sort);
        ``nprobe`` unused."""
        nl, _, cap, d = self.bucket_vecs.shape
        return nl * cap * (8 * d + 32)

    def search(self, qs, k: int, nprobe=None) -> SearchResult:
        """Hash-bucket search; ``nprobe`` accepted for IndexProtocol,
        unused. Candidates of several tables are deduplicated by id (the
        first occurrence kept, by a stable sort on id) before the k
        smallest are taken."""
        qs = as_device(qs, torch.float32, self.device)
        nl = self.bucket_vecs.shape[0]
        codes = codes_of(self.planes, qs)                        # [Q, L]
        tables = torch.arange(nl, device=self.device)[None, :]
        out_d, out_l = [], []
        for sl in query_chunks(qs.shape[0], self.query_bytes()):
            q, c = qs[sl], codes[sl]
            xs = self.bucket_vecs[tables, c]                 # [q, L, cap, D]
            xi = self.bucket_ids[tables, c].reshape(q.shape[0], -1)
            dist = neg_dot(q, xs) if self.metric == "ip" else \
                squared_l2(q, xs)
            dist = torch.where(xi >= 0, dist.reshape(q.shape[0], -1),
                               float("inf"))
            xis, order = torch.sort(xi, dim=1, stable=True)
            ds = torch.gather(dist, 1, order)
            dup = torch.zeros_like(xis, dtype=torch.bool)
            dup[:, 1:] = xis[:, 1:] == xis[:, :-1]
            dk, lk = topk_ops.topk(ds.masked_fill_(dup, float("inf")),
                                   xis, k)
            out_d.append(dk)
            out_l.append(lk)
        return SearchResult(distances=torch.cat(out_d),
                            labels=torch.cat(out_l), k=k, nprobe=0,
                            padded_to=qs.shape[0])

    @property
    def n_live(self) -> int:
        """Live entries in table 0 (approximate under bucket overflow)."""
        return int((self.bucket_ids[0] >= 0).sum())
