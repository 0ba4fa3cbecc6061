"""Coarse quantizer: k-means, list assignment and probing
(PyTorch counterpart of ``repro/core/quantizer.py``).

Ties follow the reference exactly: ``assign`` takes the first minimum
(``torch.argmin`` documents first-occurrence), and ``probe`` uses a
*stable* descending sort so the lowest list index wins among equal scores,
as ``lax.top_k`` does (``torch.topk`` leaves the tie order unspecified).
"""
from __future__ import annotations

import torch

from repro_torch.utils import l2_sq


def _initial_rows(n: int, n_lists: int, generator, device) -> torch.Tensor:
    """``n_lists`` row indices drawn with ``generator`` (without
    replacement when ``n >= n_lists``), on ``device``."""
    gdev = generator.device if generator is not None else "cpu"
    if n < n_lists:
        idx = torch.randint(n, (n_lists,), generator=generator, device=gdev)
    else:
        idx = torch.randperm(n, generator=generator, device=gdev)[:n_lists]
    return idx.to(device)


def train_kmeans(xs: torch.Tensor, n_lists: int, iters: int = 10,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Lloyd's k-means on ``xs`` [N, D] (on its device) -> [n_lists, D].

    A batch ``xs`` [B, N, D] trains B independent problems at once (the PQ
    subspaces, ``core/pq.py``) -> [B, n_lists, D]; problem ``b`` starts
    from the ``b``-th draw of initial rows.

    The initial centroids are ``n_lists`` rows drawn with ``generator``
    (without replacement when ``N >= n_lists``). Cluster sums use
    ``index_add_``, whose float atomics on the card may order additions
    differently from run to run; the reference's one-hot matrix product
    would need an ``[N, n_lists]`` temporary instead.
    """
    if xs.dim() == 2:
        return train_kmeans(xs.unsqueeze(0), n_lists, iters, generator)[0]
    b, n, d = xs.shape
    dev = xs.device
    idx = torch.stack([_initial_rows(n, n_lists, generator, dev)
                       for _ in range(b)])                       # [B, L]
    cents = torch.gather(xs, 1, idx.unsqueeze(-1).expand(b, n_lists, d))
    # problem p's cluster j is row p * n_lists + j of the flat sums
    offs = (torch.arange(b, device=dev) * n_lists).unsqueeze(1)  # [B, 1]
    ones = torch.ones((b * n, 1), dtype=xs.dtype, device=dev)
    flat_x = xs.reshape(b * n, d)
    for _ in range(iters):
        a = torch.argmin(l2_sq(xs, cents), dim=-1)               # [B, N]
        rows = (a + offs).reshape(-1)
        sums = torch.zeros((b * n_lists, d), dtype=xs.dtype,
                           device=dev).index_add_(0, rows, flat_x)
        counts = torch.zeros((b * n_lists, 1), dtype=xs.dtype,
                             device=dev).index_add_(0, rows, ones)
        new = sums / counts.clamp(min=1)
        cents = torch.where(counts > 0, new,
                            cents.reshape(b * n_lists, d)
                            ).reshape(b, n_lists, d)
    return cents


def assign(centroids: torch.Tensor, xs: torch.Tensor, metric: str = "l2"
           ) -> torch.Tensor:
    """Route vectors to their IVF list. xs [B, D] -> [B] int32."""
    if metric == "ip":
        return torch.argmax(xs @ centroids.T, dim=1).to(torch.int32)
    return torch.argmin(l2_sq(xs, centroids), dim=1).to(torch.int32)


def probe(centroids: torch.Tensor, qs: torch.Tensor, nprobe: int,
          metric: str = "l2") -> torch.Tensor:
    """Top-nprobe coarse lists per query. qs [Q, D] -> [Q, nprobe] int32."""
    if metric == "ip":
        scores = qs @ centroids.T
    else:
        scores = -l2_sq(qs, centroids)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return order[:, :nprobe].to(torch.int32)
