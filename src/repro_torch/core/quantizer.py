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


def train_kmeans(xs: torch.Tensor, n_lists: int, iters: int = 10,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Lloyd's k-means on ``xs`` [N, D] (on its device) -> [n_lists, D].

    The initial centroids are ``n_lists`` rows drawn with ``generator``
    (without replacement when ``N >= n_lists``). Cluster sums use
    ``index_add_``, whose float atomics on the card may order additions
    differently from run to run; the reference's one-hot matrix product
    would need an ``[N, n_lists]`` temporary instead.
    """
    n = xs.shape[0]
    dev = xs.device
    gdev = generator.device if generator is not None else "cpu"
    if n < n_lists:
        idx = torch.randint(n, (n_lists,), generator=generator, device=gdev)
    else:
        idx = torch.randperm(n, generator=generator, device=gdev)[:n_lists]
    cents = xs[idx.to(dev)].clone()
    ones = torch.ones((n, 1), dtype=xs.dtype, device=dev)
    for _ in range(iters):
        a = torch.argmin(l2_sq(xs, cents), dim=1)                  # [N]
        sums = torch.zeros_like(cents).index_add_(0, a, xs)        # [L, D]
        counts = torch.zeros((n_lists, 1), dtype=xs.dtype,
                             device=dev).index_add_(0, a, ones)    # [L, 1]
        cents = torch.where(counts > 0, sums / counts.clamp(min=1), cents)
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
