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


def _cluster_sums(xs: torch.Tensor, a: torch.Tensor, n_lists: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums ``[B, L, D]`` and counts ``[B, L, 1]`` of ``xs``
    [B, N, D] under assignments ``a`` [B, N]: the rows stably sorted by
    (problem, cluster), then each cluster's rows added one after another
    in row order (``torch.segment_reduce``: a sequential sum for each
    cluster and column, no atomics); counts by ``bincount``, exact."""
    b, n, d = xs.shape
    keys = (a + n_lists * torch.arange(b, device=a.device).unsqueeze(1)
            ).reshape(-1)                                        # [B*N]
    order = torch.sort(keys, stable=True).indices
    counts = torch.bincount(keys, minlength=b * n_lists)
    sums = torch.segment_reduce(xs.reshape(b * n, d)[order], "sum",
                                lengths=counts, unsafe=True)
    return (sums.reshape(b, n_lists, d),
            counts.to(xs.dtype).reshape(b, n_lists, 1))


def train_kmeans(xs: torch.Tensor, n_lists: int, iters: int = 10,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Lloyd's k-means on ``xs`` [N, D] (on its device) -> [n_lists, D].

    A batch ``xs`` [B, N, D] trains B independent problems at once (the PQ
    subspaces, ``core/pq.py``) -> [B, n_lists, D]; problem ``b`` starts
    from the ``b``-th draw of initial rows.

    The initial centroids are ``n_lists`` rows drawn with ``generator``
    (without replacement when ``N >= n_lists``). Each cluster's sum adds
    its rows in row order (:func:`_cluster_sums`), the value the
    reference's one-hot product ``onehot.T @ x`` stands for, so a run on
    the card repeats itself bit for bit; the counts are exact.
    """
    if xs.dim() == 2:
        return train_kmeans(xs.unsqueeze(0), n_lists, iters, generator)[0]
    b, n, d = xs.shape
    dev = xs.device
    idx = torch.stack([_initial_rows(n, n_lists, generator, dev)
                       for _ in range(b)])                       # [B, L]
    cents = torch.gather(xs, 1, idx.unsqueeze(-1).expand(b, n_lists, d))
    for _ in range(iters):
        a = torch.argmin(l2_sq(xs, cents), dim=-1)               # [B, N]
        sums, counts = _cluster_sums(xs, a, n_lists)
        new = sums / counts.clamp(min=1)
        cents = torch.where(counts > 0, new, cents)
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
