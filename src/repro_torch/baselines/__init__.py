"""Comparison baselines from the paper's evaluation (§5), for PyTorch.

The port of ``repro/baselines``, engine for engine:

  * ``FlatIndex``       — GPU Flat analogue: brute force, O(N) compaction
                          on delete (paper Table 4).
  * ``ContiguousIVF``   — the primary baseline (Faiss GPU IVFFlat
                          analogue): contiguous per-list buffers with 2x
                          growth and full re-layout on overflow.
  * ``LSHIndex``        — hash-bucket baseline (paper Table 4).
  * ``HNSWLite``        — small graph baseline on the host; deletion
                          requires a rebuild.

Every baseline implements :class:`repro_torch.core.api.IndexProtocol`
(``add`` / ``remove`` / ``search`` / ``stats`` / ``n_live``) through
:class:`ProtocolEngine`, as the reference's do, so SIVF and the baselines
are driven through one interface. Flat, ContiguousIVF and LSH keep their
planes on one device (``device="cuda"`` by default) and take each
search's k smallest through the port's top-k (``kernels.topk.ops.topk``:
the hand-written kernel on the card, its plain version on the CPU), in
query chunks sized from shapes alone (:func:`query_chunks`).

The reference's quirks are kept, since they are its semantics:

  1. ``ContiguousIVF`` ranks a ``-1`` id inside its list without storing
     or counting it, so a later row of the same batch lands beyond the
     list's count, unseen by searches and overwritten by the next insert;
  2. ``FlatIndex`` appends ``-1`` rows and counts them live;
  3. a search that picks a ``+inf`` entry returns the id stored there,
     not ``-1``;
  4. ``ContiguousIVF.insert`` undoes an overflowing batch with
     ``delete(ids)``, which also deletes earlier copies of those ids.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import report_from_counts

CHUNK_BYTES = 1 << 30     # bytes of a search's gathered operands per chunk


def query_chunks(n_queries: int, bytes_per_query: int) -> list[slice]:
    """Query slices whose gathered operands (``bytes_per_query`` each) fit
    :data:`CHUNK_BYTES`, at least one query a chunk. Rows of a search are
    independent, so a chunked search gives the unchunked result exactly.
    An empty batch is one empty chunk."""
    step = max(1, CHUNK_BYTES // max(int(bytes_per_query), 1))
    return [slice(lo, min(lo + step, n_queries))
            for lo in range(0, n_queries, step)] or [slice(0, 0)]


def _requested(ids) -> tuple[int, int]:
    """(non-negative ids, batch length) of an id batch (numpy or torch)."""
    if isinstance(ids, torch.Tensor):
        ids = ids.reshape(-1)
        return int((ids >= 0).sum()), ids.numel()
    ids = np.asarray(ids).reshape(-1)
    return int((ids >= 0).sum()), len(ids)


class ProtocolEngine:
    """Mixin mapping ``insert``/``delete`` engines onto ``IndexProtocol``.

    Reports are measured from live-count deltas: rows the engine silently
    dropped (bucket/list overflow) surface as ``rejected``. Baselines do
    not track overwrite semantics, so ``overwritten`` is always 0.
    """

    def add(self, vecs, ids):
        requested, n = _requested(ids)
        n0 = self.n_live
        self.insert(vecs, ids)
        n1 = self.n_live
        return report_from_counts("add", requested, n1 - n0, 0, n1, n)

    def remove(self, ids):
        requested, n = _requested(ids)
        n0 = self.n_live
        self.delete(ids)
        n1 = self.n_live
        return report_from_counts("remove", requested, n0 - n1, 0, n1, n)

    def stats(self) -> dict:
        return {"engine": type(self).__name__, "n_live": self.n_live}


def as_device(x, dtype, device) -> torch.Tensor:
    """``x`` (numpy, list or tensor) as a ``dtype`` tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def rank_in_run(keys: torch.Tensor) -> torch.Tensor:
    """Position of each entry of the sorted ``keys`` inside its run of
    equal keys (``arange - searchsorted(keys, keys, "left")``)."""
    start = torch.searchsorted(keys, keys, side="left")
    return torch.arange(keys.numel(), device=keys.device) - start


def scatter_kept(n_rows: int, tgt: torch.Tensor, src: torch.Tensor,
                 fill) -> torch.Tensor:
    """A fresh ``[n_rows, ...]`` tensor filled with ``fill`` with
    ``src[i]`` written at row ``tgt[i]``; a ``tgt`` of ``n_rows`` drops
    the row (the reference's ``.at[tgt].set(mode="drop")``)."""
    out = torch.full((n_rows + 1,) + tuple(src.shape[1:]), fill,
                     dtype=src.dtype, device=src.device)
    out[tgt] = src
    return out[:n_rows]


def squared_l2(qs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``qs [Q, D]``, ``xs [Q, ..., D]`` gathered per query -> ``[Q, ...]``
    as the reference computes it: ``|q|^2 - 2 q.x + |x|^2``."""
    flat = xs.reshape(xs.shape[0], -1, xs.shape[-1])            # [Q, M, D]
    qq = torch.sum(qs * qs, -1)[:, None]
    qx = torch.bmm(flat, qs[:, :, None])[..., 0]                # [Q, M]
    return (qq - 2.0 * qx + torch.sum(flat * flat, -1)).reshape(xs.shape[:-1])


def neg_dot(qs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``-q.x`` of ``qs [Q, D]`` and gathered ``xs [Q, ..., D]``."""
    flat = xs.reshape(xs.shape[0], -1, xs.shape[-1])
    return -torch.bmm(flat, qs[:, :, None])[..., 0].reshape(xs.shape[:-1])


from repro_torch.baselines.flat import FlatIndex  # noqa: F401,E402
from repro_torch.baselines.contiguous_ivf import ContiguousIVF  # noqa: F401,E402
from repro_torch.baselines.lsh import LSHIndex  # noqa: F401,E402
from repro_torch.baselines.hnsw_lite import HNSWLite  # noqa: F401,E402
