"""``sivf_torch.Index`` — the streaming-session handle, single backend.

PyTorch counterpart of ``repro/core/api.py``:

    cfg = SIVFConfig(dim=128, n_lists=4096, n_slabs=16384)
    index = Index(cfg, centroids)                  # device="cuda" by default
    report = index.add(vecs, ids)                  # -> MutationReport
    result = index.search(queries, k=10, nprobe=32)
    report = index.remove(ids)

    with Index(cfg, centroids, deferred=True) as index:
        futs = [index.add(v, i) for v, i in stream]    # -> PendingReport
        reports = index.flush()                        # one copy, N reports

The handle owns a :class:`~repro_torch.core.state.SlabPoolState` on one
device, pads ragged batches to power-of-two buckets (as the reference
does, which keeps the shapes its kernels see few), turns the sticky
``state.error`` bits into per-batch :class:`MutationReport`s, and resolves
deferred reports in **one** device->host copy per queue.

What the reference's handle does and this slice does not: mesh backends,
PQ training, maintenance, persistence, resharding, tiered prefetch,
filters and telemetry raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them. The reference's ``impl`` / ``block_q`` (TPU kernel
and tiling choices) have no counterpart: the tensor's device picks the
scan path.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, Protocol, runtime_checkable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import index as ix
from repro_torch.core.state import (
    ERR_CHAIN_OVERFLOW,
    ERR_ID_RANGE,
    ERR_POOL_EXHAUSTED,
    ROADMAP_FILTER,
    ROADMAP_PQ,
    ROADMAP_TIERED,
    SIVFConfig,
    SlabPoolState,
    clear_error as _clear_error,
    init_state,
)
from repro_torch.utils import resolve_device

ROADMAP_MAINT = "ROADMAP.md queue 1 item 9 (core/maintenance.py)"
ROADMAP_PERSIST = "ROADMAP.md queue 1 item 7 (persistence)"
ROADMAP_DIST = "ROADMAP.md queue 1 item 10 (core/distributed.py)"


# ---------------------------------------------------------------------------
# Report types
# ---------------------------------------------------------------------------

class ErrorCode(enum.IntFlag):
    """Typed view of the core kernels' sticky ``state.error`` bits."""

    NONE = 0
    POOL_EXHAUSTED = ERR_POOL_EXHAUSTED
    ID_RANGE = ERR_ID_RANGE
    CHAIN_OVERFLOW = ERR_CHAIN_OVERFLOW


@dataclasses.dataclass(frozen=True)
class MutationReport:
    """Per-batch admission report for :meth:`Index.add` / :meth:`Index.remove`.

    ``accepted`` (new ids now live), ``overwritten`` (ids live before whose
    payload was replaced) and ``rejected`` (everything else: superseded
    in-batch duplicates, ids outside ``[0, n_max)``, every row of an
    aborted batch) are disjoint and sum to ``requested``. All counts are
    measured from device state, as in the reference.
    """

    op: str                 # "add" | "remove"
    requested: int          # non-padding rows in the caller's batch
    accepted: int
    overwritten: int
    rejected: int
    errors: ErrorCode       # this batch's error bits (already cleared)
    n_live: int             # total live vectors after the batch
    padded_to: int          # bucket shape the batch was padded to
    shard_errors: tuple[ErrorCode, ...] | None = None  # mesh only (None)

    @property
    def ok(self) -> bool:
        return self.errors == ErrorCode.NONE


class MutationRejected(RuntimeError):
    """Raised in strict mode when a batch reports any error bit (in
    deferred mode at :meth:`Index.flush`, after the whole queue resolved)."""

    def __init__(self, report: MutationReport):
        super().__init__(
            f"{report.op} batch rejected: errors={report.errors!r} "
            f"accepted={report.accepted} overwritten={report.overwritten} "
            f"rejected={report.rejected} of requested={report.requested}")
        self.report = report


class PendingReport:
    """Future for a deferred :class:`MutationReport`.

    ``result()`` — or reading any report attribute off the future — flushes
    the owning handle's whole pending queue in one device->host copy.
    """

    __slots__ = ("_index", "_resolved")

    def __init__(self, index: "Index"):
        self._index = index
        self._resolved: MutationReport | None = None

    @property
    def done(self) -> bool:
        """True once the owning handle has flushed past this batch."""
        return self._resolved is not None

    def result(self) -> MutationReport:
        if self._resolved is None:
            self._index.flush()
        if self._resolved is None:
            raise RuntimeError(
                "PendingReport still unresolved after flush() — its batch "
                "is no longer in the owning Index's pending queue")
        return self._resolved

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.result(), name)

    def __repr__(self) -> str:
        return (f"PendingReport({self._resolved!r})" if self.done
                else "PendingReport(<unresolved>)")


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Top-k result. Iterable as ``(distances, labels)`` for tuple-compat."""

    distances: torch.Tensor  # [Q, k] f32 (inf pads empty slots)
    labels: torch.Tensor     # [Q, k] int32 external ids (-1 pads)
    k: int
    nprobe: int
    padded_to: int           # query bucket the batch was padded to

    def __iter__(self) -> Iterator:
        return iter((self.distances, self.labels))


@runtime_checkable
class IndexProtocol(Protocol):
    """Structural interface every engine implements (as in the reference)."""

    def add(self, vecs, ids) -> MutationReport: ...

    def remove(self, ids) -> MutationReport: ...

    def search(self, queries, k: int, nprobe: int | None = None
               ) -> SearchResult: ...

    def stats(self) -> dict: ...

    @property
    def n_live(self) -> int: ...


def report_from_counts(op: str, requested: int, accepted: int,
                       overwritten: int, n_live: int, padded_to: int,
                       errors: ErrorCode = ErrorCode.NONE) -> MutationReport:
    """Build a consistent report from host-side counts (baseline engines)."""
    accepted = max(int(accepted), 0)
    overwritten = max(int(overwritten), 0)
    return MutationReport(
        op=op, requested=int(requested), accepted=accepted,
        overwritten=overwritten,
        rejected=max(int(requested) - accepted - overwritten, 0),
        errors=errors, n_live=int(n_live), padded_to=int(padded_to))


# ---------------------------------------------------------------------------
# Device-side accounting helpers
# ---------------------------------------------------------------------------

_ABORT_BITS = ERR_POOL_EXHAUSTED | ERR_CHAIN_OVERFLOW   # batch-atomic aborts


def _count_unique(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Number of distinct ids where ``mask`` holds (device scalar).

    Sorts on ``(~mask, id)``: the mask is a second sort key, not a magic
    id, so an id equal to ``INT32_MAX`` is still counted.
    """
    by_id = torch.sort(ids, stable=True).indices
    order = by_id[torch.sort((~mask[by_id]).to(torch.uint8),
                             stable=True).indices]
    sm, si = mask[order], ids[order]
    first = torch.ones_like(sm)
    first[1:] = si[1:] != si[:-1]
    return (first & sm).sum(dtype=torch.int32)


def _or_bits(err: torch.Tensor) -> torch.Tensor:
    """Bitwise-OR reduce error bits over any shape (the known bits only)."""
    acc = torch.zeros((), dtype=torch.int32, device=err.device)
    for bit in (ERR_POOL_EXHAUSTED, ERR_ID_RANGE, ERR_CHAIN_OVERFLOW):
        acc = acc | torch.where(torch.any((err & bit) != 0), bit, 0)
    return acc


_AUX_SCALARS = ("n_requested", "n_live_before", "errors", "n_live_after",
                "n_overwritten")


def _resolve_aux(auxes: list[dict]) -> list[dict]:
    """Copy a queue of device aux dicts to the host in ONE transfer.

    Every aux value is an int32 scalar, so the whole queue stacks into one
    flat tensor crossing in a single ``.cpu()``, however long the queue.
    """
    if not auxes:
        return []
    flat = torch.stack([a[k].reshape(()) for a in auxes
                        for k in _AUX_SCALARS])
    host = flat.cpu().tolist()
    n = len(_AUX_SCALARS)
    return [dict(zip(_AUX_SCALARS, host[i * n:(i + 1) * n]))
            for i in range(len(auxes))]


class _SingleOps:
    """Single-device insert/delete/search with report accounting.

    The aux dict returned next to the new state holds *device* scalars
    only; nothing is copied to the host until the handle resolves a report
    (at once in eager mode, at ``flush()`` in deferred mode). An insert
    still reads its commit decision on the host (``index._insert_impl``).
    """

    def __init__(self, cfg: SIVFConfig, use_tables: bool | None):
        self.cfg = cfg
        self.use_tables = use_tables

    def _pre(self, state: SlabPoolState, ids: torch.Tensor):
        valid = (ids >= 0) & (ids < self.cfg.n_max)
        # mask before indexing: an out-of-range id must never read another
        # slot's occupancy (it is a rejection, not an overwrite)
        safe = torch.where(valid, ids, 0).long()
        pb = valid & (state.att_slab[safe] >= 0)
        aux = {"n_requested": (ids >= 0).sum(dtype=torch.int32),
               "n_live_before": state.n_live.clone()}
        return pb, aux

    def insert(self, state: SlabPoolState, vecs: torch.Tensor,
               ids: torch.Tensor):
        pb, aux = self._pre(state, ids)
        st = ix.insert(self.cfg, _clear_error(state), vecs, ids)
        aux["errors"] = _or_bits(st.error)
        aux["n_live_after"] = st.n_live.clone()
        # overwritten == present-before AND the batch committed; on an
        # atomic abort the old payload survives, so nothing is overwritten
        failed = (st.error & _ABORT_BITS) != 0
        aux["n_overwritten"] = _count_unique(ids, pb & ~failed)
        return _clear_error(st), aux

    def delete(self, state: SlabPoolState, ids: torch.Tensor):
        _, aux = self._pre(state, ids)
        st = ix._delete_impl(self.cfg, _clear_error(state), ids)
        aux["errors"] = _or_bits(st.error)
        aux["n_live_after"] = st.n_live.clone()
        aux["n_overwritten"] = torch.zeros((), dtype=torch.int32,
                                           device=ids.device)
        return _clear_error(st), aux

    def search(self, state: SlabPoolState, queries: torch.Tensor, k: int,
               nprobe: int):
        return ix.search(self.cfg, state, queries, k, nprobe,
                         use_tables=self.use_tables)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: {item}")


# ---------------------------------------------------------------------------
# The handle
# ---------------------------------------------------------------------------

class Index:
    """Stateful SIVF session handle on one device.

    Parameters
    ----------
    cfg:        :class:`SIVFConfig`.
    centroids:  ``[n_lists, dim]`` coarse-quantizer centroids (array or
                tensor).
    backend:    ``"single"`` only in this slice.
    device:     where the state lives and every op runs; ``"cuda"`` by
                default (raises when no GPU is visible), ``"cpu"`` runs the
                plain versions of the kernels.
    use_tables: dense-table vs pointer-walk slab lookup (None = cfg).
    strict:     raise :class:`MutationRejected` on any per-batch error bit.
    min_bucket: smallest padded batch shape; batches pad to
                ``max(min_bucket, next_pow2(B))``.
    deferred:   ``add`` / ``remove`` return :class:`PendingReport` futures
                resolved by :meth:`flush` (or a clean context exit).

    Mutations update the state's planes in place (the reference donated
    them to ``jit``); :attr:`state` always names the current planes.
    """

    def __init__(self, cfg: SIVFConfig, centroids, backend="single", *,
                 device="cuda", use_tables: bool | None = None,
                 strict: bool = False, min_bucket: int = 64,
                 deferred: bool = False):
        if not (isinstance(backend, str) and backend == "single"):
            raise _not_ported(f"backend={backend!r}", ROADMAP_DIST)
        if min_bucket < 1:
            raise ValueError("min_bucket must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.strict = bool(strict)
        self.min_bucket = int(min_bucket)
        self.deferred = bool(deferred)
        self._pending: list[tuple[PendingReport, str, dict, int,
                                  bool | None]] = []
        self._epoch = 0
        self._ops = _SingleOps(cfg, use_tables)
        self._state = init_state(cfg, centroids, device=self.device)

    # -- introspection ------------------------------------------------------

    @property
    def backend(self) -> str:
        return "single"

    @property
    def n_shards(self) -> int:
        return 1

    @property
    def state(self) -> SlabPoolState:
        """The underlying planes (functional-API interop; treat read-only)."""
        return self._state

    @property
    def n_live(self) -> int:
        return int(self._state.n_live)

    @property
    def epoch(self) -> int:
        """Mutation batches dispatched over this handle's lifetime.

        Device work runs in dispatch order and each batch commits
        atomically, so a search dispatched at epoch ``e`` observes exactly
        the first ``e`` batches.
        """
        return self._epoch

    @property
    def pending_count(self) -> int:
        """Deferred mutation batches awaiting :meth:`flush` (0 if eager)."""
        return len(self._pending)

    def __len__(self) -> int:
        return self.n_live

    def stats(self) -> dict:
        """Occupancy/fragmentation report + handle/backend metadata."""
        s = ix.stats(self.cfg, self._state)
        s["backend"] = "single"
        s["n_shards"] = 1
        # all-resident pool: every used slab is trivially "resident"
        s["tiered"] = False
        s["resident_slabs"] = s["slabs_used"]
        s["hit_rate"] = 1.0
        s["hit_rate_kind"] = "cumulative"
        return s

    # -- batch bucketing ----------------------------------------------------

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return b

    def bucket_shapes(self, max_size: int) -> list[int]:
        """The bounded set of padded shapes for batches up to ``max_size``."""
        out = [self.min_bucket]
        while out[-1] < max_size:
            out.append(out[-1] * 2)
        return out

    def _pad_ids(self, ids, bucket: int) -> torch.Tensor:
        if isinstance(ids, torch.Tensor):     # device-side pad, no host trip
            ids = ids.to(self.device, torch.int32)
            return ids if ids.shape[0] == bucket else F.pad(
                ids, (0, bucket - ids.shape[0]), value=-1)
        out = np.full((bucket,), -1, np.int32)
        out[: len(ids)] = ids
        return torch.from_numpy(out).to(self.device)

    def _pad_rows(self, rows, bucket: int) -> torch.Tensor:
        if isinstance(rows, torch.Tensor):
            rows = rows.to(self.device, torch.float32)
            return rows if rows.shape[0] == bucket else F.pad(
                rows, (0, 0, 0, bucket - rows.shape[0]))
        out = np.zeros((bucket, self.cfg.dim), np.float32)
        out[: len(rows)] = rows
        return torch.from_numpy(out).to(self.device)

    @staticmethod
    def _as_batch(x, np_dtype, flat: bool = False):
        """Host inputs -> numpy; tensors stay where they are."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np_dtype)
        return x.reshape(-1) if flat else x

    # -- not ported in this slice -------------------------------------------

    def train(self, *_, **__):
        raise _not_ported("Index.train (PQ codebooks)", ROADMAP_PQ)

    def maintain(self, *_, **__):
        raise _not_ported("Index.maintain", ROADMAP_MAINT)

    def save(self, *_, **__):
        raise _not_ported("Index.save", ROADMAP_PERSIST)

    @classmethod
    def load(cls, *_, **__):
        raise _not_ported("Index.load", ROADMAP_PERSIST)

    def reshard(self, *_, **__):
        raise _not_ported("Index.reshard", ROADMAP_DIST)

    def prefetch(self, *_, **__):
        raise _not_ported("Index.prefetch (tiered pool)", ROADMAP_TIERED)

    # -- mutation -----------------------------------------------------------

    def add(self, vecs, ids, *, attrs=None, strict: bool | None = None
            ) -> "MutationReport | PendingReport":
        """Ingest a batch. ``vecs [B, D]``, ``ids [B]`` (-1 rows skipped).

        Re-adding a live id overwrites its payload (delete-then-insert);
        within-batch duplicates keep the last row. A batch that hits
        ``POOL_EXHAUSTED`` / ``CHAIN_OVERFLOW`` is atomic: it inserts
        nothing and every previously-live id keeps its old payload.
        """
        if attrs is not None:
            raise _not_ported("Index.add(attrs=...)", ROADMAP_FILTER)
        vecs = self._as_batch(vecs, np.float32)
        ids_a = self._as_batch(ids, np.int32, flat=True)
        if vecs.ndim != 2 or vecs.shape[0] != ids_a.shape[0]:
            raise ValueError(
                f"vecs {tuple(vecs.shape)} / ids {tuple(ids_a.shape)} "
                "mismatch")
        if vecs.shape[1] != self.cfg.dim:
            raise ValueError(f"dim {vecs.shape[1]} != cfg.dim {self.cfg.dim}")
        bucket = self._bucket(ids_a.shape[0])
        self._state, aux = self._ops.insert(
            self._state, self._pad_rows(vecs, bucket),
            self._pad_ids(ids_a, bucket))
        return self._emit("add", aux, bucket, strict)

    def remove(self, ids, *, strict: bool | None = None
               ) -> "MutationReport | PendingReport":
        """Evict a batch of ids; absent ids count as ``rejected``."""
        ids_a = self._as_batch(ids, np.int32, flat=True)
        bucket = self._bucket(ids_a.shape[0])
        self._state, aux = self._ops.delete(self._state,
                                            self._pad_ids(ids_a, bucket))
        return self._emit("remove", aux, bucket, strict)

    def _emit(self, op: str, aux: dict, bucket: int, strict: bool | None):
        self._epoch += 1          # batch dispatched: the committed prefix
        if self.deferred:         # a later search observes grows by one
            fut = PendingReport(self)
            self._pending.append((fut, op, aux, bucket, strict))
            return fut
        return self._finalize(op, _resolve_aux([aux])[0], bucket,
                              self.strict if strict is None else strict)

    def _finalize(self, op: str, aux: dict, bucket: int, strict: bool
                  ) -> MutationReport:
        """Build a report from an aux dict already copied to the host."""
        requested = int(aux["n_requested"])
        n0 = int(aux["n_live_before"])
        n1 = int(aux["n_live_after"])
        if op == "add":
            # overwrites are live-count-neutral and aborts restore the
            # state, so the net live delta is exactly the new ids
            overwritten = int(aux["n_overwritten"])
            accepted = max(n1 - n0, 0)
        else:
            overwritten = 0
            accepted = max(n0 - n1, 0)
        report = MutationReport(
            op=op, requested=requested, accepted=accepted,
            overwritten=overwritten,
            rejected=max(requested - accepted - overwritten, 0),
            errors=ErrorCode(int(aux["errors"])), n_live=n1,
            padded_to=bucket)
        if strict and not report.ok:
            raise MutationRejected(report)
        return report

    def flush(self) -> list[MutationReport]:
        """Resolve every outstanding :class:`PendingReport`, oldest first.

        One device->host copy for the whole queue (``_resolve_aux``). In
        strict mode the first failed report raises :class:`MutationRejected`
        after the entire queue has resolved. ``[]`` when nothing is pending.
        """
        pending, self._pending = self._pending, []
        reports: list[MutationReport] = []
        first_err: MutationRejected | None = None
        k = 0
        try:
            host_auxes = _resolve_aux([a for _, _, a, _, _ in pending])
            for k, (fut, op, _, bucket, strict) in enumerate(pending):
                strict = self.strict if strict is None else strict
                try:
                    rep = self._finalize(op, host_auxes[k], bucket, strict)
                except MutationRejected as e:
                    rep = e.report
                    if first_err is None:
                        first_err = e
                fut._resolved = rep
                reports.append(rep)
        except BaseException:
            # device failure or interrupt mid-queue: re-queue the
            # unresolved tail so no future is orphaned
            self._pending = pending[k:] + self._pending
            raise
        if first_err is not None:
            raise first_err
        return reports

    def __enter__(self) -> "Index":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.flush()
        return False

    # -- search -------------------------------------------------------------

    def search(self, queries, k: int, nprobe: int | None = None, *,
               filter=None) -> SearchResult:
        """Top-k search; ``nprobe=None`` probes every list (exact recall)."""
        if filter is not None:
            raise _not_ported("Index.search(filter=...)", ROADMAP_FILTER)
        queries = self._as_batch(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        if queries.shape[1] != self.cfg.dim:
            raise ValueError(
                f"dim {queries.shape[1]} != cfg.dim {self.cfg.dim}")
        nprobe = self.cfg.n_lists if nprobe is None \
            else min(int(nprobe), self.cfg.n_lists)
        q = queries.shape[0]
        bucket = self._bucket(q)
        d, lab = self._ops.search(self._state, self._pad_rows(queries, bucket),
                                  int(k), nprobe)
        return SearchResult(distances=d[:q], labels=lab[:q], k=int(k),
                            nprobe=nprobe, padded_to=bucket)
