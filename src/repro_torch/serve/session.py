"""Client-facing sessions and the typed request / future plumbing of the
port's serve engine.

PyTorch port's copy of ``repro/serve/session.py``. A
:class:`ClientSession` is a tenant-scoped handle onto a running
``ServeEngine``: every call is a *non-blocking submit* that either
enqueues a typed request and returns a :class:`ServeFuture`, or raises
:class:`repro_torch.serve.quota.Backpressure` at once. Results carry the
*epoch* (the number of mutation batches the index had dispatched when
the request was), which makes search-during-ingest results explainable:
a search with ``epoch == e`` observed exactly the first ``e`` mutation
batches, never a half-applied one (each batch commits atomically and
one scheduler thread dispatches everything). Results hand clients numpy
arrays on the host, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np

from repro_torch.core.api import MutationReport
from repro_torch.core.filters import CompiledFilter


class ServeFuture:
    """Engine-resolved future for one submitted request.

    ``result()`` blocks until the scheduler resolves the request (or
    raises the stored exception); ``done`` never blocks. ``on_done``
    runs exactly once, after the value/error is stored but before
    waiters wake — the engine uses it to release the tenant's in-flight
    quota slot.
    """

    __slots__ = ("_event", "_value", "_error", "_on_done")

    def __init__(self, on_done: "Callable[[ServeFuture], None] | None" = None):
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None
        self._on_done = on_done

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def _fire(self) -> None:
        cb, self._on_done = self._on_done, None
        if cb is not None:
            cb(self)
        self._event.set()

    def set_result(self, value) -> None:
        self._value = value
        self._fire()

    def set_exception(self, err: BaseException) -> None:
        self._error = err
        self._fire()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request unresolved after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value


@dataclasses.dataclass
class SearchRequest:
    tenant: str
    queries: np.ndarray        # [q, dim] float32 (host)
    k: int
    nprobe: int
    future: ServeFuture
    t_submit: float
    # effective compiled predicate (tenant-mandatory AND user filter);
    # requests coalesce only within an identical (k, nprobe, cfilter)
    cfilter: CompiledFilter | None = None


@dataclasses.dataclass
class MutationRequest:
    tenant: str
    op: str                    # "add" | "remove"
    vecs: np.ndarray | None    # [B, dim] float32 for add, None for remove
    ids: np.ndarray            # [B] int32
    future: ServeFuture
    t_submit: float
    # dense [B, n_attrs] int32, already normalized + tenant-stamped at
    # submit time (None when the index has no attributes / on remove)
    attrs: np.ndarray | None = None


@dataclasses.dataclass
class MaintenanceRequest:
    """Operator-plane request: run index maintenance between batches.

    ``ops=None`` lets the index's drift policy plan from its occupancy
    counters at dispatch time (the stats snapshot is taken by the
    scheduler thread, so the plan always reflects the committed prefix
    the ops will run against).
    """

    tenant: str
    ops: "list | None"         # explicit core.maintenance.MaintOp list
    max_ops: int
    future: ServeFuture
    t_submit: float


@dataclasses.dataclass(frozen=True)
class ServeSearchResult:
    """Per-request slice of a coalesced search tile."""

    distances: np.ndarray      # [q, k] f32 (inf pads)
    labels: np.ndarray         # [q, k] int32 external ids (-1 pads)
    k: int
    nprobe: int
    epoch: int                 # committed mutation-batch prefix observed
    coalesced: int             # live queries in the shared tile
    padded_to: int             # pow2 query bucket the tile padded to
    queue_s: float             # submit -> dispatch
    service_s: float           # dispatch -> results on the host

    def __iter__(self):
        return iter((self.distances, self.labels))


@dataclasses.dataclass(frozen=True)
class ServeMutationResult:
    """Resolved deferred mutation: the index report plus its epoch."""

    report: MutationReport
    epoch: int                 # prefix length including this batch
    queue_s: float             # submit -> flush resolution

    @property
    def ok(self) -> bool:
        return self.report.ok


@dataclasses.dataclass(frozen=True)
class ServeMaintenanceResult:
    """Resolved maintenance request: one report per op, in run order.

    An aborted op is atomic (old layout stays fully searchable), so
    ``ok=False`` here is advisory — retry after evictions, or ignore.
    """

    reports: tuple             # core.maintenance.MaintenanceReport per op
    epoch: int                 # prefix length after the committed ops
    queue_s: float             # submit -> completion

    @property
    def ok(self) -> bool:
        return all(r.committed for r in self.reports)


class ClientSession:
    """Tenant-scoped submit surface over a running engine.

    Obtained from ``ServeEngine.session(tenant)``; safe to share across
    client threads (all state lives in the engine, guarded by its lock).
    """

    def __init__(self, engine, tenant: str):
        self._engine = engine
        self.tenant = tenant

    def search(self, queries, k: int | None = None,
               nprobe: int | None = None, filter=None) -> ServeFuture:
        """Submit a search; resolves to :class:`ServeSearchResult`.

        ``filter`` is a ``repro_torch.core.filters`` predicate; if the engine
        pins a mandatory filter for this tenant the two are AND-ed — the
        tenant's filter can be narrowed, never escaped.
        """
        return self._engine.submit_search(self.tenant, queries, k=k,
                                          nprobe=nprobe, filter=filter)

    def add(self, vecs, ids, attrs=None) -> ServeFuture:
        """Submit an ingest batch; resolves to :class:`ServeMutationResult`.

        With configured attributes, ``attrs`` follows ``Index.add`` (dict
        or ``[B, n_attrs]`` array); attributes the tenant's mandatory
        filter pins with ``Eq`` are force-stamped by the engine and may be
        omitted here.
        """
        return self._engine.submit_add(self.tenant, vecs, ids, attrs=attrs)

    def remove(self, ids) -> ServeFuture:
        """Submit an eviction batch; resolves to
        :class:`ServeMutationResult`."""
        return self._engine.submit_remove(self.tenant, ids)

    def maintain(self, ops=None, max_ops: int = 2) -> ServeFuture:
        """Submit a maintenance pass (split/merge/recluster); resolves to
        :class:`ServeMaintenanceResult`. With ``ops=None`` the index's
        drift policy plans from its occupancy counters at dispatch time.
        The scheduler runs it between batches, so searches in the same
        cycle observe the pre-maintenance prefix and later searches the
        whole new layout — never a hybrid."""
        return self._engine.submit_maintenance(self.tenant, ops=ops,
                                               max_ops=max_ops)

    def __repr__(self) -> str:
        return f"ClientSession(tenant={self.tenant!r})"
