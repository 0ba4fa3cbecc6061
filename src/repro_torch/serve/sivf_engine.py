"""Streaming serve engine: the search-during-ingest front door of
``sivf_torch.Index``.

PyTorch port of ``repro/serve/sivf_engine.py``:

    index = sivf_torch.Index(cfg, centroids, deferred=True)
    with ServeEngine(index) as eng:
        writer = eng.session("ingest")
        reader = eng.session("app")
        writer.add(vecs, ids)                       # non-blocking submit
        res = reader.search(qs, k=10).result()      # ServeSearchResult

One scheduler owns the device; clients only touch queues and futures:

  * **One dispatch thread.** Client threads validate and enqueue under the
    engine lock; one scheduler thread drains the queue and is the only
    thread that touches the index or any of its tensors. It launches on
    the index's device and on its own thread's current stream, so the
    device runs its work in dispatch order and the scheduler's ordering
    decisions *are* the consistency story.
  * **Coalesced query batching.** Queued searches sharing
    ``(k, nprobe, filter)`` concatenate into one tile (up to
    ``max_coalesce`` rows) and ride one launch of the fused scan
    (kernel 1 or 2); ``Index.search`` pads the tile to its power-of-two
    query buckets, so the launch signatures stay bounded by
    ``#buckets x #(k, nprobe, filter-structure) groups`` — filter
    constants never add one — and :meth:`assert_bounded_compiles` checks
    the signatures the index launched against that bound.
  * **Mandatory tenant filters.** ``tenant_filters={tenant: predicate}``
    AND-s the predicate into every search the tenant submits and stamps
    its ``Eq``-pinned attributes onto the tenant's ingested rows, so
    isolation holds on the read *and* the write path.
  * **Epoch-consistent mutation interleaving.** Mutations go through the
    ``deferred=True`` pipeline (one device-to-host copy per flush). Each
    dispatched batch bumps ``Index.epoch``; a search dispatched at epoch
    ``e`` observes exactly the first ``e`` batches, because each batch
    commits atomically and the scheduler serializes dispatch. Searches
    dispatch *before* the mutations drained in the same cycle, and their
    tiles resolve before those mutations dispatch.
  * **Typed backpressure.** Per-tenant quotas (in-flight search cap,
    mutation-rate token bucket) and the global queue bound reject at
    submit time with :class:`repro_torch.serve.quota.Backpressure`.

A tile is resolved when its results reach the host: its distances and
labels cross in one device-to-host copy, and its ``service_s`` and its
``serve.tile`` span end there. ``close()`` (or context exit) drains:
queued requests are processed, the deferred queue is flushed, every
future resolves.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import filters as flt
from repro_torch.core.api import Index
from repro_torch.serve.quota import (
    Backpressure,
    BackpressureKind,
    TenantQuota,
    TenantState,
)
from repro_torch.serve.session import (
    ClientSession,
    MaintenanceRequest,
    MutationRequest,
    SearchRequest,
    ServeFuture,
    ServeMaintenanceResult,
    ServeMutationResult,
    ServeSearchResult,
)


def _host_results(d: torch.Tensor, labels: torch.Tensor
                  ) -> tuple[np.ndarray, np.ndarray]:
    """A tile's ``(distances, labels)`` on the host in one copy: the float
    distances travel as their int32 bits beside the labels."""
    both = torch.stack((d.contiguous().view(torch.int32), labels)).cpu()
    host = both.numpy()
    return host[0].view(np.float32), host[1]


class ServeEngine:
    """Concurrent serve front door over a ``deferred=True``
    ``sivf_torch.Index``.

    Parameters
    ----------
    index:        the :class:`sivf_torch.Index` to serve. Must be built
                  with ``deferred=True`` (the engine sequences flushes)
                  and ``strict=False`` (admission errors surface on the
                  per-request :class:`ServeMutationResult`, never as a
                  mid-flush raise). The engine runs where the index lives:
                  on the card unless the index was built on the CPU.
    default_k:    ``k`` used when a search request does not name one.
    default_nprobe: likewise for ``nprobe`` (``None`` probes every list).
    quota:        engine-wide default :class:`TenantQuota`.
    quotas:       per-tenant overrides, ``{tenant: TenantQuota}``.
    max_queue:    global bound on queued requests; beyond it submits are
                  rejected with ``QUEUE_FULL``.
    max_coalesce: cap on live query rows coalesced into one search tile
                  (the tile then pads to the next pow2 bucket).
    flush_every:  flush the deferred mutation queue once this many
                  batches are pending (the queue also flushes whenever
                  the engine goes idle, and at drain).
    tenant_filters: ``{tenant: predicate}`` *mandatory* filters
                  (``repro_torch.core.filters``). Every search from a
                  listed tenant is AND-ed with its predicate, and every
                  attribute the predicate pins with ``Eq`` is stamped onto
                  that tenant's ingested rows. (``remove`` stays
                  id-addressed.) Requires ``SIVFConfig(attributes=...)``.
    telemetry:    a ``repro_torch.obs.Telemetry`` to record into; the
                  served index's instance by default, so tile spans and
                  the index's stage spans land in one registry.
    clock:        injectable monotonic clock (tests drive quota refill
                  deterministically).
    """

    def __init__(self, index: Index, *, default_k: int = 10,
                 default_nprobe: int | None = None,
                 quota: TenantQuota | None = None,
                 quotas: "dict[str, TenantQuota] | None" = None,
                 max_queue: int = 1024, max_coalesce: int = 256,
                 flush_every: int = 8,
                 tenant_filters: "dict | None" = None,
                 telemetry=None, clock=time.monotonic):
        if not isinstance(index, Index):
            raise TypeError(
                f"index must be a sivf_torch.Index, got {index!r}")
        if not index.deferred:
            raise ValueError(
                "ServeEngine requires Index(deferred=True): the engine "
                "sequences flushes, eager per-batch syncs would stall the "
                "dispatch thread")
        if index.strict:
            raise ValueError(
                "ServeEngine requires strict=False: admission errors are "
                "reported on each ServeMutationResult, a strict flush "
                "raise would tear down the whole queue")
        if max_coalesce < 1:
            raise ValueError("max_coalesce must be >= 1")
        self._index = index
        self._default_k = int(default_k)
        self._default_nprobe = default_nprobe
        self._default_quota = quota or TenantQuota()
        self._quota_overrides = dict(quotas or {})
        self._max_queue = int(max_queue)
        self._max_coalesce = int(max_coalesce)
        self._flush_every = int(flush_every)
        self._clock = clock
        # mandatory per-tenant filters: compiled now so a bad predicate
        # fails construction; Eq-pinned values become ingest overrides
        self._tenant_filters = dict(tenant_filters or {})
        self._tenant_stamps: dict[str, dict[str, int]] = {}
        for tenant, pred in self._tenant_filters.items():
            flt.compile_filter(pred, index.cfg.attributes)
            self._tenant_stamps[tenant] = flt.eq_bindings(pred)

        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._tenants: dict[str, TenantState] = {}
        self._closing = False
        self._closed = False
        self._gate = threading.Event()        # cleared = scheduler paused
        self._gate.set()
        # scheduler-thread-only state
        self._mut_inflight: deque = deque()   # (req, PendingReport, epoch)
        self._kn_groups: set = set()
        self._max_tile = 0
        self._max_mut_rows = 0
        self._n_searches = 0
        self._n_tiles = 0
        self._n_mutations = 0
        self._n_maintenance = 0
        self._n_flushes = 0
        self._n_prefetch_errors = 0
        self._coalesce_sizes: list[int] = []
        self._loop_error: BaseException | None = None
        self._tel = telemetry if telemetry is not None \
            else index._telemetry
        t = self._tel
        self._m_requests = t.counter(
            "sivf_serve_requests_total",
            "admitted serve requests by tenant and op", ("tenant", "op"))
        self._m_rows = t.counter(
            "sivf_serve_rows_total",
            "query/mutation rows admitted by tenant and op",
            ("tenant", "op"))
        self._m_backpressure = t.counter(
            "sivf_serve_backpressure_total",
            "submits rejected by tenant and backpressure kind",
            ("tenant", "kind"))
        self._m_queue_depth = t.gauge(
            "sivf_serve_queue_depth", "requests waiting in the engine queue")
        self._m_epoch = t.gauge(
            "sivf_serve_epoch", "committed mutation-batch prefix length")
        self._m_coalesce = t.histogram(
            "sivf_serve_coalesce_rows",
            "query rows coalesced into one kernel tile",
            buckets=tuple(float(2 ** i) for i in range(13)))
        if index.pending_count:               # engine owns the queue from here
            index.flush()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sivf-serve-engine")
        self._thread.start()

    # -- client surface ------------------------------------------------------

    def session(self, tenant: str = "default") -> ClientSession:
        """A tenant-scoped submit handle (cheap; any number per tenant)."""
        return ClientSession(self, tenant)

    @property
    def index(self) -> Index:
        return self._index

    @property
    def epoch(self) -> int:
        """Committed mutation-batch prefix length (``Index.epoch``)."""
        return self._index.epoch

    def _tenant_state(self, tenant: str) -> TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = TenantState(
                self._quota_overrides.get(tenant, self._default_quota),
                clock=self._clock)
            self._tenants[tenant] = st
        return st

    def _check_open_and_capacity(self, st: TenantState, tenant: str) -> None:
        if self._closing:
            raise Backpressure(BackpressureKind.ENGINE_CLOSED, tenant,
                               "engine is closed")
        if len(self._queue) >= self._max_queue:
            st.reject(BackpressureKind.QUEUE_FULL, tenant,
                      f"engine queue at max_queue={self._max_queue}")

    def _effective_filter(self, tenant: str, filter):
        """AND the tenant's mandatory predicate (if any) with the request's
        own, compiled once at submit so bad filters raise in the client
        thread and equal filters coalesce by value downstream."""
        mandatory = self._tenant_filters.get(tenant)
        if mandatory is None:
            pred = filter
        elif filter is None:
            pred = mandatory
        else:
            pred = flt.And(mandatory, filter)
        return flt.compile_filter(pred, self._index.cfg.attributes)

    def submit_search(self, tenant: str, queries, *, k: int | None = None,
                      nprobe: int | None = None, filter=None) -> ServeFuture:
        """Validate + enqueue a search; returns a future, never blocks.
        ``queries`` are host rows (numpy or a CPU tensor): client threads
        never hand the scheduler a device tensor."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.ndim != 2 or q.shape[1] != self._index.cfg.dim:
            raise ValueError(
                f"queries {q.shape} != [q, dim={self._index.cfg.dim}]")
        k = self._default_k if k is None else int(k)
        nprobe = self._default_nprobe if nprobe is None else nprobe
        n_lists = self._index.cfg.n_lists
        nprobe = n_lists if nprobe is None else min(int(nprobe), n_lists)
        cfilter = self._effective_filter(tenant, filter)
        try:
            with self._cv:
                st = self._tenant_state(tenant)
                self._check_open_and_capacity(st, tenant)
                st.admit_search(tenant)
                fut = ServeFuture(on_done=lambda _f, s=st: self._release(s))
                self._queue.append(SearchRequest(
                    tenant=tenant, queries=q, k=k, nprobe=nprobe,
                    future=fut, t_submit=self._clock(), cfilter=cfilter))
                depth = len(self._queue)
                self._cv.notify()
        except Backpressure as e:
            self._note_backpressure(tenant, e)
            raise
        if self._tel.recording:
            self._m_requests.inc(tenant=tenant, op="search")
            self._m_rows.inc(int(q.shape[0]), tenant=tenant, op="search")
            self._m_queue_depth.set(depth)
        return fut

    def _release(self, st: TenantState) -> None:
        with self._cv:
            st.release_search()

    def _submit_mutation(self, tenant: str, op: str, vecs, ids,
                         attrs=None) -> ServeFuture:
        ids_a = np.asarray(ids, np.int32).reshape(-1)
        vecs_a = attrs_a = None
        if op == "add":
            vecs_a = np.asarray(vecs, np.float32)
            if vecs_a.ndim != 2 or vecs_a.shape[1] != self._index.cfg.dim:
                raise ValueError(
                    f"vecs {vecs_a.shape} != [B, dim={self._index.cfg.dim}]")
            if vecs_a.shape[0] != ids_a.shape[0]:
                raise ValueError(
                    f"vecs {vecs_a.shape} / ids {ids_a.shape} mismatch")
            if self._index.cfg.n_attrs:
                # normalized in the client thread (errors raise at
                # submit); Eq-pinned tenant attributes override whatever
                # the client sent
                attrs_a = flt.normalize_attrs(
                    self._index.cfg.attributes, attrs,
                    int(ids_a.shape[0]),
                    overrides=self._tenant_stamps.get(tenant))
            elif attrs is not None:
                raise ValueError(
                    "attrs= given but the served index has no "
                    "SIVFConfig(attributes=...)")
        try:
            with self._cv:
                st = self._tenant_state(tenant)
                self._check_open_and_capacity(st, tenant)
                st.admit_mutation(tenant, int(ids_a.shape[0]))
                fut = ServeFuture()
                self._queue.append(MutationRequest(
                    tenant=tenant, op=op, vecs=vecs_a, ids=ids_a,
                    future=fut, t_submit=self._clock(), attrs=attrs_a))
                depth = len(self._queue)
                self._cv.notify()
        except Backpressure as e:
            self._note_backpressure(tenant, e)
            raise
        if self._tel.recording:
            self._m_requests.inc(tenant=tenant, op=op)
            self._m_rows.inc(int(ids_a.shape[0]), tenant=tenant, op=op)
            self._m_queue_depth.set(depth)
        return fut

    def _note_backpressure(self, tenant: str, e: Backpressure) -> None:
        if self._tel.recording:
            self._m_backpressure.inc(tenant=tenant, kind=e.kind.value)

    def submit_add(self, tenant: str, vecs, ids, attrs=None) -> ServeFuture:
        """Enqueue an ingest batch through the deferred pipeline."""
        return self._submit_mutation(tenant, "add", vecs, ids, attrs=attrs)

    def submit_remove(self, tenant: str, ids) -> ServeFuture:
        """Enqueue an eviction batch through the deferred pipeline."""
        return self._submit_mutation(tenant, "remove", None, ids)

    def submit_maintenance(self, tenant: str, ops=None,
                           max_ops: int = 2) -> ServeFuture:
        """Enqueue a maintenance pass (``core/maintenance.py``).

        Operator-plane: exempt from per-tenant mutation quotas (it moves
        no client rows) but still bounded by the global queue. Searches
        drained in the same cycle dispatch first, against the
        pre-maintenance prefix; each committed op then bumps the epoch
        like any other atomic batch.
        """
        if ops is not None:
            from repro_torch.core.maintenance import MaintOp
            ops = list(ops)
            for op in ops:
                if not isinstance(op, MaintOp):
                    raise TypeError(f"ops must be MaintOp, got {op!r}")
        try:
            with self._cv:
                st = self._tenant_state(tenant)
                self._check_open_and_capacity(st, tenant)
                fut = ServeFuture()
                self._queue.append(MaintenanceRequest(
                    tenant=tenant, ops=ops, max_ops=int(max_ops),
                    future=fut, t_submit=self._clock()))
                depth = len(self._queue)
                self._cv.notify()
        except Backpressure as e:
            self._note_backpressure(tenant, e)
            raise
        if self._tel.recording:
            self._m_requests.inc(tenant=tenant, op="maintain")
            self._m_queue_depth.set(depth)
        return fut

    # -- scheduler -----------------------------------------------------------

    def _run(self) -> None:
        """The scheduler thread: bound to the index's device, then the
        loop. A fault of the loop itself is kept for :meth:`close`."""
        dev = self._index.device
        ctx = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        try:
            with ctx:
                self._loop()
        except BaseException as e:           # pragma: no cover - defensive
            self._loop_error = e
            raise

    def _loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closing and not self._queue \
                            and not self._mut_inflight:
                        return
                    if self._gate.is_set() and (
                            self._queue or self._closing
                            or self._mut_inflight):
                        break
                    self._cv.wait(timeout=0.1)
                batch = list(self._queue)
                self._queue.clear()
            searches = [r for r in batch if isinstance(r, SearchRequest)]
            muts = [r for r in batch if isinstance(r, MutationRequest)]
            maint = [r for r in batch if isinstance(r, MaintenanceRequest)]
            # the tiles resolve before the cycle's mutations dispatch: an
            # add reads its commit decision on the host, which waits for
            # the tiles' scans anyway, so resolving first costs nothing
            # and no search waits for the cycle's mutations (the reference
            # resolves last, behind JAX's asynchronous dispatch)
            self._resolve_searches(self._dispatch_searches(searches))
            self._dispatch_mutations(muts)
            self._dispatch_maintenance(maint)
            self._maybe_flush()

    def _dispatch_searches(self, searches: list) -> list:
        """Coalesce by (k, nprobe, compiled filter) and dispatch each tile
        at the *current* committed epoch, before this cycle's mutations.

        On a tiered index the tiles are pipelined: after tile ``i``'s scan
        is launched, tile ``i + 1``'s probed slabs are prefetched, and its
        search skips the plan and prefetch stages through the returned
        ticket. The prefetch's copy and frame writes run on the current
        stream behind tile ``i``'s scan, so eviction never overwrites a
        frame a launched scan still reads; its host gather overlaps that
        scan.
        """
        groups: dict = {}
        for r in searches:
            groups.setdefault((r.k, r.nprobe, r.cfilter), []).append(r)
        tiles: list = []
        # the reference sorts the (key, requests) items by their repr; no
        # key's repr is a prefix of another's, so sorting by the key's repr
        # gives the same order without formatting every request's queries
        for (k, nprobe, cfilter), reqs in sorted(
                groups.items(), key=lambda kv: repr(kv[0])):
            chunk: list = []
            rows = 0
            for r in reqs + [None]:                # None terminates
                nq = 0 if r is None else r.queries.shape[0]
                if chunk and (r is None or rows + nq > self._max_coalesce):
                    qmat = chunk[0].queries if len(chunk) == 1 else \
                        np.concatenate([c.queries for c in chunk])
                    tiles.append((chunk, qmat, k, nprobe, cfilter))
                    chunk, rows = [], 0
                if r is not None:
                    chunk.append(r)
                    rows += nq
        dispatched: list = []
        epoch = self._index.epoch
        ticket = self._prefetch_tile(tiles[0]) if tiles else None
        for i, tile in enumerate(tiles):
            self._dispatch_tile(tile, epoch, dispatched, ticket)
            ticket = self._prefetch_tile(tiles[i + 1]) \
                if i + 1 < len(tiles) else None
        return dispatched

    def _prefetch_tile(self, tile):
        """Stage a tile's probed slabs ahead of its dispatch (tiered only;
        ``Index.prefetch`` is a no-op ``None`` on an all-resident index).
        A prefetch error is swallowed — the tile's own search meets the
        same condition and reports it on the right futures — and counted
        in ``stats()["prefetch_errors"]``."""
        _, qmat, _, nprobe, _ = tile
        try:
            return self._index.prefetch(qmat, nprobe)
        except Exception:
            self._n_prefetch_errors += 1
            return None

    def _dispatch_tile(self, tile, epoch: int, dispatched: list,
                       ticket=None) -> None:
        chunk, qmat, k, nprobe, cfilter = tile
        # the tile root span lives from dispatch to the results' arrival on
        # the host (_resolve_searches); its scope exits right after
        # dispatch so the next tile's pipelined prefetch does not nest;
        # its attributes are formatted only when telemetry records
        span = self._tel.open_span(
            "serve.tile", root=True, epoch=epoch,
            tenant=",".join(sorted({r.tenant for r in chunk})),
            filter=None if cfilter is None else str(cfilter.structure),
            rows=int(qmat.shape[0])) if self._tel.recording else None
        t0 = self._clock()
        try:
            res = self._index.search(qmat, k, nprobe, filter=cfilter,
                                     _prefetched=ticket)
        except Exception as e:
            self._tel.exit_scope(span)
            self._tel.finish_span(span)
            for r in chunk:
                r.future.set_exception(e)
            return
        self._tel.exit_scope(span)
        self._n_tiles += 1
        self._n_searches += len(chunk)
        self._coalesce_sizes.append(int(qmat.shape[0]))
        self._max_tile = max(self._max_tile, res.padded_to)
        if self._tel.recording:
            self._m_coalesce.observe(int(qmat.shape[0]))
        # launch signatures are per filter STRUCTURE, not per constant set
        self._kn_groups.add((k, res.nprobe,
                             None if cfilter is None else cfilter.structure))
        dispatched.append((chunk, res, epoch, t0, span))

    def _dispatch_mutations(self, muts: list) -> None:
        for r in muts:
            try:
                if r.op == "add":
                    pending = self._index.add(r.vecs, r.ids, attrs=r.attrs)
                else:
                    pending = self._index.remove(r.ids)
            except Exception as e:
                r.future.set_exception(e)
                continue
            self._n_mutations += 1
            self._max_mut_rows = max(self._max_mut_rows,
                                     int(r.ids.shape[0]))
            self._mut_inflight.append((r, pending, self._index.epoch))

    def _dispatch_maintenance(self, maint: list) -> None:
        """Run queued maintenance passes, after this cycle's searches
        (they observe the pre-maintenance prefix) and its mutations (the
        pass sees their committed state)."""
        for r in maint:
            try:
                reports = self._index.maintain(ops=r.ops,
                                               max_ops=r.max_ops,
                                               strict=False)
            except Exception as e:
                r.future.set_exception(e)
                continue
            self._n_maintenance += 1
            if self._tel.recording:
                self._m_epoch.set(self._index.epoch)
            r.future.set_result(ServeMaintenanceResult(
                reports=tuple(reports), epoch=self._index.epoch,
                queue_s=self._clock() - r.t_submit))

    def _maybe_flush(self) -> None:
        """Flush when the deferred queue is deep, the engine is idle, or
        a drain is in progress — one copy resolves every batch."""
        if not self._mut_inflight:
            return
        if self._index.pending_count < self._flush_every \
                and not self._closing:
            with self._cv:
                if self._queue:        # more work queued: keep deferring
                    return
        try:
            self._index.flush()
        except Exception as e:
            while self._mut_inflight:
                req, _, _ = self._mut_inflight.popleft()
                req.future.set_exception(e)
            return
        self._n_flushes += 1
        now = self._clock()
        if self._tel.recording:
            self._m_epoch.set(self._index.epoch)
        while self._mut_inflight:
            req, pending, epoch = self._mut_inflight.popleft()
            if self._tel.recording:
                self._tel.record_duration(
                    "serve.mutation_queue", now - req.t_submit,
                    attach=False)
            req.future.set_result(ServeMutationResult(
                report=pending.result(), epoch=epoch,
                queue_s=now - req.t_submit))

    def _resolve_searches(self, dispatched: list) -> None:
        for chunk, res, epoch, t0, span in dispatched:
            try:
                d, labels = _host_results(res.distances, res.labels)
            except Exception as e:
                self._tel.finish_span(span)
                for r in chunk:
                    r.future.set_exception(e)
                continue
            t1 = self._clock()
            self._tel.finish_span(span)  # tile wall time ~= service_s
            total = sum(r.queries.shape[0] for r in chunk)
            off = 0
            for r in chunk:
                nq = r.queries.shape[0]
                if self._tel.recording:
                    self._tel.record_duration(
                        "serve.queue", t0 - r.t_submit, attach=False)
                r.future.set_result(ServeSearchResult(
                    distances=d[off:off + nq], labels=labels[off:off + nq],
                    k=res.k, nprobe=res.nprobe, epoch=epoch,
                    coalesced=total, padded_to=res.padded_to,
                    queue_s=t0 - r.t_submit, service_s=t1 - t0))
                off += nq

    # -- lifecycle -----------------------------------------------------------

    def pause(self) -> None:
        """Hold the scheduler after its current cycle: submits keep
        queueing (and hitting quota / queue bounds) but nothing
        dispatches until :meth:`resume`."""
        self._gate.clear()

    def resume(self) -> None:
        with self._cv:
            self._gate.set()
            self._cv.notify_all()

    def close(self, drain: bool = True) -> None:
        """Stop the engine. ``drain=True`` (default) processes every queued
        request and flushes the deferred queue before returning — no
        future is left unresolved. ``drain=False`` fails queued requests
        with ``ENGINE_CLOSED`` (already-dispatched work still resolves)."""
        with self._cv:
            if self._closed:
                return
            self._closing = True
            dropped = []
            if not drain:
                dropped = list(self._queue)
                self._queue.clear()
            self._gate.set()                  # a paused engine still drains
            self._cv.notify_all()
        for r in dropped:
            r.future.set_exception(Backpressure(
                BackpressureKind.ENGINE_CLOSED, r.tenant,
                "engine closed before dispatch"))
        self._thread.join(timeout=120)
        if self._thread.is_alive():            # pragma: no cover - defensive
            raise RuntimeError("serve scheduler failed to drain")
        if self._loop_error is not None:       # pragma: no cover - defensive
            raise RuntimeError("serve scheduler failed") \
                from self._loop_error
        if self._index.pending_count:          # pragma: no cover - defensive
            self._index.flush()
        self._closed = True

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close(drain=exc_type is None)
        return False

    # -- introspection -------------------------------------------------------

    def compile_bound(self) -> int:
        """Upper bound on search launch signatures for the traffic served
        so far: ``#pow2 query buckets up to the largest tile x #(k,
        nprobe, filter-structure)`` groups — filter *constants* never add
        one, only distinct predicate shapes do."""
        max_tile = max(self._max_tile, self._index.min_bucket)
        buckets = len(self._index.bucket_shapes(max_tile))
        return buckets * max(1, len(self._kn_groups))

    def assert_bounded_compiles(self) -> tuple[int, int]:
        """Assert the search launch signatures the index dispatched (its
        ``compile_stats()["search"]``, counted from the shapes launched)
        are <= :meth:`compile_bound`; returns ``(observed, bound)``."""
        observed = self._index.compile_stats()["search"]
        bound = self.compile_bound()
        if observed > bound:
            raise AssertionError(
                f"search launch signatures {observed} exceed the "
                f"coalescing bound {bound} ({len(self._kn_groups)} (k, "
                f"nprobe, filter) groups, max tile {self._max_tile})")
        return observed, bound

    def telemetry(self) -> dict:
        """JSON-able telemetry snapshot (metrics + slow-query log) of the
        registry this engine records into — by default the served
        index's, so one snapshot covers tile roots, plan / prefetch / scan
        stages, cache and transfer counters and launch signatures."""
        self._index._note_compiles()
        return self._tel.snapshot()

    def render_prometheus(self) -> str:
        """Prometheus text exposition of the same registry."""
        self._index._note_compiles()
        return self._tel.render_prometheus()

    def stats(self) -> dict:
        """Serve-side counters + the index's own launch signatures."""
        with self._cv:
            rejections = {
                tenant: {kind.value: n for kind, n in st.rejections.items()
                         if n}
                for tenant, st in self._tenants.items()}
            inflight = {tenant: st.inflight_searches
                        for tenant, st in self._tenants.items()}
            queued = len(self._queue)
        sizes = self._coalesce_sizes
        return {
            "epoch": self.epoch,
            "queued": queued,
            "searches": self._n_searches,
            "search_tiles": self._n_tiles,
            "coalesce_mean": round(float(np.mean(sizes)), 2) if sizes else 0,
            "coalesce_max": max(sizes, default=0),
            "mutations": self._n_mutations,
            "maintenance_passes": self._n_maintenance,
            "flushes": self._n_flushes,
            "prefetch_errors": self._n_prefetch_errors,
            "pending_mutations": self._index.pending_count,
            "inflight_searches": inflight,
            "rejections": rejections,
            "kn_groups": sorted(self._kn_groups, key=repr),
            "compiles": self._index.compile_stats(),
            "compile_bound": self.compile_bound(),
        }
