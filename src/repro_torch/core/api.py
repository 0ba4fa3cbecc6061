"""``sivf_torch.Index`` — the streaming-session handle, single or sharded.

PyTorch counterpart of ``repro/core/api.py``:

    cfg = SIVFConfig(dim=128, n_lists=4096, n_slabs=16384)
    index = Index(cfg, centroids)                  # device="cuda" by default
    report = index.add(vecs, ids)                  # -> MutationReport
    result = index.search(queries, k=10, nprobe=32)
    report = index.remove(ids)

    with Index(cfg, centroids, deferred=True) as index:
        futs = [index.add(v, i) for v, i in stream]    # -> PendingReport
        reports = index.flush()                        # one copy, N reports

    index.save(path); index = Index.load(path, device="cuda")
    index.maintain()                               # split / merge / recluster

    mesh = ShardMesh.virtual(4, "cuda")            # or ShardMesh(devices)
    index = Index(cfg, centroids, backend=mesh)    # id % 4 owns each id
    index = Index.load(path, backend=mesh)         # any checkpoint, any S
    index.reshard("single")                        # a live handle, in place

The handle owns a :class:`~repro_torch.core.state.SlabPoolState` on one
device, or with ``backend=ShardMesh(...)`` one per shard
(``core/distributed.py``: broadcast inserts and deletes, scatter-gather
searches merged by the port's top-k), pads ragged batches to power-of-two
buckets (as the reference does, which keeps the shapes its kernels see
few), turns the sticky ``state.error`` bits into per-batch
:class:`MutationReport`s (with each shard's bits on a mesh), and resolves
deferred reports in **one** device->host copy per queue.

With ``SIVFConfig(pq=PQConfig(...))`` the handle trains PQ codebooks
(:meth:`Index.train`, or ``pq_codebooks=`` at construction), ingest
encodes batches to uint8 codes and search scores them by ADC. With
``SIVFConfig(attributes=...)`` every ``add`` stamps each row's attributes
and ``search(filter=...)`` masks failing rows inside the scan.

With ``SIVFConfig(device_slabs=N)`` the payload planes live on the host
(pinned on CUDA) and ``N`` cache frames on the device (``core/tiered.py``):
searches prefetch their probed slabs, :meth:`Index.prefetch` stages a
coming batch, and results are ``==`` the all-resident pool's.
:meth:`Index.save` / :meth:`Index.load` write and read the reference's
checkpoint format 3 (``checkpoint/manager.py``; a mesh's planes carry a
leading shard axis), any checkpoint loading onto any shard count, and
:meth:`Index.maintain` runs split / merge / recluster ops
(``core/maintenance.py``), atomically across a mesh's shards.

Every handle records into a ``repro_torch.obs.Telemetry`` (the process
default unless given ``telemetry=``) while it records: enabled
(``sivf_torch.telemetry.enable()``) or under a ``torch.profiler``
session. It records the ``mutation.dispatch``, ``mutation.flush``,
``maintenance.op`` and ``index.search`` spans, each call's root from its
entry to its return, with the single-device path's stages inside
(``probe`` / ``tables`` / ``adc`` / ``scan``; ``assign`` / ``stage`` /
``decide`` / ``commit``; ``delete``; ``report``), the device-launching
ones timed on the card; mutation and maintenance row counters, the slabs
allocated and reclaimed, and the launch signatures
:meth:`Index.compile_stats` counts.

The reference's ``impl`` / ``block_q`` (TPU kernel and tiling choices)
have no counterpart: the tensor's device picks the scan path.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Iterator, Protocol, runtime_checkable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import interop
from repro_torch.core import distributed as dist
from repro_torch.core import filters as flt
from repro_torch.core import index as ix
from repro_torch.core import pq as pqmod
from repro_torch.core import quantizer
from repro_torch.core import tiered as trt
from repro_torch.core.state import (
    ERR_CHAIN_OVERFLOW,
    ERR_ID_RANGE,
    ERR_POOL_EXHAUSTED,
    PLANES,
    SIVFConfig,
    SlabPoolState,
    clear_error as _clear_error,
    init_state,
)
from repro_torch.obs.trace import Span
from repro_torch.utils import resolve_device


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
    measured from device state, as in the reference, so they stay truthful
    under a partial per-shard failure on a mesh: ids owned by an aborting
    shard keep their old payloads and count as rejected. ``shard_errors``
    then carries each shard's own bits (``None`` on the single backend).
    """

    op: str                 # "add" | "remove"
    requested: int          # non-padding rows in the caller's batch
    accepted: int
    overwritten: int
    rejected: int
    errors: ErrorCode       # this batch's error bits (already cleared)
    n_live: int             # total live vectors after the batch
    padded_to: int          # bucket shape the batch was padded to
    shard_errors: tuple[ErrorCode, ...] | None = None  # mesh: per-shard bits

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


class MaintenanceAborted(RuntimeError):
    """Raised in strict mode when a maintenance op aborts atomically.

    The abort is clean by construction (every live id stays searchable
    under the old list layout, old centroids included), so catching this
    and retrying after evictions is safe. Raised after every requested op
    has resolved, like :meth:`Index.flush`.
    """

    def __init__(self, report):
        super().__init__(
            f"maintenance {report.kind} on lists {report.lists} aborted: "
            f"error bits {report.errors:#x} ({report.rows} rows kept "
            f"under the old layout)")
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
                "n_overwritten", "n_reclaimed")


def _resolve_aux(auxes: list[dict]) -> list[dict]:
    """Copy a queue of device aux dicts to the host in ONE transfer.

    Every aux value is int32 (six scalars a batch, plus a mesh's
    per-shard error vector ``shard_errors``), so the whole queue
    concatenates into one flat tensor crossing in a single ``.cpu()``,
    however long the queue.
    """
    if not auxes:
        return []
    parts, widths = [], []
    for a in auxes:
        parts.append(torch.stack([a[k].reshape(()) for k in _AUX_SCALARS]))
        se = a.get("shard_errors")
        widths.append(0 if se is None else se.numel())
        if se is not None:
            parts.append(se.reshape(-1).to(torch.int32))
    host = torch.cat(parts).cpu().tolist()
    n, out, off = len(_AUX_SCALARS), [], 0
    for w in widths:
        d = dict(zip(_AUX_SCALARS, host[off:off + n]))
        if w:
            d["shard_errors"] = host[off + n:off + n + w]
        out.append(d)
        off += n + w
    return out


class _SingleOps:
    """Single-device insert/delete/search with report accounting.

    The aux dict returned next to the new state holds *device* scalars
    (``_AUX_SCALARS``: ``n_reclaimed`` counts the slabs the batch freed);
    nothing is copied to the host until the handle resolves a report (at
    once in eager mode, at ``flush()`` in deferred mode). An insert still
    reads its commit decision on the host, and its aux carries the slabs
    that commit took off the free stack as a host int
    (``slabs_allocated``); with ``want_plan`` (the tiered pool) it also
    returns the commit's plan, on the device, for the host-store replay.
    Each op runs its stages under ``tel``'s spans, timed on the device.
    """

    def __init__(self, cfg: SIVFConfig, use_tables: bool | None, tel):
        self.cfg = cfg
        self.use_tables = use_tables
        self.tel = tel

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
               ids: torch.Tensor, attrs: torch.Tensor | None = None,
               want_plan: bool = False):
        cfg, span, dev = self.cfg, self.tel.span, state.device
        pb, aux = self._pre(state, ids)
        vecs = vecs.to(cfg.dtype)
        with span("assign", device=dev):
            lists = quantizer.assign(state.centroids, vecs, cfg.metric)
        # index._insert_impl's three steps, each a span
        state = _clear_error(state)
        with span("stage", device=dev):
            stg = ix._insert_stage(cfg, state, vecs, ids, lists)
        with span("decide"):
            decision = stg.decision.tolist()    # the one host read
        with span("commit", device=dev):
            out = ix._insert_commit(cfg, state, stg, decision, attrs=attrs,
                                    want_plan=want_plan)
        st, plan = out if want_plan else (out, None)
        committed = bool(decision[0])
        aux["slabs_allocated"] = int(decision[2]) if committed else 0
        aux["n_reclaimed"] = stg.reclaimed if committed \
            else torch.zeros((), dtype=torch.int32, device=dev)
        aux["errors"] = _or_bits(st.error)
        aux["n_live_after"] = st.n_live.clone()
        # overwritten == present-before AND the batch committed; on an
        # atomic abort the old payload survives, so nothing is overwritten
        failed = (st.error & _ABORT_BITS) != 0
        aux["n_overwritten"] = _count_unique(ids, pb & ~failed)
        if want_plan:
            return _clear_error(st), aux, plan
        return _clear_error(st), aux

    def delete(self, state: SlabPoolState, ids: torch.Tensor):
        _, aux = self._pre(state, ids)
        with self.tel.span("delete", device=state.device):
            st, aux["n_reclaimed"] = ix._delete_impl(
                self.cfg, _clear_error(state), ids)
        aux["errors"] = _or_bits(st.error)
        aux["n_live_after"] = st.n_live.clone()
        aux["n_overwritten"] = torch.zeros((), dtype=torch.int32,
                                           device=ids.device)
        return _clear_error(st), aux

    def search(self, state: SlabPoolState, queries: torch.Tensor, k: int,
               nprobe: int, fstruct: tuple | None = None,
               fconsts: torch.Tensor | None = None):
        return ix.search(self.cfg, state, queries, k, nprobe,
                         use_tables=self.use_tables, fstruct=fstruct,
                         fconsts=fconsts, tel=self.tel)


class _MeshOps:
    """Sharded insert/delete/search over a ``ShardedState``
    (``core/distributed.py``) with the same aux contract as
    :class:`_SingleOps` plus ``shard_errors``, the ``[S]`` per-shard error
    vector. Every aux tensor lies on shard 0's device, so a queue of them
    still crosses in one copy. Inserts are atomic per shard: ids owned by
    an aborting shard keep their old payloads and do not count as
    overwritten; ids on committing shards proceed normally.
    """

    def __init__(self, cfg: SIVFConfig, mesh, axis: str,
                 use_tables: bool | None):
        self.cfg = cfg
        self.n = dist._axis_size(mesh, axis)
        self._insert = {wp: dist.sharded_insert(cfg, mesh, axis, wp)
                        for wp in (False, True)}
        self._delete = dist.sharded_delete(cfg, mesh, axis)
        self._search = dist.sharded_search(cfg, mesh, axis, use_tables)

    def _pre(self, state, ids: torch.Tensor):
        dev = state.device                  # the ids' device: shard 0's
        valid = (ids >= 0) & (ids < self.cfg.n_max)
        # an id lives only on its owner shard: read that shard's ATT row
        # (mask before indexing, as on the single backend)
        safe = torch.where(valid, ids, 0).long()
        owner = torch.where(valid, ids % self.n, 0)
        pb = torch.zeros_like(valid)
        for s, sh in enumerate(state.shards):
            hit = (sh.att_slab[safe.to(sh.device)] >= 0).to(dev)
            pb |= (owner == s) & hit
        aux = {"n_requested": (ids >= 0).sum(dtype=torch.int32),
               "n_live_before": state.stacked("n_live").sum(
                   dtype=torch.int32)}
        return valid, valid & pb, aux

    @staticmethod
    def _clear(state):
        return type(state)([_clear_error(sh) for sh in state.shards])

    def _post(self, st, aux: dict):
        errs = st.stacked("error")                           # [S] bits
        aux["errors"] = _or_bits(errs)
        aux["shard_errors"] = errs
        aux["n_live_after"] = st.stacked("n_live").sum(dtype=torch.int32)
        return errs

    def insert(self, state, vecs: torch.Tensor, ids: torch.Tensor,
               attrs: torch.Tensor | None = None, want_plan: bool = False):
        valid, pb, aux = self._pre(state, ids)
        out = self._insert[want_plan](self._clear(state), vecs, ids, attrs,
                                      aux)
        st, plan = out if want_plan else (out, None)
        errs = self._post(st, aux)
        # partial per-shard failure: only ids on committing shards count
        # as overwritten (an aborting shard kept its old payloads)
        shard_failed = (errs & _ABORT_BITS) != 0
        failed = shard_failed[torch.where(valid, ids % self.n, 0).long()]
        aux["n_overwritten"] = _count_unique(ids, pb & ~failed)
        if want_plan:
            return self._clear(st), aux, plan
        return self._clear(st), aux

    def delete(self, state, ids: torch.Tensor):
        _, _, aux = self._pre(state, ids)
        st = self._delete(self._clear(state), ids, aux)
        self._post(st, aux)
        aux["n_overwritten"] = torch.zeros((), dtype=torch.int32,
                                           device=state.device)
        return self._clear(st), aux

    def search(self, state, queries: torch.Tensor, k: int, nprobe: int,
               fstruct: tuple | None = None,
               fconsts: torch.Tensor | None = None):
        return self._search(state, queries, k, nprobe, fstruct, fconsts)


def _resolve_backend(backend, axis: str) -> tuple[str, int]:
    """Validate a backend spec -> (``"single"`` | ``"mesh"``, shard count).

    The one place that says what a backend argument may be (the
    constructor, :meth:`Index.load` and :meth:`Index.reshard` take the
    same forms): a :class:`~repro_torch.core.distributed.ShardMesh`
    carrying the index's data axis, or the literal ``"single"``.
    """
    if isinstance(backend, dist.ShardMesh):
        return "mesh", dist._axis_size(backend, axis)
    if isinstance(backend, str) and backend == "single":
        return "single", 1
    raise TypeError(
        f"backend must be 'single' or a ShardMesh, got {backend!r}")


# ---------------------------------------------------------------------------
# The handle
# ---------------------------------------------------------------------------

class Index:
    """Stateful SIVF session handle on one device or a mesh of shards.

    Parameters
    ----------
    cfg:        :class:`SIVFConfig`.
    centroids:  ``[n_lists, dim]`` coarse-quantizer centroids (array or
                tensor).
    backend:    ``"single"`` (default) or a
                :class:`~repro_torch.core.distributed.ShardMesh` whose
                ``axis`` dimension data-shards the index (paper §4.2):
                shard ``id % S`` owns each id, shard ``s`` lives on
                ``mesh.devices[s]``.
    axis:       the mesh's data axis (``"data"``).
    device:     where the state lives and every op runs; ``"cuda"`` by
                default (raises when no GPU is visible), ``"cpu"`` runs the
                plain versions of the kernels. A mesh brings its own
                devices: an explicit ``device`` that disagrees with them
                raises ``ValueError``.
    use_tables: dense-table vs pointer-walk slab lookup (None = cfg).
    strict:     raise :class:`MutationRejected` on any per-batch error bit.
    min_bucket: smallest padded batch shape; batches pad to
                ``max(min_bucket, next_pow2(B))``.
    deferred:   ``add`` / ``remove`` return :class:`PendingReport` futures
                resolved by :meth:`flush` (or a clean context exit).
    pq_codebooks: pre-trained ``[m, ksub, dim//m]`` PQ codebooks (only with
                ``cfg.pq``), for instance the reference's, carried across;
                otherwise call :meth:`train` before the first ``add``.
    telemetry:  a ``repro_torch.obs.Telemetry`` to record spans and
                counters into; the process default when omitted.

    Mutations update the state's planes in place (the reference donated
    them to ``jit``); :attr:`state` always names the current planes. With
    ``cfg.device_slabs`` the state's payload planes are zero-width and the
    tiered runtime (``core/tiered.py``) holds the payloads.

    ``_state`` (a ``SlabPoolState``, a ``ShardedState``, or
    ``{plane: array}`` with the reference's dtypes, stacked ``[S, ...]``
    on a mesh; full-pool or, when tiered, meta) and ``_pq_trained`` are
    :meth:`load`'s and :meth:`reshard`'s way in.
    """

    def __init__(self, cfg: SIVFConfig, centroids, backend="single", *,
                 axis: str = "data", device=None,
                 use_tables: bool | None = None, strict: bool = False,
                 min_bucket: int = 64, deferred: bool = False,
                 pq_codebooks=None, telemetry=None, _state=None,
                 _pq_trained: bool | None = None):
        if min_bucket < 1:
            raise ValueError("min_bucket must be >= 1")
        if pq_codebooks is not None and cfg.pq is None:
            raise ValueError("pq_codebooks given but cfg.pq is None")
        kind, _ = _resolve_backend(backend, axis)
        self._axis = axis
        self._mesh = backend if kind == "mesh" else None
        if self._mesh is not None:
            _check_mesh_device(self._mesh, device)
            for d in set(self._mesh.devices):
                resolve_device(d)
            self.device = self._mesh.devices[0]
        else:
            self.device = resolve_device("cuda" if device is None
                                         else device)
        if telemetry is None:
            from repro_torch import obs
            telemetry = obs.default()
        self._telemetry = telemetry
        self.cfg = cfg
        self.strict = bool(strict)
        self.min_bucket = int(min_bucket)
        self.deferred = bool(deferred)
        self._pending: list[tuple[PendingReport, str, dict, int,
                                  bool | None]] = []
        self._epoch = 0
        self._use_tables = use_tables
        self._ops = _SingleOps(cfg, use_tables, telemetry) \
            if self._mesh is None \
            else _MeshOps(cfg, self._mesh, axis, use_tables)
        self._maint_cursor = 0      # round-robin recluster position
        self.last_maintain_ms: list[dict] = []
        store = None
        if _state is not None and cfg.tiered \
                and trt.is_full_state(cfg, _state):
            # a full pool (a load, a reshard): payloads to the host store
            # (one a shard on a mesh), only the metadata to the device
            split = trt.split_full if self._mesh is None \
                else trt.split_full_mesh
            _state, store = split(cfg, _state, pin=self.device.type == "cuda")
        if isinstance(_state, dict):
            _state = interop.state_from_numpy(cfg, _state, self.device) \
                if self._mesh is None else dist.place_sharded(
                    cfg, _state, self._mesh, axis)
        if _state is None:
            _state = init_state(cfg, centroids, pq_codebooks,
                                device=self.device) \
                if self._mesh is None else dist.init_sharded_state(
                    cfg, centroids, self._mesh, axis, pq_codebooks)
        self._state = _state
        self._tiered = None
        if cfg.tiered:
            self._tiered = trt.TieredRuntime(
                cfg, self.device, use_tables, store, telemetry=telemetry) \
                if self._mesh is None else trt.MeshTieredRuntime(
                    cfg, self._mesh.devices, use_tables, store,
                    telemetry=telemetry)
        if _pq_trained is None:
            _pq_trained = cfg.pq is None or pq_codebooks is not None
        self._pq_trained = bool(_pq_trained)
        # launch signatures per op: the keys the reference's jit caches
        # would hold (see compile_stats); _note_compiles() turns their
        # growth into counter events
        self._sigs: dict[str, set] = {"add": set(), "remove": set(),
                                      "search": set()}
        t = telemetry
        self._m_compiles = t.counter(
            "sivf_jit_compile_events_total",
            "new launch signatures (the reference's jit executables) "
            "dispatched since handle construction")
        self._m_executables = t.gauge(
            "sivf_jit_executables",
            "distinct launch signatures this handle has dispatched")
        self._m_mutations = t.counter(
            "sivf_index_mutation_rows_total",
            "mutation rows dispatched through this handle", ("op",))
        self._m_maint = t.counter(
            "sivf_maintenance_ops_total",
            "maintenance ops dispatched", ("kind", "outcome"))
        self._m_maint_rows = t.counter(
            "sivf_maintenance_rows_total",
            "live rows moved by committed maintenance ops")
        self._m_slabs_allocated = t.counter(
            "sivf_slabs_allocated_total",
            "slabs committed adds took off the free stack")
        self._m_slabs_reclaimed = t.counter(
            "sivf_slabs_reclaimed_total",
            "slabs adds and removes returned to the free stack")
        self._compiles_seen = 0

    # -- introspection ------------------------------------------------------

    @property
    def backend(self) -> str:
        return "single" if self._mesh is None else "mesh"

    @property
    def n_shards(self) -> int:
        return 1 if self._mesh is None else self._ops.n

    @property
    def state(self):
        """The underlying planes (functional-API interop; treat read-only):
        a ``SlabPoolState`` on the single backend; on a mesh a
        ``core.distributed.ShardedState``, one pool per shard, whose planes
        read by name are stacked ``[S, ...]`` as the reference's are."""
        return self._state

    @property
    def n_live(self) -> int:
        return int(self._state.n_live.sum())

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
        """Occupancy/fragmentation report + handle/backend metadata (and
        the tiered cache's counters, ``core/tiered.py``)."""
        s = ix.stats(self.cfg, self._state) if self._mesh is None \
            else dist.stats(self.cfg, self._state)
        s["backend"] = self.backend
        s["n_shards"] = self.n_shards
        s["compiles"] = self.compile_stats()
        if self._tiered is not None:
            s.update(self._tiered.stats())
        else:
            # all-resident pool: every used slab is trivially "resident"
            s["tiered"] = False
            s["resident_slabs"] = s["slabs_used"]
            s["hit_rate"] = 1.0
            s["hit_rate_kind"] = "cumulative"
        return s

    def compile_stats(self) -> dict:
        """Distinct launch signatures this handle has dispatched, per op.

        The port compiles no per-shape executable (its kernels build once
        a process), so this counts what the reference's jit caches would
        hold: ``add`` / ``remove`` by padded bucket, ``search`` by
        (padded bucket, k, nprobe, filter structure), and on a tiered
        handle ``tiered_plan`` by (bucket, nprobe) and ``tiered_scan`` by
        (bucket, table width, k, filter structure), its searches leaving
        ``search`` at 0 as the reference's do. The counts come from the
        shapes actually launched. Unlike the reference's, they are per
        handle: two handles of an equal config do not share them.
        """
        out = {op: len(sigs) for op, sigs in self._sigs.items()}
        if self._tiered is not None:
            out.update(self._tiered.compile_stats())
        return out

    def _total_compiles(self) -> int:
        return sum(self.compile_stats().values())

    def _note_compiles(self) -> None:
        """Fold launch-signature growth into the telemetry registry
        (``sivf_jit_compile_events_total`` counts *new* signatures since
        construction)."""
        if not self._telemetry.recording:
            return
        now = self._total_compiles()
        if now > self._compiles_seen:
            self._m_compiles.inc(now - self._compiles_seen)
        self._compiles_seen = max(self._compiles_seen, now)
        self._m_executables.set(now)

    def compile_events(self) -> int:
        """New launch signatures since this handle was built (the value
        ``sivf_jit_compile_events_total`` accumulates)."""
        return max(self._total_compiles(), self._compiles_seen)

    def telemetry(self) -> dict:
        """JSON-able snapshot of this handle's telemetry (metrics +
        slow-query log). The handle records into the process default
        unless constructed with an explicit ``telemetry=``."""
        self._note_compiles()
        return self._telemetry.snapshot()

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

    def _pad_attrs(self, attrs, bucket: int) -> torch.Tensor:
        # padding rows carry zeros; their ids are -1 so they never commit
        if isinstance(attrs, torch.Tensor):
            attrs = attrs.to(self.device, torch.int32)
            return attrs if attrs.shape[0] == bucket else F.pad(
                attrs, (0, 0, 0, bucket - attrs.shape[0]))
        out = np.zeros((bucket, self.cfg.n_attrs), np.int32)
        out[: len(attrs)] = attrs
        return torch.from_numpy(out).to(self.device)

    def _normalize_attrs(self, attrs, n: int):
        """``add``'s ``attrs=`` -> ``[n, n_attrs]`` int32: a tensor of that
        shape stays where it is, anything else goes through
        ``filters.normalize_attrs``."""
        if attrs is None:
            raise ValueError(
                f"index has attributes {self.cfg.attributes}: add() "
                f"requires attrs= for every row (dict of per-attribute "
                f"values or a [B, {self.cfg.n_attrs}] int array)")
        if isinstance(attrs, torch.Tensor):
            if tuple(attrs.shape) != (n, self.cfg.n_attrs):
                raise ValueError(
                    f"attrs shape {tuple(attrs.shape)} != "
                    f"{(n, self.cfg.n_attrs)} (attributes "
                    f"{list(self.cfg.attributes)})")
            return attrs
        return flt.normalize_attrs(self.cfg.attributes, attrs, n)

    # -- PQ training --------------------------------------------------------

    def train(self, xs, *, generator: torch.Generator | None = None,
              iters: int = 16) -> "Index":
        """Train the PQ codebooks from a sample (``cfg.pq`` required).

        Runs per-subspace k-means (``core.pq.train_pq``) on the handle's
        device and installs the codebooks into the state (replicated to
        every shard on a mesh). Must happen on
        an *empty* index (stored codes would go stale under new codebooks)
        and before the first ``add``; alternatively pass ``pq_codebooks=``
        at construction. ``generator`` draws the initial codewords
        (default: a CPU generator seeded 0). Returns ``self``.
        """
        if self.cfg.pq is None:
            raise RuntimeError("train() needs SIVFConfig(pq=PQConfig(...))")
        if self.n_live:
            raise RuntimeError(
                "train() on a non-empty index: stored codes would go stale "
                "under new codebooks — train before the first add()")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        xs = xs if isinstance(xs, torch.Tensor) \
            else torch.from_numpy(np.asarray(xs, np.float32))
        cb = pqmod.train_pq(xs.to(self.device, torch.float32),
                            self.cfg.pq.m, self.cfg.pq.nbits, iters=iters,
                            generator=generator)
        if self._mesh is None:
            self._state = dataclasses.replace(self._state, pq_codebooks=cb)
        else:                       # replicated to every shard
            self._state = type(self._state)([
                dataclasses.replace(sh, pq_codebooks=cb.to(sh.device,
                                                           copy=True))
                for sh in self._state.shards])
        self._pq_trained = True
        return self

    def _require_trained(self) -> None:
        if not self._pq_trained:
            raise RuntimeError(
                "PQ codebooks are untrained: call Index.train(sample) or "
                "construct with pq_codebooks= before adding vectors")

    # -- mutation -----------------------------------------------------------

    def add(self, vecs, ids, *, attrs=None, strict: bool | None = None
            ) -> "MutationReport | PendingReport":
        """Ingest a batch. ``vecs [B, D]``, ``ids [B]`` (-1 rows skipped).

        Re-adding a live id overwrites its payload (delete-then-insert);
        within-batch duplicates keep the last row. A batch that hits
        ``POOL_EXHAUSTED`` / ``CHAIN_OVERFLOW`` is atomic: it inserts
        nothing and every previously-live id keeps its old payload.

        With ``SIVFConfig(attributes=...)``, ``attrs`` is **required**: a
        ``{name: value_or_column}`` dict or a ``[B, n_attrs]`` int array
        (or tensor) in config order, covering every configured attribute.
        Without configured attributes, passing ``attrs`` raises.
        """
        with self._telemetry.span("mutation.dispatch", root="auto",
                                  op="add", epoch=self._epoch + 1):
            return self._add(vecs, ids, attrs, strict)

    def _add(self, vecs, ids, attrs, strict):
        self._require_trained()
        vecs = self._as_batch(vecs, np.float32)
        ids_a = self._as_batch(ids, np.int32, flat=True)
        if vecs.ndim != 2 or vecs.shape[0] != ids_a.shape[0]:
            raise ValueError(
                f"vecs {tuple(vecs.shape)} / ids {tuple(ids_a.shape)} "
                "mismatch")
        if vecs.shape[1] != self.cfg.dim:
            raise ValueError(f"dim {vecs.shape[1]} != cfg.dim {self.cfg.dim}")
        if self.cfg.n_attrs:
            attrs = self._normalize_attrs(attrs, int(ids_a.shape[0]))
        elif attrs is not None:
            raise ValueError(
                "attrs= given but SIVFConfig(attributes=...) is empty")
        bucket = self._bucket(ids_a.shape[0])
        self._sigs["add"].add(bucket)
        pv = self._pad_rows(vecs, bucket)
        pa = self._pad_attrs(attrs, bucket) if self.cfg.n_attrs else None
        if self._tiered is None:
            self._state, aux = self._ops.insert(
                self._state, pv, self._pad_ids(ids_a, bucket), pa)
        else:
            self._state, aux, plan = self._ops.insert(
                self._state, pv, self._pad_ids(ids_a, bucket), pa,
                want_plan=True)
            # the commit plan waits for the host-store replay, with
            # snapshots of the rows (the caller may reuse its buffers)
            self._tiered.queue_plan(
                plan, pv.clone() if pv is vecs else pv,
                None if pa is None
                else (pa.clone() if pa is attrs else pa))
        if self._telemetry.recording:
            self._m_mutations.inc(int(ids_a.shape[0]), op="add")
            self._m_slabs_allocated.inc(aux["slabs_allocated"])
        return self._emit("add", aux, bucket, strict)

    def remove(self, ids, *, strict: bool | None = None
               ) -> "MutationReport | PendingReport":
        """Evict a batch of ids; absent ids count as ``rejected``."""
        with self._telemetry.span("mutation.dispatch", root="auto",
                                  op="remove", epoch=self._epoch + 1):
            ids_a = self._as_batch(ids, np.int32, flat=True)
            bucket = self._bucket(ids_a.shape[0])
            self._sigs["remove"].add(bucket)
            self._state, aux = self._ops.delete(
                self._state, self._pad_ids(ids_a, bucket))
            if self._telemetry.recording:
                self._m_mutations.inc(int(ids_a.shape[0]), op="remove")
            return self._emit("remove", aux, bucket, strict)

    def _emit(self, op: str, aux: dict, bucket: int, strict: bool | None):
        self._epoch += 1          # batch dispatched: the committed prefix
        if self.deferred:         # a later search observes grows by one
            fut = PendingReport(self)
            self._pending.append((fut, op, aux, bucket, strict))
            return fut
        with self._telemetry.span("report"):
            return self._finalize(op, _resolve_aux([aux])[0], bucket,
                                  self.strict if strict is None else strict)

    def _finalize(self, op: str, aux: dict, bucket: int, strict: bool
                  ) -> MutationReport:
        """Build a report from an aux dict already copied to the host (and
        count its reclaimed slabs)."""
        if self._telemetry.recording:
            self._m_slabs_reclaimed.inc(int(aux["n_reclaimed"]))
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
        se = aux.get("shard_errors")
        report = MutationReport(
            op=op, requested=requested, accepted=accepted,
            overwritten=overwritten,
            rejected=max(requested - accepted - overwritten, 0),
            errors=ErrorCode(int(aux["errors"])), n_live=n1,
            padded_to=bucket,
            shard_errors=None if se is None
            else tuple(ErrorCode(int(e)) for e in se))
        if strict and not report.ok:
            raise MutationRejected(report)
        return report

    def flush(self) -> list[MutationReport]:
        """Resolve every outstanding :class:`PendingReport`, oldest first.

        One device->host copy for the whole queue (``_resolve_aux``), a
        mesh's per-shard error vectors included. In strict mode the first failed report raises :class:`MutationRejected`
        after the entire queue has resolved. ``[]`` when nothing is pending.
        """
        pending, self._pending = self._pending, []
        with self._telemetry.span("mutation.flush", root="auto",
                                  batches=len(pending), epoch=self._epoch):
            if self._tiered is not None:  # the host store catches up
                self._tiered.drain_plans()  # where the reports resolve
            reports: list[MutationReport] = []
            first_err: MutationRejected | None = None
            k = 0
            try:
                host_auxes = _resolve_aux([a for _, _, a, _, _ in pending])
                for k, (fut, op, _, bucket, strict) in enumerate(pending):
                    strict = self.strict if strict is None else strict
                    try:
                        rep = self._finalize(op, host_auxes[k], bucket,
                                             strict)
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
        self._note_compiles()
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
               filter=None, _prefetched=None) -> SearchResult:
        """Top-k search; ``nprobe=None`` probes every list (exact recall).

        ``filter`` is a ``core.filters`` predicate (``Eq`` / ``In`` /
        ``Range`` / ``And``) over the configured attributes, or an already
        compiled ``CompiledFilter``. Only rows that match it can appear in
        the result: failing slots mask to ``inf`` / ``-1`` inside the
        scan, before the top-k, so they never displace passing rows.

        On a tiered index the search plans, prefetches its probed slabs
        and scans the frames; a valid ``_prefetched`` ticket
        (:meth:`prefetch`) skips the first two stages, a stale one falls
        back to them.
        """
        with self._telemetry.span("index.search", root="auto",
                                  epoch=self._epoch) as span:
            return self._search(span, queries, k, nprobe, filter,
                                _prefetched)

    def _search(self, span, queries, k, nprobe, filter, ticket
                ) -> SearchResult:
        queries = self._as_batch(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        if queries.shape[1] != self.cfg.dim:
            raise ValueError(
                f"dim {queries.shape[1]} != cfg.dim {self.cfg.dim}")
        fstruct = fconsts = None
        if filter is not None:
            if not self.cfg.n_attrs:
                raise ValueError(
                    "filtered search needs SIVFConfig(attributes=...)")
            cf = filter if isinstance(filter, flt.CompiledFilter) \
                else flt.compile_filter(filter, self.cfg.attributes)
            fstruct = cf.structure
            fconsts = torch.tensor(cf.consts, dtype=torch.int32,
                                   device=self.device)
            if isinstance(span, Span):   # formatted only when it records
                span.attrs["filter"] = str(fstruct)
        nprobe = self.cfg.n_lists if nprobe is None \
            else min(int(nprobe), self.cfg.n_lists)
        q = queries.shape[0]
        bucket = self._bucket(q)
        padded = self._pad_rows(queries, bucket)
        if self._tiered is not None:
            d, lab = self._tiered.search(
                self._state, padded, int(k), nprobe, fstruct, fconsts,
                epoch=self._epoch, ticket=ticket)
        else:
            self._sigs["search"].add((bucket, int(k), nprobe, fstruct))
            d, lab = self._ops.search(self._state, padded, int(k),
                                      nprobe, fstruct, fconsts)
        self._note_compiles()
        return SearchResult(distances=d[:q], labels=lab[:q], k=int(k),
                            nprobe=nprobe, padded_to=bucket)

    def prefetch(self, queries, nprobe: int | None = None):
        """Stage the slabs a coming query batch will probe (tiered only).

        Runs the plan + prefetch stages of the tiered search and returns
        a ticket for ``search(..., _prefetched=ticket)``. The ticket is
        valid until the next prefetch or mutation; a stale ticket is
        safe, merely not used. Returns ``None`` on an untiered handle.
        """
        if self._tiered is None:
            return None
        queries = self._as_batch(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        nprobe = self.cfg.n_lists if nprobe is None \
            else min(int(nprobe), self.cfg.n_lists)
        padded = self._pad_rows(queries, self._bucket(queries.shape[0]))
        table = self._tiered.plan(self._state, padded, nprobe)
        return self._tiered.prefetch(table, nprobe, self._epoch)

    # -- maintenance --------------------------------------------------------

    def maintain(self, ops=None, *, max_ops: int = 2,
                 strict: bool | None = None) -> list:
        """Run maintenance ops (``core/maintenance.py``).

        ``ops`` is a list of :class:`~repro_torch.core.maintenance.MaintOp`
        (``split`` / ``merge`` / ``recluster``); omitted, the drift policy
        plans up to ``max_ops`` ops from ``stats()["list_occupancy"]``,
        round-robining re-clustering across sweeps. Each op commits
        atomically through the staged insert (on a mesh every shard
        reverts if any would abort), so a failed op leaves every live id
        searchable under the old layout and bumps no epoch; a committed
        op bumps :attr:`epoch` like a mutation batch. On a
        tiered index the queued plans drain before the gather, whose
        payloads come from the host store, and the commit's plan is
        replayed into it after.

        Returns the per-op ``MaintenanceReport`` list. In strict mode an
        aborted op raises :class:`MaintenanceAborted` after every op has
        resolved. Each op's host milliseconds (``gather``, ``plan``,
        ``commit``) are left in :attr:`last_maintain_ms`; each op is a
        ``maintenance.op`` span, and ``sivf_maintenance_ops_total`` /
        ``sivf_maintenance_rows_total`` count the ops and moved rows.
        """
        from repro_torch.core import maintenance as mt
        self._require_trained()
        if self._tiered is not None:
            self._tiered.drain_plans()      # host store current pre-gather
        if ops is None:
            occ = self.stats()["list_occupancy"]
            ops, self._maint_cursor = mt.plan_ops(
                occ, self._maint_cursor, max_ops=max_ops)
        strict = self.strict if strict is None else strict
        stores = None if self._tiered is None else self._tiered.stores
        want_plan = self._tiered is not None
        reports: list = []
        self.last_maintain_ms = []
        first_abort = None
        for op in ops:
            with self._telemetry.span("maintenance.op", root="auto",
                                      kind=op.kind, lists=list(op.lists),
                                      epoch=self._epoch + 1):
                t0 = time.perf_counter()
                views = mt.shard_views(self.cfg, self._state, stores)
                gathered = mt.gather_live(self.cfg, self._state, views,
                                          op.lists)
                t1 = time.perf_counter()
                # shard 0's replica on a mesh (every shard holds the same)
                cents = (self._state if self._mesh is None
                         else self._state[0]).centroids
                plan = mt.plan_op(self.cfg, op, gathered,
                                  cents.cpu().numpy())
                t2 = time.perf_counter()
                times = {"gather": (t1 - t0) * 1e3,
                         "plan": (t2 - t1) * 1e3, "commit": 0.0}
                self.last_maintain_ms.append(times)
                if plan is None:            # nothing to move: host no-op
                    reports.append(mt.MaintenanceReport(
                        op.kind, op.lists, len(gathered["ids"]), True, 0,
                        self.n_live))
                    continue
                new_cents, lists = plan
                batch = mt.pad_batch(
                    self.cfg, gathered, lists,
                    mt.maint_batch_size(self.cfg, self.n_shards))
                if self._mesh is None:
                    out = mt._commit_op(self.cfg, self._state, new_cents,
                                        batch, want_plan)
                else:
                    out = mt._commit_op_mesh(self.cfg, self._mesh,
                                             self._axis, self._state,
                                             new_cents, batch, want_plan)
                self._state, aux = out[0], mt.read_aux(out[1])
                committed = bool(aux["committed"])
                if want_plan and committed:
                    self._tiered.queue_plan(
                        out[2], batch["vecs"],
                        batch["attrs"] if self.cfg.n_attrs else None)
                    self._tiered.drain_plans()
                times["commit"] = (time.perf_counter() - t2) * 1e3
                rep = mt.MaintenanceReport(op.kind, op.lists, batch["rows"],
                                           committed, int(aux["errors"]),
                                           int(aux["n_live"]))
            if committed:
                self._epoch += 1            # a new committed prefix entry
                if self._telemetry.recording:
                    self._m_maint_rows.inc(rep.rows)
            elif first_abort is None:
                first_abort = rep
            if self._telemetry.recording:
                self._m_maint.inc(1, kind=op.kind,
                                  outcome="committed" if committed
                                  else "aborted")
            reports.append(rep)
        self._note_compiles()
        if strict and first_abort is not None:
            raise MaintenanceAborted(first_abort)
        return reports

    # -- persistence --------------------------------------------------------

    _META = "index"

    def save(self, path) -> None:
        """Persist the index in the reference's checkpoint format 3
        (``checkpoint/manager.py``: atomic, checksummed): one array per
        plane in ``PLANES`` order with the reference's dtypes (on a mesh
        each stacked ``[S, ...]``), and the ``index.json`` sidecar with the
        backend, the shard count and the routing rule (``id % n_shards``).
        A tiered index saves its assembled full pool, the same arrays an
        untiered one would."""
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(path, keep_last=1)
        n = self.n_shards
        mgr.save_metadata(self._META, {
            "format": 3,
            "pq_trained": self._pq_trained,
            "backend": self.backend,
            "n_shards": n,
            # self-describing shard routing: a loader re-routes rows onto
            # another shard count knowing only the sidecar
            "routing": {"rule": "mod", "n_shards": n, "axis": self._axis},
            "axis": self._axis,
            # the reference's defaults: the port has no impl or block_q
            "impl": "xla",
            "block_q": 8,
            "use_tables": self._use_tables,
            "strict": self.strict,
            "min_bucket": self.min_bucket,
            "deferred": self.deferred,
            "cfg": interop.config_to_dict(self.cfg),
        })
        if self._tiered is not None:
            self._tiered.drain_plans()
            planes = trt.assemble_full(self.cfg, self._state,
                                       self._tiered.store) \
                if self._mesh is None else trt.assemble_full_mesh(
                    self.cfg, self._state, self._tiered.stores)
        elif self._mesh is not None:
            planes = self._state.stacked_numpy()
        else:
            planes = interop.state_to_numpy(self._state)
        mgr.save(0, [planes[name] for name in PLANES])

    @classmethod
    def load(cls, path, backend=None, **overrides) -> "Index":
        """Rebuild a handle from :meth:`save` output, the reference's
        included (formats 1-3; the planes a format-1 or -2 checkpoint
        lacks fill fresh), onto *any* backend.

        Loading is elastic: a checkpoint saved on S shards loads onto S'
        shards or ``"single"``. When the target's topology matches the
        checkpoint's, the planes go onto their devices directly; otherwise
        they are flattened to the canonical live-row table and re-routed
        by ``id % S'`` (``core.distributed.reshard_state``): searches
        return the same ids and distances either way, and later inserts
        land on the owning shard.

        ``backend`` is a ``ShardMesh`` or ``"single"``; a single-device
        checkpoint defaults to ``"single"``, a sharded one needs it given.
        ``device`` (``"cuda"`` unless given in ``overrides``) places a
        single target; a mesh brings its devices. A tiered target
        (``device_slabs=`` here, or in the saved config) puts only the
        metadata on the device. Other ``overrides`` replace saved handle
        options (``strict``, ``min_bucket``, ``axis``, ...); the sidecar's
        ``impl`` and ``block_q`` are ignored."""
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(path)
        meta = mgr.load_metadata(cls._META)
        cfg = interop.config_from_dict(meta["cfg"])
        if "device_slabs" in overrides:     # retier on load
            cfg = dataclasses.replace(
                cfg, device_slabs=overrides.pop("device_slabs"))
        kw = {"axis": meta.get("axis", "data"),
              "use_tables": meta["use_tables"], "strict": meta["strict"],
              "min_bucket": meta["min_bucket"],
              "deferred": meta.get("deferred", False)}
        kw.update(overrides)
        src_kind = meta.get("backend", "single")
        src_shards = int(meta.get("n_shards", 1))
        # checkpoints older than the routing field used the same mod rule
        rule = meta.get("routing", {}).get("rule", "mod")
        if rule != "mod":
            raise ValueError(
                f"checkpoint uses unknown shard-routing rule {rule!r}; "
                f"this build can only re-route 'mod' checkpoints")
        if backend is None:
            if src_kind == "mesh":
                raise ValueError(
                    "sharded checkpoint: pass backend= — the target mesh, "
                    "or 'single' to collapse the shards onto one device")
            backend = "single"
        tgt_kind, n_to = _resolve_backend(backend, kw["axis"])
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps under {path}")
        out = mgr.restore_arrays(step)
        # older formats lack trailing planes, filled fresh: format 1
        # ``codes`` / ``pq_codebooks`` / ``attrs``, format 2 ``attrs``
        n_miss = {1: 3, 2: 1}.get(int(meta.get("format", 1)), 0)
        ns, c = cfg.n_slabs, cfg.capacity
        lead = (src_shards,) if src_kind == "mesh" else ()
        fresh = {"codes": np.zeros(lead + (ns, c, cfg.code_m), np.uint8),
                 "pq_codebooks": np.zeros(lead + cfg.codebook_shape,
                                          np.float32),
                 "attrs": np.zeros(lead + (ns, c, cfg.n_attrs), np.int32)}
        out += [fresh[name] for name in PLANES[len(PLANES) - n_miss:]]
        if len(out) != len(PLANES):
            raise ValueError(f"checkpoint stored {len(out)} leaves but the "
                             f"state needs {len(PLANES)}")
        planes = dict(zip(PLANES, out))
        want = lead + (ns, c)
        if planes["ids"].shape != want:
            raise ValueError(
                f"checkpoint ids plane is {planes['ids'].shape} but a "
                f"{src_shards}-shard {src_kind} state of this config "
                f"needs {want}")
        state = planes
        if not (tgt_kind == src_kind and n_to == src_shards):
            # elastic reshard: host planes -> live-row table -> target;
            # a tiered target is rebuilt on the host and split after
            if cfg.tiered:
                devices = "cpu"
            elif tgt_kind == "mesh":
                devices = backend.devices
            else:
                devices = resolve_device(kw.get("device") or "cuda")
            state = dist.reshard_state(
                dataclasses.replace(cfg, device_slabs=None), planes,
                src_shards, n_to, stack=tgt_kind == "mesh", device=devices)
        return cls(cfg, None, backend=backend, _state=state,
                   _pq_trained=meta.get("pq_trained", True), **kw)

    # -- elastic resharding -------------------------------------------------

    def reshard(self, backend="single", *, axis: str | None = None
                ) -> "Index":
        """Remap this *live* handle onto a new backend in place.

        ``backend`` is a ``ShardMesh`` (any shard count) or ``"single"``.
        Pending deferred reports are flushed first (their counts refer to
        the old topology); then the slab pools flatten to the canonical
        live-row table, re-route by ``id % S'`` and rebuild on the target
        (``core.distributed.reshard_state``, the path :meth:`load` takes),
        so searches return the same ids and distances before and after
        and later mutations land on the owning shard. A tiered handle
        keeps its cache counters. Returns ``self``.
        """
        with self._telemetry.span("reshard", root="auto",
                                  n_from=self.n_shards):
            return self._reshard_impl(backend, axis)

    def _reshard_impl(self, backend, axis):
        self.flush()
        axis = self._axis if axis is None else axis
        tgt_kind, n_to = _resolve_backend(backend, axis)
        if tgt_kind == "mesh":
            for d in set(backend.devices):
                resolve_device(d)
        if self._tiered is not None:
            # the assembled full pool, resharded under the untiered twin
            # config on the host, then split into stores + meta again
            self._tiered.drain_plans()
            src = trt.assemble_full(self.cfg, self._state,
                                    self._tiered.store) \
                if self._mesh is None else trt.assemble_full_mesh(
                    self.cfg, self._state, self._tiered.stores)
            cfg_r, devices = dataclasses.replace(self.cfg,
                                                 device_slabs=None), "cpu"
        else:
            src, cfg_r = self._state, self.cfg
            devices = backend.devices if tgt_kind == "mesh" else self.device
        state = dist.reshard_state(cfg_r, src, self.n_shards, n_to,
                                   stack=tgt_kind == "mesh", device=devices)
        if self._tiered is not None:
            pin = self.device.type == "cuda"
            if tgt_kind == "mesh":
                meta, stores = trt.split_full_mesh(self.cfg, state, pin)
                state = dist.place_sharded(self.cfg, meta, backend, axis)
                rt = trt.MeshTieredRuntime(
                    self.cfg, backend.devices, self._use_tables, stores,
                    telemetry=self._telemetry)
            else:
                meta, store = trt.split_full(self.cfg, state, pin)
                state = interop.state_from_numpy(self.cfg, meta, self.device)
                rt = trt.TieredRuntime(
                    self.cfg, self.device, self._use_tables, store,
                    telemetry=self._telemetry)
            # the cache counters (and their window marks) carry over
            self._tiered = rt.carry_from(self._tiered)
        if tgt_kind == "mesh":
            self._ops = _MeshOps(self.cfg, backend, axis, self._use_tables)
            self._mesh = backend
            self.device = backend.devices[0]
        else:
            self._ops = _SingleOps(self.cfg, self._use_tables,
                                   self._telemetry)
            self._mesh = None
        self._axis = axis
        self._state = state
        return self


def _check_mesh_device(mesh, device) -> None:
    """An explicit ``device=`` must agree with every device of ``mesh``."""
    if device is None:
        return
    dev = torch.device(device)
    for d in mesh.devices:
        if d.type != dev.type or (dev.index is not None
                                  and d.index != dev.index):
            raise ValueError(
                f"device={str(dev)!r} disagrees with the mesh's devices "
                f"{[str(x) for x in mesh.devices]}; a mesh index lives on "
                f"its mesh's devices (omit device=)")
