"""Tiered slab pool: host-resident cold store + on-device hot slab cache.

PyTorch counterpart of ``repro/core/tiered.py``, on one device
(:class:`TieredRuntime`) or a mesh of shards (:class:`MeshTieredRuntime`:
one host store, residency and frame cache per shard).

  * **Host store** (:class:`HostStore`) — the canonical payload planes
    (``data`` / ``codes`` / ``attrs``), sized by the full ``cfg.n_slabs``
    pool, as numpy arrays; on a CUDA index they live in pinned host
    memory. All slab *metadata* (ids, norms, bitmaps, chains, ATT,
    tables) stays on the device, so deletes, occupancy and chains never
    need host mirroring.
  * **Device cache** (:class:`SlabCacheDev`) — ``cfg.device_slabs`` cache
    frames of the same per-slab payload width, plus the residency map
    ``frame_of`` (slab -> frame, -1 cold) and its inverse
    ``slab_of_frame``. Host twins of both, with per-frame LRU ticks and a
    dirty set (:class:`_Residency`), drive the replacement policy without
    a device read.

A search is three stages (:class:`TieredRuntime`):

  1. *plan* — coarse probe + slab-table gather, the all-resident search's
     prefix, giving the pool-slab-id table ``[Q, T]``;
  2. *prefetch* — the table's per-slab reference counts are summed on the
     device and read to the host in one copy (the reference reads the
     table itself; the counts give the same dedupe, refs and unique
     slabs, in ``n_slabs + 1`` words whatever ``Q x T``); LRU eviction
     of victim frames; and, only when slabs are missing or dirty, one
     packed host-to-device copy: the slabs' rows gathered into a pinned
     staging buffer (one block a payload plane), copied once with
     ``non_blocking=True`` and written into their frames by one
     ``index_copy_`` a plane. A warm cache copies nothing to the device;
  3. *scan* — the table rewritten into frame coordinates
     (``kernels.sivf_scan.ops.translate_table``), per-frame metadata
     gathered fresh from the device planes (:func:`cache_view`), and the
     unmodified scan dispatch: kernels 1 and 2 see a pool of
     ``device_slabs`` frames and a translated table. They order
     candidates by (distance, t, slot), never by slab id, so results are
     ``==`` the all-resident pool's whenever the probed set fits.

**Inserts** stay atomic across both tiers: the device commit
(``core.index._insert_impl(want_plan=True)``) emits a plan, the (slab,
slot) written for each input row (-1 where nothing was written, the whole
batch on an abort) and the encoded PQ codes. The host store replays
those writes when the queued plans drain (in one device read, at the next
prefetch / flush / save / maintain), and each written slab turns dirty
so a resident frame re-uploads before the next scan reads it. **Deletes**
touch metadata only and need no host action.

Each stage is a span (``plan``, ``prefetch``, ``scan``) of the handle's
``repro_torch.obs.Telemetry``; ``sivf_tiered_cache_events_total{event}``
counts the prefetch's hits, misses, evictions, uploads, dirty refreshes
and deduped references (the same counts :meth:`TieredRuntime.stats`
reads), and ``sivf_transfer_bytes_total{direction,stage}`` the bytes of
its explicit copies.

Residency is runtime-only state: checkpoints store the assembled
full-pool planes (:func:`assemble_full`), so a tiered save writes the
same arrays as an untiered one.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import index as ix
from repro_torch.core import quantizer
from repro_torch.core.state import PLANES, SIVFConfig, SlabPoolState
from repro_torch.kernels.sivf_scan.ops import translate_table
from repro_torch.obs.metrics import WindowedCounter

PAYLOAD_PLANES = ("data", "codes", "attrs")


# ---------------------------------------------------------------------------
# Tier state containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SlabCacheDev:
    """Device-resident hot-cache planes + residency map."""

    data: torch.Tensor           # [F, C, payload_dim] cached payload rows
    codes: torch.Tensor          # [F, C, code_m] uint8 cached PQ codes
    attrs: torch.Tensor          # [F, C, n_attrs] int32 attribute stamps
    frame_of: torch.Tensor       # [n_slabs] int32 slab -> frame (-1 = cold)
    slab_of_frame: torch.Tensor  # [F] int32 frame -> slab (-1 = empty)


def init_cache(cfg: SIVFConfig, device) -> SlabCacheDev:
    """Empty cache: every frame free, every slab cold."""
    f, c = cfg.device_slabs, cfg.capacity
    return SlabCacheDev(
        data=torch.zeros((f, c, cfg.payload_dim), dtype=cfg.dtype,
                         device=device),
        codes=torch.zeros((f, c, cfg.code_m), dtype=torch.uint8,
                          device=device),
        attrs=torch.zeros((f, c, cfg.n_attrs), dtype=torch.int32,
                          device=device),
        frame_of=torch.full((cfg.n_slabs,), -1, dtype=torch.int32,
                            device=device),
        slab_of_frame=torch.full((f,), -1, dtype=torch.int32,
                                 device=device))


def _host_array(shape, np_dtype, pin: bool, fill=None) -> np.ndarray:
    """A zeroed (or ``fill``-ed) host array, in pinned memory if ``pin``."""
    if not pin:
        return np.zeros(shape, np_dtype) if fill is None \
            else np.array(fill, np_dtype, copy=True)
    t = torch.empty(shape, dtype=getattr(torch, np.dtype(np_dtype).name),
                    pin_memory=True)
    a = t.numpy()
    if fill is None:
        a.fill(0)
    else:
        np.copyto(a, fill)
    return a


class HostStore:
    """The canonical host-side payload planes (numpy; pinned on CUDA)."""

    __slots__ = PAYLOAD_PLANES

    def __init__(self, data: np.ndarray, codes: np.ndarray,
                 attrs: np.ndarray):
        self.data = data        # [n_slabs, C, payload_dim]
        self.codes = codes      # [n_slabs, C, code_m] uint8
        self.attrs = attrs      # [n_slabs, C, n_attrs] int32

    @classmethod
    def build(cls, cfg: SIVFConfig, pin: bool, planes: dict | None = None
              ) -> "HostStore":
        """Empty planes, or a copy of ``planes`` (``{name: array}``)."""
        ns, c = cfg.n_slabs, cfg.capacity
        shapes = {"data": ((ns, c, cfg.payload_dim), np.float32),
                  "codes": ((ns, c, cfg.code_m), np.uint8),
                  "attrs": ((ns, c, cfg.n_attrs), np.int32)}
        return cls(**{name: _host_array(
            shape, dt, pin, None if planes is None else planes[name])
            for name, (shape, dt) in shapes.items()})


class _Residency:
    """Host-side residency bookkeeping (LRU ticks + dirty set)."""

    def __init__(self, cfg: SIVFConfig):
        self.frame_of = np.full((cfg.n_slabs,), -1, np.int32)
        self.slab_of_frame = np.full((cfg.device_slabs,), -1, np.int32)
        self.tick = np.zeros((cfg.device_slabs,), np.int64)
        self.clock = 0
        self.dirty: set[int] = set()

    @property
    def resident_slabs(self) -> int:
        return int((self.slab_of_frame >= 0).sum())


@dataclasses.dataclass(frozen=True)
class PrefetchTicket:
    """Proof that a query batch's probed slabs are resident.

    Valid only while nothing else has prefetched (``seq``) or mutated the
    index (``epoch``) since; a stale ticket falls back to the full path.
    """

    table: torch.Tensor       # [Q, T] pool-slab-id table
    nprobe: int
    padded_q: int             # query bucket the table was planned for
    seq: int                  # runtime prefetch sequence number at issue
    epoch: int                # Index.epoch at issue


def cache_view(cfg: SIVFConfig, state: SlabPoolState, cache: SlabCacheDev
               ) -> SlabPoolState:
    """Frame-indexed view of the pool for the unmodified scan dispatch.

    Payload planes are the cache frames; per-frame metadata (ids, norms,
    validity bitmaps) is gathered fresh from the device planes through
    ``slab_of_frame``, so deletes and overwrites show in the next scan
    with no invalidation. Empty frames read as dead (bitmap 0, ids -1).
    """
    sof = cache.slab_of_frame.clamp(min=0).long()
    has = (cache.slab_of_frame >= 0)[:, None]
    return dataclasses.replace(
        state, data=cache.data, codes=cache.codes, attrs=cache.attrs,
        ids=torch.where(has, state.ids[sof], -1),
        norms=state.norms[sof],
        bitmap=torch.where(has, state.bitmap[sof], 0))


# ---------------------------------------------------------------------------
# Full-state split / assemble (checkpoint interop)
# ---------------------------------------------------------------------------

def is_full_state(cfg: SIVFConfig, state) -> bool:
    """True when ``state`` (a ``SlabPoolState``, a mesh's
    ``ShardedState``, or ``{plane: array}``, stacked or not) carries
    full-width payload planes, not a tiered meta state's zero-width
    ones."""
    if isinstance(state, dict):
        data = state["data"]
    elif hasattr(state, "shards"):
        data = state.shards[0].data
    else:
        data = state.data
    return data.shape[-3] == cfg.n_slabs


def _host_planes(state) -> dict:
    """``{plane: np.ndarray}`` of a state or plane dict (bitmap uint32)."""
    if isinstance(state, dict):
        return {name: np.asarray(state[name]) for name in PLANES}
    return interop.state_to_numpy(state)


def split_full(cfg: SIVFConfig, full, pin: bool = False
               ) -> tuple[dict, HostStore]:
    """Full-pool state -> (``{plane: array}`` with zero-width payload
    planes, the host store holding the payload planes)."""
    planes = _host_planes(full)
    store = HostStore.build(cfg, pin, planes)
    c = cfg.capacity
    meta = dict(planes)
    meta.update(data=np.zeros((0, c, cfg.payload_dim), np.float32),
                codes=np.zeros((0, c, cfg.code_m), np.uint8),
                attrs=np.zeros((0, c, cfg.n_attrs), np.int32))
    return meta, store


def split_full_mesh(cfg: SIVFConfig, full, pin: bool = False
                    ) -> tuple[dict, list[HostStore]]:
    """A mesh's full pools (a ``ShardedState`` or stacked ``{plane:
    array}``) -> (stacked ``{plane: array}`` with zero-width payload
    planes, one host store per shard)."""
    planes = full.stacked_numpy() if hasattr(full, "stacked_numpy") \
        else {name: np.asarray(full[name]) for name in PLANES}
    metas, stores = [], []
    for s in range(planes["ids"].shape[0]):
        meta, store = split_full(cfg, {k: v[s] for k, v in planes.items()},
                                 pin)
        metas.append(meta)
        stores.append(store)
    return {name: np.stack([m[name] for m in metas]) for name in PLANES}, \
        stores


def assemble_full_mesh(cfg: SIVFConfig, meta, stores: list[HostStore]
                       ) -> dict:
    """:func:`assemble_full` of each shard of a mesh's meta state, stacked
    ``[S, ...]``: what a mesh checkpoint stores."""
    per = [assemble_full(cfg, sh, st) for sh, st in zip(meta.shards, stores)]
    return {name: np.stack([p[name] for p in per]) for name in PLANES}


def _plans_to_host(plans: list) -> tuple[list, bool]:
    """Queued plans as numpy, every device tensor among them copied in ONE
    device-to-host transfer; and whether there was one to copy."""
    keys = ("slab", "slot", "codes", "vecs", "attrs")
    dev = [(i, k, plans[i][k]) for i in range(len(plans)) for k in keys
           if isinstance(plans[i][k], torch.Tensor)
           and plans[i][k].device.type != "cpu"]
    dev.sort(key=lambda e: -e[2].element_size())   # aligned dtype views
    if dev:
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                          for _, _, t in dev]).cpu()
        off = 0
        for i, k, t in dev:
            n = t.numel() * t.element_size()
            plans[i][k] = flat[off:off + n].view(t.dtype).reshape(t.shape)
            off += n
    return [{k: None if p[k] is None else np.asarray(
        p[k].numpy() if isinstance(p[k], torch.Tensor) else p[k])
        for k in keys} for p in plans], bool(dev)


def _slab_counts(cfg: SIVFConfig, table: torch.Tensor) -> torch.Tensor:
    """Per-slab reference counts of a slab table, on its device."""
    ns = cfg.n_slabs
    flat = table.reshape(-1)
    idx = torch.where(flat >= 0, flat, ns).long()
    counts = torch.zeros((ns + 1,), dtype=torch.int32, device=table.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts[:ns]


def assemble_full(cfg: SIVFConfig, meta: SlabPoolState, store: HostStore
                  ) -> dict:
    """(meta state, host store) -> ``{plane: array}`` of the full pool on
    the host, the payload planes being the canonical host bytes: what a
    checkpoint stores, byte-identical to what an all-resident pool
    holds."""
    host = interop.state_to_numpy(meta)
    host.update(data=store.data, codes=store.codes, attrs=store.attrs)
    return host


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------

class TieredRuntime:
    """Per-handle orchestration of the host store + device cache.

    Owned by ``sivf_torch.Index`` when ``cfg.device_slabs`` is set;
    runtime-only (never checkpointed). ``h2d_copies`` counts the packed
    host-to-device copies (one per prefetch with misses or dirty slabs),
    ``d2h_reads`` the device reads (one per prefetch, one per drain of
    queued plans). ``compile_stats`` counts the plan and scan launch
    signatures, as ``Index.compile_stats`` does the untiered search's.
    """

    _COUNTERS = ("hits", "misses", "refs", "unique_refs", "uploads",
                 "evictions")

    def __init__(self, cfg: SIVFConfig, device, use_tables: bool | None = None,
                 store: HostStore | None = None, telemetry=None):
        if not cfg.tiered:
            raise ValueError("TieredRuntime needs SIVFConfig(device_slabs=)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.shard = 0                   # its place on a mesh (messages)
        self.use_tables = use_tables
        self.pin = self.device.type == "cuda"
        self.store = store or HostStore.build(cfg, self.pin)
        self.res = _Residency(cfg)
        self.cache = init_cache(cfg, self.device)
        self._plans: list[dict] = []     # queued insert plans
        self.seq = 0                     # prefetch sequence number
        self.hits = WindowedCounter()        # resident probed slabs
        self.misses = WindowedCounter()      # uploaded-on-demand slabs
        self.refs = WindowedCounter()        # table refs (pre-dedupe)
        self.unique_refs = WindowedCounter()  # post-dedupe references
        self.uploads = WindowedCounter()     # slabs uploaded (miss + dirty)
        self.evictions = WindowedCounter()   # occupied frames recycled
        self.last_prefetch: dict = {}
        self.h2d_copies = 0
        self.h2d_bytes = 0
        self.d2h_reads = 0
        self.last_upload: dict = {}
        self._staging: torch.Tensor | None = None   # pinned, grown on demand
        self._staged = None      # CUDA event: the staging buffer's last copy
        self._plan_sigs: set = set()     # (bucket, nprobe)
        self._scan_sigs: set = set()     # (bucket, table width, k, fstruct)
        if telemetry is None:
            from repro_torch import obs
            telemetry = obs.default()
        self.tel = telemetry
        self._m_cache = telemetry.counter(
            "sivf_tiered_cache_events_total",
            "tiered-cache events: hit/miss/eviction/upload/dirty_refresh/"
            "dedup_saved (probed-slab granularity)", ("event",))
        self._m_bytes = telemetry.counter(
            "sivf_transfer_bytes_total",
            "explicit host<->device transfer bytes by direction and stage",
            ("direction", "stage"))
        c = cfg.capacity
        # a slab's bytes in each payload plane, in staging order: the
        # 4-byte planes first, so that every block starts 4-byte aligned
        self._parts = (("data", c * cfg.payload_dim * 4, torch.float32,
                        (c, cfg.payload_dim)),
                       ("attrs", c * cfg.n_attrs * 4, torch.int32,
                        (c, cfg.n_attrs)),
                       ("codes", c * cfg.code_m, torch.uint8,
                        (c, cfg.code_m)))
        self.slab_bytes = sum(p[1] for p in self._parts)

    @property
    def stores(self) -> list[HostStore]:
        """The host stores, one per shard (the reference's shape)."""
        return [self.store]

    # -- insert-plan pipeline ----------------------------------------------

    def queue_plan(self, plan: dict, vecs, attrs) -> None:
        """Queue one committed batch's host-store writes. ``vecs`` /
        ``attrs`` are the batch's rows in input order, numpy or tensors
        (snapshots: the caller may reuse its buffers)."""
        self._plans.append({
            "slab": plan["slab"], "slot": plan["slot"],
            "codes": plan["codes"],
            "vecs": None if self.cfg.payload_dim == 0 else vecs,
            "attrs": attrs if self.cfg.n_attrs else None})

    def drain_plans(self) -> None:
        """Apply every queued plan to the host store: the plans' device
        tensors cross in one device-to-host copy."""
        if not self._plans:
            return
        plans, self._plans = self._plans, []
        host, copied = _plans_to_host(plans)
        self.d2h_reads += copied
        for p in host:
            self._apply_plan(p)

    def _apply_plan(self, p: dict) -> None:
        slab, slot = p["slab"], p["slot"]
        rows = np.flatnonzero(slab >= 0)
        if rows.size == 0:
            return
        ts, to = slab[rows], slot[rows]
        st, cfg = self.store, self.cfg
        if cfg.payload_dim:
            st.data[ts, to] = p["vecs"][rows, :cfg.payload_dim]
        if cfg.code_m:
            st.codes[ts, to] = p["codes"][rows]
        if cfg.n_attrs:
            st.attrs[ts, to] = p["attrs"][rows]
        self.res.dirty.update(int(x) for x in np.unique(ts))

    # -- the three search stages -------------------------------------------

    def plan(self, state: SlabPoolState, queries: torch.Tensor, nprobe: int
             ) -> torch.Tensor:
        """Stage 1: probe lists -> pool slab-id table ``[Q, T]``."""
        self._plan_sigs.add((int(queries.shape[0]), nprobe))
        with self.tel.span("plan"):
            return self._table(state, queries, nprobe)

    def _table(self, state: SlabPoolState, queries: torch.Tensor,
               nprobe: int) -> torch.Tensor:
        cfg = self.cfg
        ut = cfg.track_tables if self.use_tables is None else self.use_tables
        lists = quantizer.probe(state.centroids, queries.to(cfg.dtype),
                                nprobe, cfg.metric)
        return (ix.gather_tables if ut else ix.walk_chains)(cfg, state, lists)

    def prefetch(self, table: torch.Tensor, nprobe: int, epoch: int
                 ) -> PrefetchTicket:
        """Stage 2: make every probed slab resident.

        One device read of the table's per-slab reference counts; dedupe,
        evict and, only when slabs are missing or dirty, one packed
        host-to-device copy. A warm cache copies nothing to the device.
        """
        with self.tel.span("prefetch"):
            self.drain_plans()
            counts = _slab_counts(self.cfg, table).cpu().numpy()
            self.d2h_reads += 1
            stats = {"refs": 0, "unique": 0, "hits": 0, "misses": 0,
                     "dirty_refresh": 0, "uploaded": 0, "evicted": 0}
            frames, slabs = self._prefetch_slabs(counts, stats)
            stats["dedup_saved"] = stats["refs"] - stats["unique"]
            self.last_prefetch = stats
            self.seq += 1
            if frames:
                self._upload(np.asarray(frames, np.int32),
                             np.asarray(slabs, np.int32))
            if self.tel.recording:
                m = self._m_cache
                m.inc(stats["hits"], event="hit")
                m.inc(stats["misses"], event="miss")
                m.inc(stats["evicted"], event="eviction")
                m.inc(stats["uploaded"], event="upload")
                m.inc(stats["dirty_refresh"], event="dirty_refresh")
                m.inc(stats["dedup_saved"], event="dedup_saved")
                self._m_bytes.inc(counts.nbytes, direction="d2h",
                                  stage="prefetch")
        return PrefetchTicket(table=table, nprobe=nprobe,
                              padded_q=int(table.shape[0]), seq=self.seq,
                              epoch=epoch)

    def _prefetch_slabs(self, counts: np.ndarray, stats: dict
                        ) -> tuple[list[int], list[int]]:
        """LRU bookkeeping (the reference's, decision for decision) ->
        (upload frames, upload slabs)."""
        res = self.res
        uniq = np.flatnonzero(counts > 0).astype(np.int32)
        n_refs = int(counts.sum())
        stats["refs"] += n_refs
        stats["unique"] += int(uniq.size)
        self.refs.add(n_refs)
        self.unique_refs.add(int(uniq.size))
        f_cap = self.cfg.device_slabs
        if uniq.size > f_cap:
            raise ValueError(
                f"query batch probes {uniq.size} distinct slabs on shard "
                f"{self.shard} but device_slabs={f_cap}: the hot cache "
                f"cannot hold one batch's working set — raise "
                f"device_slabs, lower nprobe, or shrink the query batch")
        frame = res.frame_of[uniq]
        hit_slabs = uniq[frame >= 0]
        miss_slabs = uniq[frame < 0]
        dirty_hits = np.array(
            [sl for sl in hit_slabs if int(sl) in res.dirty]
            if res.dirty else [], np.int32)
        stats["hits"] += int(hit_slabs.size)
        stats["misses"] += int(miss_slabs.size)
        stats["dirty_refresh"] += int(dirty_hits.size)
        self.hits.add(int(hit_slabs.size))
        self.misses.add(int(miss_slabs.size))
        res.clock += 1
        res.tick[res.frame_of[hit_slabs]] = res.clock
        up_frames: list[int] = []
        up_slabs: list[int] = []
        if miss_slabs.size:
            needed = np.zeros((self.cfg.n_slabs,), bool)
            needed[uniq] = True
            free = np.flatnonzero(res.slab_of_frame < 0)
            occ = np.flatnonzero(res.slab_of_frame >= 0)
            evictable = occ[~needed[res.slab_of_frame[occ]]]
            evictable = evictable[np.argsort(res.tick[evictable],
                                             kind="stable")]
            victims = np.concatenate([free, evictable])[:miss_slabs.size]
            for fr, sl in zip(victims, miss_slabs):
                old = int(res.slab_of_frame[fr])
                if old >= 0:
                    res.frame_of[old] = -1
                    res.dirty.discard(old)
                    self.evictions.add(1)
                    stats["evicted"] += 1
                res.slab_of_frame[fr] = sl
                res.frame_of[sl] = fr
                res.tick[fr] = res.clock
                res.dirty.discard(int(sl))
                up_frames.append(int(fr))
                up_slabs.append(int(sl))
        for sl in dirty_hits:                  # refresh in place, same frame
            res.dirty.discard(int(sl))
            up_frames.append(int(res.frame_of[sl]))
            up_slabs.append(int(sl))
        self.uploads.add(len(up_frames))
        stats["uploaded"] += len(up_frames)
        return up_frames, up_slabs

    def _upload(self, frames: np.ndarray, slabs: np.ndarray) -> None:
        """One packed copy of the upload set, then its frames written.

        The pinned staging buffer (kept and grown by powers of two; a
        later upload waits for its copy to finish before refilling it)
        holds ``frames | slabs`` and then each payload plane's rows of the
        upload set, one contiguous block a plane, gathered straight from
        the host store into it; it crosses in one ``non_blocking`` copy,
        each plane's block goes into its frames by one ``index_copy_``,
        and the residency map follows. ``last_upload`` keeps the slab and
        byte counts and the host milliseconds of the gather.

        The copy, the frame writes and the map writes share the current
        stream, so they are ordered after every scan launched before
        them and no frame a launched scan reads is overwritten. The host
        gather overlaps such a scan; the copy cannot, as the prefetch's
        read of the reference counts waits behind that scan first.
        """
        t0 = time.perf_counter()
        u = len(frames)
        sizes = [u * nbytes for _, nbytes, _, _ in self._parts]
        head = 8 * u
        buf = self._staging_buffer(head + sum(sizes))
        hb = buf.numpy()
        hb[:head].view(np.int32)[:u] = frames
        hb[:head].view(np.int32)[u:] = slabs
        off = head
        for (name, _, _, shape), size in zip(self._parts, sizes):
            if size:
                plane = getattr(self.store, name)
                out = hb[off:off + size].view(plane.dtype).reshape(
                    (u,) + shape)
                # "clip" writes straight into ``out`` ("raise" would gather
                # into a fresh temporary first); the slab ids are in range
                np.take(plane, slabs, axis=0, out=out, mode="clip")
            off += size
        pack_ms = (time.perf_counter() - t0) * 1e3
        dev = buf.to(self.device, non_blocking=True)
        if self.pin:
            self._staged = torch.cuda.Event()
            self._staged.record()
        if self.tel.recording:
            self._m_bytes.inc(int(buf.numel()), direction="h2d",
                              stage="prefetch")
        self.h2d_copies += 1
        self.h2d_bytes += int(buf.numel())
        self.last_upload = {"slabs": u, "bytes": int(buf.numel()),
                            "pack_ms": pack_ms}
        fr = dev[:4 * u].view(torch.int32).long()
        sl = dev[4 * u:head].view(torch.int32)
        off = head
        for (name, _, dtype, shape), size in zip(self._parts, sizes):
            if size:
                src = dev[off:off + size].view(dtype).view((u,) + shape)
                getattr(self.cache, name).index_copy_(0, fr, src)
            off += size
        self.cache.slab_of_frame[fr] = sl
        self.cache.frame_of[sl.long()] = fr.to(torch.int32)

    def _staging_buffer(self, nbytes: int) -> torch.Tensor:
        """The first ``nbytes`` of the pinned staging buffer, once its last
        copy to the device has finished (on the CPU a fresh array)."""
        if not self.pin:
            return torch.empty((nbytes,), dtype=torch.uint8)
        if self._staged is not None:
            self._staged.synchronize()
        if self._staging is None or self._staging.numel() < nbytes:
            size = 1 << max(nbytes - 1, 1).bit_length()
            self._staging = torch.empty((size,), dtype=torch.uint8,
                                        pin_memory=True)
        return self._staging[:nbytes]

    def scan(self, state: SlabPoolState, queries: torch.Tensor,
             table: torch.Tensor, k: int, fstruct, fconsts
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Stage 3: frame-translated scan -> top-k through kernels 1/2."""
        self._scan_sigs.add((int(queries.shape[0]), int(table.shape[1]), k,
                             fstruct))
        with self.tel.span("scan"):
            return self._scan(state, queries, table, k, fstruct, fconsts)

    def _scan(self, state: SlabPoolState, queries: torch.Tensor,
              table: torch.Tensor, k: int, fstruct, fconsts
              ) -> tuple[torch.Tensor, torch.Tensor]:
        ftable = translate_table(table, self.cache.frame_of)
        view = cache_view(self.cfg, state, self.cache)
        return ix._scan_dispatch(self.cfg, view, queries.to(self.cfg.dtype),
                                 ftable, k, fstruct, fconsts)

    def search(self, state: SlabPoolState, queries: torch.Tensor, k: int,
               nprobe: int, fstruct=None, fconsts=None, epoch: int = 0,
               ticket: PrefetchTicket | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The full three-stage tiered search. A valid ``ticket`` (same
        runtime ``seq``, ``epoch``, ``nprobe`` and query bucket) skips
        stages 1-2; anything stale falls back to the full path."""
        if not (ticket is not None and ticket.seq == self.seq
                and ticket.epoch == epoch and ticket.nprobe == nprobe
                and ticket.padded_q == int(queries.shape[0])):
            table = self.plan(state, queries, nprobe)
            ticket = self.prefetch(table, nprobe, epoch)
        return self.scan(state, queries, ticket.table, k, fstruct, fconsts)

    # -- introspection ------------------------------------------------------

    def compile_stats(self) -> dict:
        """Distinct plan and scan launch signatures dispatched."""
        return {"tiered_plan": len(self._plan_sigs),
                "tiered_scan": len(self._scan_sigs)}

    def roll_window(self) -> None:
        """Start a new stats window (cumulative totals are untouched)."""
        for name in self._COUNTERS:
            getattr(self, name).mark()

    def carry_from(self, other: "TieredRuntime") -> "TieredRuntime":
        """Adopt another runtime's cumulative counters (and window marks)."""
        for name in self._COUNTERS:
            getattr(self, name).carry(getattr(other, name))
        return self

    def _residency(self) -> tuple[list, int]:
        """(resident slabs per shard, dirty slabs)."""
        return [self.res.resident_slabs], len(self.res.dirty)

    def stats(self) -> dict:
        probed = self.hits.total + self.misses.total
        probed_w = self.hits.window + self.misses.window
        resident, dirty = self._residency()
        return {
            "tiered": True,
            "device_slabs": self.cfg.device_slabs,
            "resident_slabs": sum(resident),
            "per_shard_resident": resident,
            "hit_rate": (self.hits.total / probed) if probed else 1.0,
            "hit_rate_kind": "cumulative",
            "hit_rate_window": (self.hits.window / probed_w)
            if probed_w else 1.0,
            "cache_hits": self.hits.total,
            "cache_misses": self.misses.total,
            "cache_uploads": self.uploads.total,
            "cache_evictions": self.evictions.total,
            "cache_hits_window": self.hits.window,
            "cache_misses_window": self.misses.window,
            "dedup_refs": self.refs.total,
            "dedup_unique_refs": self.unique_refs.total,
            "dedup_saved_fetches": self.refs.total - self.unique_refs.total,
            "dirty_slabs": dirty,
            "pending_plans": len(self._plans),
        }


class MeshTieredRuntime:
    """The tiered pool on a mesh: one :class:`TieredRuntime` per shard
    (its host store, residency and frame cache on the shard's device),
    driven together as the reference's mesh runtime is.

    A search's stages run on every shard: ``plan`` gives one slab table a
    shard; ``prefetch`` drains the queued plans (the stacked ``[S, B]``
    commit plans of the mesh's inserts, in one device read), reads every
    shard's reference counts in ONE copy, runs each shard's LRU decisions
    and packed upload, and counts once for the mesh; ``scan`` runs each
    shard's frame-view scan and merges the partials as the untiered mesh
    search does (``distributed.merge_partials``). The counters and
    :meth:`stats` are the mesh's totals, as the reference's are.
    """

    _COUNTERS = TieredRuntime._COUNTERS

    def __init__(self, cfg: SIVFConfig, devices, use_tables: bool | None
                 = None, stores: list | None = None, telemetry=None):
        devices = list(devices)
        if stores is not None and len(stores) != len(devices):
            raise ValueError(
                f"{len(stores)} host stores for {len(devices)} shards")
        self.cfg = cfg
        self.shards = [TieredRuntime(cfg, d, use_tables,
                                     None if stores is None else stores[s],
                                     telemetry=telemetry)
                       for s, d in enumerate(devices)]
        for s, sub in enumerate(self.shards):
            sub.shard = s
        self.tel = self.shards[0].tel
        self._plans: list[dict] = []
        self.seq = 0
        for name in self._COUNTERS:
            setattr(self, name, WindowedCounter())
        self.last_prefetch: dict = {}
        self.d2h_reads = 0
        self._plan_sigs: set = set()
        self._scan_sigs: set = set()

    @property
    def stores(self) -> list[HostStore]:
        return [sub.store for sub in self.shards]

    @property
    def h2d_copies(self) -> int:
        return sum(sub.h2d_copies for sub in self.shards)

    @property
    def h2d_bytes(self) -> int:
        return sum(sub.h2d_bytes for sub in self.shards)

    def queue_plan(self, plan: dict, vecs, attrs) -> None:
        """Queue one committed batch's stacked ``[S, B]`` plan (row ``b`` of
        every shard's plan names input row ``b``)."""
        self._plans.append({
            "slab": plan["slab"], "slot": plan["slot"],
            "codes": plan["codes"],
            "vecs": None if self.cfg.payload_dim == 0 else vecs,
            "attrs": attrs if self.cfg.n_attrs else None})

    def drain_plans(self) -> None:
        """Apply every queued plan to the shards' host stores (one read)."""
        if not self._plans:
            return
        plans, self._plans = self._plans, []
        host, copied = _plans_to_host(plans)
        self.d2h_reads += copied
        for p in host:
            for s, sub in enumerate(self.shards):
                sub._apply_plan({"slab": p["slab"][s], "slot": p["slot"][s],
                                 "codes": p["codes"][s], "vecs": p["vecs"],
                                 "attrs": p["attrs"]})

    def plan(self, state, queries: torch.Tensor, nprobe: int) -> list:
        """Stage 1 on every shard: one pool slab-id table ``[Q, T]`` each."""
        self._plan_sigs.add((int(queries.shape[0]), nprobe))
        with self.tel.span("plan"):
            return [sub._table(st, queries.to(st.device), nprobe)
                    for sub, st in zip(self.shards, state.shards)]

    def prefetch(self, tables: list, nprobe: int, epoch: int
                 ) -> PrefetchTicket:
        """Stage 2 on every shard; the shards' reference counts cross in
        one copy. The ticket's ``table`` is the list of shard tables."""
        with self.tel.span("prefetch"):
            self.drain_plans()
            dev = tables[0].device
            counts = torch.stack([_slab_counts(self.cfg, t).to(dev)
                                  for t in tables]).cpu().numpy()
            self.d2h_reads += 1
            stats = {"refs": 0, "unique": 0, "hits": 0, "misses": 0,
                     "dirty_refresh": 0, "uploaded": 0, "evicted": 0}
            ups = [sub._prefetch_slabs(counts[s], stats)
                   for s, sub in enumerate(self.shards)]
            stats["dedup_saved"] = stats["refs"] - stats["unique"]
            for name, key in (("hits", "hits"), ("misses", "misses"),
                              ("refs", "refs"), ("unique_refs", "unique"),
                              ("uploads", "uploaded"),
                              ("evictions", "evicted")):
                getattr(self, name).add(stats[key])
            self.last_prefetch = stats
            self.seq += 1
            for sub, (frames, slabs) in zip(self.shards, ups):
                if frames:
                    sub._upload(np.asarray(frames, np.int32),
                                np.asarray(slabs, np.int32))
            if self.tel.recording:
                m = self.shards[0]._m_cache
                m.inc(stats["hits"], event="hit")
                m.inc(stats["misses"], event="miss")
                m.inc(stats["evicted"], event="eviction")
                m.inc(stats["uploaded"], event="upload")
                m.inc(stats["dirty_refresh"], event="dirty_refresh")
                m.inc(stats["dedup_saved"], event="dedup_saved")
                self.shards[0]._m_bytes.inc(counts.nbytes, direction="d2h",
                                            stage="prefetch")
        return PrefetchTicket(table=tables, nprobe=nprobe,
                              padded_q=int(tables[0].shape[0]), seq=self.seq,
                              epoch=epoch)

    def scan(self, state, queries: torch.Tensor, tables: list, k: int,
             fstruct, fconsts) -> tuple[torch.Tensor, torch.Tensor]:
        """Stage 3: each shard's frame-view scan, then the merge."""
        from repro_torch.core.distributed import merge_partials
        self._scan_sigs.add((int(queries.shape[0]), int(tables[0].shape[1]),
                             k, fstruct))
        with self.tel.span("scan"):
            ds, ls = [], []
            for sub, st, t in zip(self.shards, state.shards, tables):
                d, lab = sub._scan(st, queries.to(st.device), t, k, fstruct,
                                   None if fconsts is None
                                   else fconsts.to(st.device))
                ds.append(d)
                ls.append(lab)
            return merge_partials(ds, ls, k)

    search = TieredRuntime.search

    def compile_stats(self) -> dict:
        """Distinct plan and scan launch signatures dispatched."""
        return {"tiered_plan": len(self._plan_sigs),
                "tiered_scan": len(self._scan_sigs)}

    roll_window = TieredRuntime.roll_window
    carry_from = TieredRuntime.carry_from

    def _residency(self) -> tuple[list, int]:
        return ([sub.res.resident_slabs for sub in self.shards],
                sum(len(sub.res.dirty) for sub in self.shards))

    stats = TieredRuntime.stats

