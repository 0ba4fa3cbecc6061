"""Sharded SIVF: shared-nothing data sharding + scatter-gather (paper §4.2).

PyTorch counterpart of ``repro/core/distributed.py``. The reference maps
the paper's multi-GPU design onto ``jax.shard_map`` over a mesh axis; the
port keeps its single-controller shape without ``torch.distributed``:

  * **The mesh** (:class:`ShardMesh`) is a frozen tuple of
    ``torch.device``s and an axis name. Devices may repeat:
    ``ShardMesh.virtual(4, "cuda")`` puts four shards on one card (the
    counterpart of ``--xla_force_host_platform_device_count=4``), and a
    mesh of distinct devices runs one shard per card with the same code.
  * **The state** (:class:`ShardedState`) is one ``SlabPoolState`` per
    shard, shard ``s`` on ``mesh.devices[s]``; its stacked view (a plane
    by name, :meth:`ShardedState.stacked_numpy`) has the reference's
    leading shard axis, which checkpoints and :func:`flatten_live_rows`
    read.
  * **Data sharding** — shard ``id % n_shards`` owns an id
    (:func:`shard_of`). **Ingestion** broadcasts the batch: every shard
    runs the single backend's insert on the whole batch with the ids it
    does not own set to -1, so its allocation order is the reference's.
    The shards' commit decisions cross to the host in one copy.
    **Deletion** is a broadcast (an id lives on one shard; the others
    miss in their address tables). **Search** runs each shard's fused
    scan->top-k, concatenates the ``[Q, k]`` partials in shard order and
    merges them with the port's top-k (kernel 4, ``kernels/topk``, on the
    card; its plain version on the CPU): IEEE total order, ties to the
    lower column, as the reference's ``lax.top_k`` merge.
  * **Per-shard atomicity** — each shard's insert is all-or-nothing on
    its own, so a partially failing batch keeps every payload and the
    per-shard error vector says which shard aborted. A maintenance
    commit is atomic across shards: if any shard would abort, none
    commits.
  * **Elastic resharding** — :func:`reshard_state` remaps an S-shard
    state onto S' shards through the canonical id-sorted table of live
    rows (:func:`flatten_live_rows`), re-routed by ``id % n_to`` and
    rebuilt per target shard with one insert. Searches before and after
    return the same ids and distances.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import index as ix
from repro_torch.core import pq as pqmod
from repro_torch.core import quantizer
from repro_torch.core.state import (
    PLANES,
    SIVFConfig,
    SlabPoolState,
    clear_error,
    host_live_mask,
    init_state,
)


# ---------------------------------------------------------------------------
# The mesh and the sharded state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The devices that hold an index's shards, in shard order.

    ``shape`` is ``{axis: len(devices)}``, as a jax ``Mesh``'s is, so a
    backend argument reads the same in both packages. Devices may repeat
    (virtual shards on one device).
    """

    devices: tuple
    axis: str = "data"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a ShardMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @classmethod
    def virtual(cls, n: int, device="cuda", axis: str = "data"
                ) -> "ShardMesh":
        """``n`` shards on one device."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        return cls((torch.device(device),) * n, axis)

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def _axis_size(mesh: ShardMesh, axis: str) -> int:
    if axis not in mesh.shape:
        raise ValueError(
            f"target mesh has no {axis!r} axis (axes: "
            f"{tuple(mesh.shape)}); pass axis= or a mesh with the index's "
            f"data axis")
    return mesh.shape[axis]


@dataclasses.dataclass
class ShardedState:
    """Per-shard slab pools, shard ``s`` on its own device.

    A plane read by name (``state.n_live``, ``state.ids``) is the
    reference's stacked view: that plane of every shard stacked on a
    leading axis, on shard 0's device (a copy). :meth:`stacked_numpy` gives
    all 23 planes so, as the reference's format-3 mesh checkpoint holds
    them. Mutations go through the shards (:meth:`__getitem__`).
    """

    shards: list

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def __getitem__(self, s: int) -> SlabPoolState:
        return self.shards[s]

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def __getattr__(self, name: str):
        if name in PLANES:
            return self.stacked(name)
        raise AttributeError(name)

    def stacked(self, name: str) -> torch.Tensor:
        """Plane ``name`` of every shard, stacked ``[S, ...]``."""
        dev = self.device
        return torch.stack([getattr(sh, name).to(dev) for sh in self.shards])

    def stacked_numpy(self) -> dict:
        """``{plane: np.ndarray [S, ...]}`` on the host, bitmap uint32."""
        per = [interop.state_to_numpy(sh) for sh in self.shards]
        return {name: np.stack([p[name] for p in per]) for name in PLANES}

    @classmethod
    def from_numpy(cls, cfg: SIVFConfig, planes: dict, devices
                   ) -> "ShardedState":
        """Shards on ``devices`` from stacked ``{plane: array [S, ...]}``."""
        devices = list(devices)
        n = int(np.asarray(planes["ids"]).shape[0])
        if n != len(devices):
            raise ValueError(f"planes hold {n} shards but {len(devices)} "
                             f"devices were given")
        return cls([interop.state_from_numpy(
            cfg, {k: np.asarray(planes[k])[s] for k in PLANES}, devices[s])
            for s in range(n)])


def shard_of(ids, n_shards: int):
    """Deterministic owner shard of each external id (-1 for ids < 0)."""
    if isinstance(ids, torch.Tensor):
        return torch.where(ids >= 0, ids % n_shards, -1)
    ids = np.asarray(ids)
    return np.where(ids >= 0, ids % n_shards, -1)


def init_sharded_state(cfg: SIVFConfig, centroids, mesh: ShardMesh,
                       axis: str = "data", pq_codebooks=None
                       ) -> ShardedState:
    """An empty pool on every shard; the centroids (and ``pq_codebooks``
    when ``cfg.pq`` is set) replicate to every shard."""
    _axis_size(mesh, axis)
    return ShardedState([init_state(cfg, centroids, pq_codebooks, device=d)
                         for d in mesh.devices])


def place_sharded(cfg: SIVFConfig, state, mesh: ShardMesh,
                  axis: str = "data") -> ShardedState:
    """Place a stacked state (a :class:`ShardedState` or stacked
    ``{plane: array}``) onto ``mesh``: shard ``s`` onto ``mesh.devices[s]``,
    the order :func:`shard_of` routes by."""
    n = _axis_size(mesh, axis)
    have = _leading_shards(state)
    if not _is_stacked(state) or have != n:
        raise ValueError(
            f"state has {have} shards but mesh axis {axis!r} has {n}")
    planes = state.stacked_numpy() if isinstance(state, ShardedState) \
        else state
    return ShardedState.from_numpy(cfg, planes, mesh.devices)


def _is_stacked(state) -> bool:
    if isinstance(state, ShardedState):
        return True
    if isinstance(state, SlabPoolState):
        return False
    return np.asarray(state["ids"]).ndim == 3


def _leading_shards(state) -> int:
    """Shard count of a state: a :class:`ShardedState`'s length, a stacked
    plane dict's leading axis, 1 for a single pool."""
    if isinstance(state, ShardedState):
        return state.n_shards
    if isinstance(state, SlabPoolState):
        return 1
    ids = np.asarray(state["ids"])
    return int(ids.shape[0]) if ids.ndim == 3 else 1


def _shard_list(state) -> list:
    """Per-shard pools: ``SlabPoolState``s, or plane dicts of arrays."""
    if isinstance(state, ShardedState):
        return list(state.shards)
    if isinstance(state, SlabPoolState) or not _is_stacked(state):
        return [state]
    return [{k: np.asarray(v)[s] for k, v in state.items()}
            for s in range(_leading_shards(state))]


def _plane(shard, name: str):
    return shard[name] if isinstance(shard, dict) else getattr(shard, name)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Sharded ops (one code path for dist_* and sivf_torch.Index)
# ---------------------------------------------------------------------------

def read_decisions(stages: list) -> list:
    """Every shard's ``(ok, n_valid, n_new)`` in ONE device->host copy
    (the shards' vectors gathered on the first one's device first)."""
    dev = stages[0].decision.device
    return torch.stack([st.decision.to(dev) for st in stages]).tolist()


def _shard_batch(cfg: SIVFConfig, st: SlabPoolState, s: int, n: int,
                 vecs: torch.Tensor, ext_ids: torch.Tensor,
                 lists: torch.Tensor | None):
    """The broadcast batch on shard ``s``'s device, the ids it does not
    own set to -1, routed by its own centroid replica unless ``lists``."""
    dev = st.device
    v = vecs.to(dev)
    i = ext_ids.to(dev, torch.int32)
    mine = shard_of(i, n) == s
    if lists is None:
        lists = quantizer.assign(st.centroids, v.to(cfg.dtype), cfg.metric)
    return v.to(cfg.dtype), torch.where(mine, i, -1), lists.to(dev)


def _on(x: torch.Tensor | None, dev) -> torch.Tensor | None:
    return None if x is None else x.to(dev)


def _sum_on(counts: list, dev) -> torch.Tensor:
    """Per-shard int32 device scalars summed on ``dev`` (0 for none)."""
    total = torch.zeros((), dtype=torch.int32, device=dev)
    for c in counts:
        total = total + c.to(dev)
    return total


def _stack_plans(plans: list) -> dict:
    dev = plans[0]["slab"].device
    return {k: torch.stack([p[k].to(dev) for p in plans])
            for k in ("slab", "slot", "codes")}


def sharded_insert(cfg: SIVFConfig, mesh: ShardMesh, axis: str = "data",
                   want_plan: bool = False):
    """Broadcast-ingest op: each shard ingests the ids it owns.

    Returns ``run(state, vecs, ext_ids, attrs=None, aux=None) -> state``,
    updating the shards in place (the returned state names the current
    planes). Every shard stages the whole batch with the ids it does not
    own set to -1, the shards' commit decisions cross in one copy, then
    each commits or aborts on its own: an aborting shard keeps its
    previous planes and raises its own error bits. ``want_plan=True``
    returns ``(state, plan)`` with the stacked ``[S, B]`` commit plan
    (rows a shard did not own, or an aborted shard's whole batch, are
    -1). A dict ``aux`` receives ``slabs_allocated`` (host int) and
    ``n_reclaimed`` (device int32 on shard 0's device), each summed over
    the committing shards.
    """
    n = _axis_size(mesh, axis)

    def run(state: ShardedState, vecs: torch.Tensor, ext_ids: torch.Tensor,
            attrs: torch.Tensor | None = None, aux: dict | None = None):
        stages = []
        for s, st in enumerate(state.shards):
            v, i, li = _shard_batch(cfg, st, s, n, vecs, ext_ids, None)
            stages.append(ix._insert_stage(cfg, st, v, i, li))
        decisions = read_decisions(stages)
        outs = [ix._insert_commit(cfg, st, stg, dec, None,
                                  _on(attrs, st.device), want_plan)
                for st, stg, dec in zip(state.shards, stages, decisions)]
        if aux is not None:
            ok = [(stg, dec) for stg, dec in zip(stages, decisions)
                  if dec[0]]
            aux["slabs_allocated"] = sum(int(dec[2]) for _, dec in ok)
            aux["n_reclaimed"] = _sum_on(
                [stg.reclaimed for stg, _ in ok], state.device)
        if not want_plan:
            return ShardedState(outs)
        return (ShardedState([o[0] for o in outs]),
                _stack_plans([o[1] for o in outs]))

    return run


def sharded_delete(cfg: SIVFConfig, mesh: ShardMesh, axis: str = "data"):
    """Broadcast-delete op: non-owners miss in their address tables and
    change nothing. Returns ``run(state, ext_ids, aux=None) -> state`` (in
    place, no host read); a dict ``aux`` receives ``n_reclaimed``, the
    shards' reclaimed slabs summed on shard 0's device."""
    _axis_size(mesh, axis)

    def run(state: ShardedState, ext_ids: torch.Tensor,
            aux: dict | None = None) -> ShardedState:
        outs = [ix._delete_impl(cfg, st, ext_ids.to(st.device))
                for st in state.shards]
        if aux is not None:
            aux["n_reclaimed"] = _sum_on([n for _, n in outs], state.device)
        return ShardedState([st for st, _ in outs])

    return run


def sharded_maintain(cfg: SIVFConfig, mesh: ShardMesh, axis: str = "data",
                     want_plan: bool = False):
    """Atomic maintenance commit across shards (``core/maintenance.py``).

    The host-planned batch (new centroid plane, the affected lists' live
    rows, id-sorted and -1-padded) is broadcast as in
    :func:`sharded_insert`: every shard stages the new centroids and the
    rows it owns, the decisions cross in one copy, and the shards agree:
    if any shard would abort, none commits and every shard keeps its
    pre-op planes, so no search sees shard A under the new layout and
    shard B under the old one.

    Returns ``run(state, new_cents, vecs, ext_ids, lists, codes=None,
    attrs=None) -> (state, errors [S])``, plus the stacked ``[S, B]``
    commit plan with ``want_plan``. ``errors`` holds each shard's own
    bits. On an aborted vote the plan's ``slab`` is -1 everywhere (and,
    unlike the reference's, its ``slot`` 0: no shard computed a write).
    """
    n = _axis_size(mesh, axis)

    def run(state: ShardedState, new_cents: torch.Tensor,
            vecs: torch.Tensor, ext_ids: torch.Tensor, lists: torch.Tensor,
            codes: torch.Tensor | None = None,
            attrs: torch.Tensor | None = None):
        pre, staged, stages = [], [], []
        for s, st in enumerate(state.shards):
            st0 = clear_error(st)
            sc = dataclasses.replace(
                st0, centroids=new_cents.to(st.device, cfg.dtype))
            v, i, li = _shard_batch(cfg, sc, s, n, vecs, ext_ids, lists)
            pre.append(st0)
            staged.append(sc)
            stages.append(ix._insert_stage(cfg, sc, v, i, li))
        decisions = read_decisions(stages)
        # each shard's own bits: its abort bits where it would abort
        errs = torch.stack([ix._stage_error_bits(stg).to(state.device)
                            for stg in stages])
        if not all(d[0] for d in decisions):
            # the vote: a shard that would abort reverts every shard
            outs = [((st0, _void_plan(cfg, vecs.shape[0], st0.device))
                     if want_plan else st0) for st0 in pre]
        else:
            outs = [ix._insert_commit(cfg, sc, stg, dec,
                                      _on(codes, sc.device),
                                      _on(attrs, sc.device), want_plan)
                    for sc, stg, dec in zip(staged, stages, decisions)]
        if want_plan:
            return (ShardedState([clear_error(o[0]) for o in outs]), errs,
                    _stack_plans([o[1] for o in outs]))
        return ShardedState([clear_error(o) for o in outs]), errs

    return run


def _void_plan(cfg: SIVFConfig, b: int, dev) -> dict:
    return {"slab": torch.full((b,), -1, dtype=torch.int32, device=dev),
            "slot": torch.zeros((b,), dtype=torch.int32, device=dev),
            "codes": torch.zeros((b, cfg.code_m), dtype=torch.uint8,
                                 device=dev)}


def merge_partials(dists: list, labels: list, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The global top-k of per-shard ``[Q, k]`` partials.

    The partials are concatenated in shard order into ``[Q, S*k]`` on the
    first shard's device and merged by the port's ``topk``: kernel 4 for
    CUDA tensors, its plain version for CPU ones (IEEE total order,
    ``-0.0`` before ``+0.0``, ties to the lower column, a ``+inf`` keeping
    its ``-1`` label), the reference's ``lax.top_k(-d, k)`` merge.
    """
    from repro_torch.kernels.topk.ops import topk
    dev = dists[0].device
    dg = torch.cat([d.to(dev) for d in dists], dim=1).contiguous()
    lg = torch.cat([lab.to(dev) for lab in labels], dim=1).contiguous()
    return topk(dg, lg, k)


def sharded_search(cfg: SIVFConfig, mesh: ShardMesh, axis: str = "data",
                   use_tables: bool | None = None):
    """Scatter-gather search: each shard's fused scan->top-k, then the
    cross-shard merge (:func:`merge_partials`). Returns ``run(state,
    queries, k, nprobe, fstruct=None, fconsts=None) -> (dists, labels)``
    on shard 0's device. Only ``[Q, k]`` partials leave a shard."""
    _axis_size(mesh, axis)

    def run(state: ShardedState, queries: torch.Tensor, k: int, nprobe: int,
            fstruct: tuple | None = None,
            fconsts: torch.Tensor | None = None):
        ds, ls = [], []
        for st in state.shards:
            d, lab = ix.search(cfg, st, queries.to(st.device), k, nprobe,
                               use_tables=use_tables, fstruct=fstruct,
                               fconsts=_on(fconsts, st.device))
            ds.append(d)
            ls.append(lab)
        return merge_partials(ds, ls, k)

    return run


# ---------------------------------------------------------------------------
# Elastic resharding (host-driven; Index.load / Index.reshard wrap this)
# ---------------------------------------------------------------------------

def flatten_live_rows(cfg: SIVFConfig, state) -> dict:
    """Flatten slab pools to the canonical host-side table of live rows.

    ``state`` is a ``SlabPoolState``, a :class:`ShardedState`, or
    ``{plane: array}`` of one pool or stacked ``[S, ...]`` (a checkpoint's
    planes, the reference's state as numpy). Rows are **id-sorted**, so
    two states hold the same logical index iff their tables are equal,
    whatever their shard count, slab layout or deletion history. Only the
    live rows of a tensor's payload planes cross to the host.

    Returns numpy arrays over the N live rows: ``ids`` [N] int32
    (ascending), ``lists`` [N] int32 (the slab's ``owner``), ``data``
    [N, payload_dim], ``codes`` [N, code_m] uint8, ``attrs`` [N, n_attrs]
    int32; plus ``centroids`` and ``pq_codebooks`` (shard 0's replica).
    """
    from repro_torch.core.maintenance import _rows
    ids_p, list_p, data_p, code_p, attr_p = [], [], [], [], []
    n_live = 0
    shards = _shard_list(state)
    for sh in shards:
        owner = _host(_plane(sh, "owner"))
        live = host_live_mask(cfg, _host(_plane(sh, "bitmap")))
        si, so = np.nonzero(live)           # slab-major, slot-minor
        ids_p.append(_host(_plane(sh, "ids"))[si, so])
        list_p.append(owner[si])
        data_p.append(_rows(_plane(sh, "data"), si, so).reshape(
            len(si), cfg.payload_dim))
        code_p.append(_rows(_plane(sh, "codes"), si, so).reshape(
            len(si), cfg.code_m))
        attr_p.append(_rows(_plane(sh, "attrs"), si, so).reshape(
            len(si), cfg.n_attrs))
        n_live += int(_host(_plane(sh, "n_live")))
    live_ids = np.concatenate(ids_p)
    if len(live_ids) != n_live:
        raise ValueError(
            f"corrupt state: bitmap says {len(live_ids)} live rows but "
            f"n_live says {n_live}")
    order = np.argsort(live_ids, kind="stable")               # canonical
    return {
        "ids": live_ids[order].astype(np.int32),
        "lists": np.concatenate(list_p)[order].astype(np.int32),
        "data": np.concatenate(data_p)[order],
        "codes": np.concatenate(code_p)[order],
        "attrs": np.concatenate(attr_p)[order].astype(np.int32),
        "centroids": _host(_plane(shards[0], "centroids")),
        "pq_codebooks": _host(_plane(shards[0], "pq_codebooks")),
    }


def _check_reshard_fit(cfg: SIVFConfig, ids: np.ndarray, lists: np.ndarray,
                       n_to: int) -> None:
    """Host-side feasibility: every target shard's rows must fit its pool.

    Shrinking concentrates rows, so a state that fit S shards can overflow
    the per-shard ``n_slabs`` pool or a list's ``max_chain`` bound on
    S' < S shards. Failing before any device work names the limit to
    raise.
    """
    shard = ids % n_to
    key = shard.astype(np.int64) * cfg.n_lists + lists
    per_list = np.bincount(key, minlength=n_to * cfg.n_lists
                           ).reshape(n_to, cfg.n_lists)
    chains = -(-per_list // cfg.capacity)                     # ceil div
    slabs_needed = chains.sum(axis=1)
    if (bad := np.flatnonzero(slabs_needed > cfg.n_slabs)).size:
        s = int(bad[0])
        raise ValueError(
            f"reshard to {n_to} shards needs {int(slabs_needed[s])} slabs "
            f"on shard {s} but cfg.n_slabs={cfg.n_slabs}; raise n_slabs or "
            f"keep more shards")
    if (bad := np.argwhere(chains > cfg.max_chain)).size:
        s, li = (int(x) for x in bad[0])
        raise ValueError(
            f"reshard to {n_to} shards needs a {int(chains[s, li])}-slab "
            f"chain for list {li} on shard {s} but cfg.max_chain="
            f"{cfg.max_chain}; raise max_chain or keep more shards")


def _build_shard(cfg: SIVFConfig, centroids: np.ndarray, cb: np.ndarray,
                 vecs: np.ndarray, ids: np.ndarray, lists: np.ndarray,
                 codes: np.ndarray | None, attrs: np.ndarray | None,
                 device) -> SlabPoolState:
    """One target shard: a fresh ``init_state`` on ``device`` plus one
    pre-routed insert, padded to a power-of-two bucket (floor 64) as the
    reference's is. Stored PQ codes and attributes are scattered as they
    are, so those planes carry over byte for byte."""
    st = init_state(cfg, centroids, None if cfg.pq is None else cb,
                    device=device)
    n = len(ids)
    if n == 0:
        return st
    b = max(64, 1 << (n - 1).bit_length())

    def pad(a, shape, dtype, fill=0):
        out = np.full(shape, fill, dtype)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    cp = None if codes is None else pad(codes, (b, cfg.code_m), np.uint8)
    ap = None if attrs is None or not cfg.n_attrs \
        else pad(attrs, (b, cfg.n_attrs), np.int32)
    st = ix.insert(cfg, st, pad(vecs, (b, cfg.dim), np.float32),
                   pad(ids, (b,), np.int32, -1), pad(lists, (b,), np.int32),
                   cp, ap)
    if int(st.error):
        raise ValueError(
            f"reshard rebuild failed with error bits {int(st.error)} "
            f"(n={n} rows; pool n_slabs={cfg.n_slabs} max_chain="
            f"{cfg.max_chain})")
    return st


def reshard_state(cfg: SIVFConfig, state, n_from: int, n_to: int,
                  stack: bool | None = None, device=None):
    """Remap an S-shard index state onto S' shards. Host-driven.

    ``state`` is anything :func:`flatten_live_rows` reads. The result is a
    ``SlabPoolState`` when ``n_to == 1`` (unless ``stack=True``: a
    one-shard *mesh* target), else a :class:`ShardedState`. ``device`` is
    one device for every target shard or a sequence of ``n_to`` (a
    mesh's ``devices``); by default the source's first shard's device
    (the CPU for plane dicts).

    Semantics (``docs/checkpoint-format.md``): rows re-route by
    ``id % n_to``, the rule :func:`sharded_insert` applies; centroids and
    PQ codebooks replicate; stored payloads and PQ codes carry over byte
    for byte (codes are re-scattered, never decoded and re-encoded), so
    searches return the same ids and distances; slab layout is not kept
    (each target shard packs its rows densely). Raises ``ValueError``
    when the rows cannot fit ``n_to`` shards (:func:`_check_reshard_fit`)
    or ``n_from`` is not the state's shard count.
    """
    if n_to < 1:
        raise ValueError(f"n_to must be >= 1, got {n_to}")
    from repro_torch import obs
    tel = obs.default()
    actual = _leading_shards(state)
    if n_from != actual:
        raise ValueError(
            f"state has {actual} shard(s) but n_from={n_from}")
    if device is None:
        first = _shard_list(state)[0]
        device = first.device if isinstance(first, SlabPoolState) else "cpu"
    devices = [device] * n_to if isinstance(device, (str, torch.device)) \
        else list(device)
    if len(devices) != n_to:
        raise ValueError(f"{len(devices)} devices for {n_to} shards")
    with tel.span("reshard.flatten"):
        rows = flatten_live_rows(cfg, state)
    ids, lists = rows["ids"], rows["lists"]
    _check_reshard_fit(cfg, ids, lists, n_to)
    codes = rows["codes"] if cfg.pq is not None else None
    if cfg.pq is not None and not cfg.pq.store_raw:
        # codes are the only payload and ride the rebuild verbatim;
        # decoded codewords stand in for the fp rows the insert needs
        # (they feed only the norms plane, which ADC scoring ignores)
        vecs = pqmod.decode(torch.from_numpy(rows["pq_codebooks"]),
                            torch.from_numpy(rows["codes"])).numpy()
    else:
        vecs = np.asarray(rows["data"], np.float32)
    if tel.recording:
        # the bytes that cross the host on this flatten-and-rebuild path
        moved = sum(rows[k].nbytes for k in ("ids", "lists", "data",
                                             "codes", "attrs"))
        tel.counter("sivf_transfer_bytes_total",
                    "explicit host<->device transfer bytes by direction "
                    "and stage", ("direction", "stage")
                    ).inc(moved, direction="d2h", stage="reshard")
        tel.counter("sivf_reshard_rows_total",
                    "live rows re-routed by reshard_state"
                    ).inc(int(ids.shape[0]))
    shard = ids % n_to
    shards = []
    for t in range(n_to):
        sel = shard == t
        with tel.span("reshard.build_shard", shard=t):
            shards.append(_build_shard(
                cfg, rows["centroids"], rows["pq_codebooks"], vecs[sel],
                ids[sel], lists[sel], None if codes is None else codes[sel],
                rows["attrs"][sel] if cfg.n_attrs else None, devices[t]))
    if n_to == 1 and not stack:
        return shards[0]
    return ShardedState(shards)


def _as_states(cfg: SIVFConfig, state) -> list:
    """Per-shard ``SlabPoolState``s (plane dicts built on the CPU)."""
    return [sh if isinstance(sh, SlabPoolState)
            else interop.state_from_numpy(cfg, sh, "cpu")
            for sh in _shard_list(state)]


def search_stacked(cfg: SIVFConfig, state, queries, k: int, nprobe: int,
                   use_tables: bool | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Search a single or stacked state without a mesh; host-side merge.

    Runs the single backend's search on each shard and merges on the host
    as the reference's ``search_stacked`` does: concatenate the
    ``[Q, k]`` partials in shard order, stable-sort by distance, keep k.
    That sort treats ``-0.0`` and ``+0.0`` as equal, where the mesh
    search's merge (:func:`merge_partials`, the reference's
    ``sharded_search``) puts ``-0.0`` first; the two differ only there.
    """
    q = queries if isinstance(queries, torch.Tensor) \
        else torch.from_numpy(np.asarray(queries, np.float32))
    ds, ls = [], []
    for st in _as_states(cfg, state):
        d, lab = ix.search(cfg, st, q.to(st.device), k, nprobe,
                           use_tables=use_tables)
        ds.append(d.cpu().numpy())
        ls.append(lab.cpu().numpy())
    if len(ds) == 1 and not _is_stacked(state):
        return ds[0], ls[0]
    dg, lg = np.concatenate(ds, axis=1), np.concatenate(ls, axis=1)
    order = np.argsort(dg, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(dg, order, 1), np.take_along_axis(lg, order, 1)


def total_live(state) -> int:
    """Aggregate live count across shards."""
    return sum(int(_host(_plane(sh, "n_live"))) for sh in _shard_list(state))


def stats(cfg: SIVFConfig, state: ShardedState) -> dict:
    """The reference's ``index.stats`` of a stacked per-shard state:
    occupancy summed over shards, live counts and error bits folded, plus
    ``per_shard_live`` / ``per_shard_slabs_used``."""
    occ = ix._list_occupancy(cfg, state)        # over the stacked planes
    free_top = state.stacked("free_top").cpu().numpy()
    used_per = (cfg.n_slabs - free_top).astype(int)
    used = int(used_per.sum())
    per_live = state.stacked("n_live").cpu().numpy().astype(int)
    live = int(per_live.sum())
    alloc_slots = used * cfg.capacity
    table_len = state.stacked("table_len").cpu().numpy()
    err = int(np.bitwise_or.reduce(state.stacked("error").cpu().numpy()))
    return {
        "n_live": live,
        "slabs_used": used,
        "free_slabs": int(free_top.sum()),
        "alloc_slots": alloc_slots,
        "fill_frac": live / max(alloc_slots, 1),
        "error": err,
        "max_chain_len": int(table_len.max()),
        "mean_chain_len": float(table_len.mean()),
        "n_shards": state.n_shards,
        "per_shard_live": per_live.tolist(),
        "per_shard_slabs_used": used_per.tolist(),
        "list_occupancy": occ.tolist(),
        "list_skew": float(occ.max() / occ.mean()) if occ.any() else 0.0,
        **ix._memory_stats(cfg, state.n_shards),
    }


# ---------------------------------------------------------------------------
# Legacy free-function surface (thin delegation; prefer sivf_torch.Index)
# ---------------------------------------------------------------------------

def dist_insert(cfg: SIVFConfig, mesh: ShardMesh, state: ShardedState,
                vecs: torch.Tensor, ext_ids: torch.Tensor,
                axis: str = "data") -> ShardedState:
    """Broadcast batch; each shard ingests the ids it owns."""
    return sharded_insert(cfg, mesh, axis)(state, vecs, ext_ids)


def dist_delete(cfg: SIVFConfig, mesh: ShardMesh, state: ShardedState,
                ext_ids: torch.Tensor, axis: str = "data") -> ShardedState:
    """Broadcast deletes; non-owners miss and change nothing."""
    return sharded_delete(cfg, mesh, axis)(state, ext_ids)


def dist_search(cfg: SIVFConfig, mesh: ShardMesh, state: ShardedState,
                queries: torch.Tensor, k: int, nprobe: int,
                axis: str = "data") -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter-gather search across the mesh (:func:`sharded_search`)."""
    return sharded_search(cfg, mesh, axis)(state, queries, k, nprobe)
