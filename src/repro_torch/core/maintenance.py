"""Online index maintenance under drift: split / merge / re-cluster.

PyTorch counterpart of ``repro/core/maintenance.py``, on one pool or a
mesh of shards (``core/distributed.py``).

  * **split**  — a skewed list's live rows are re-partitioned by a local
    deterministic 2-means trained on the skewed list's rows alone; the
    refined centroids land on the skewed list and a near-empty victim
    list, and the union of both lists' rows re-routes to the nearer of
    the pair;
  * **merge**  — two under-full lists collapse onto ``min(a, b)``; both
    centroid rows become the mean of their rows;
  * **recluster** — a drifted list's centroid is recentered on the mean
    of its live rows and the rows are re-inserted (which also compacts
    the chain).

Every op is the same three phases: a host gather of the affected lists'
live rows (payloads read from the device planes row by row, or from the
tiered host store), centroid refinement on the host in numpy (the
reference's code, so the new centroids are ``==`` the reference's), then
ONE atomic device batch through ``index._insert_impl`` on a state staged
with the new centroids. A failed op (pool exhausted / chain overflow)
restores the old centroid plane and leaves every live id where it was.
Stored PQ codes ride the re-insert verbatim. On a mesh the gather reads
every shard, the batch is broadcast (each shard re-inserts the rows it
owns) and the shards vote: if any would abort, none commits
(``distributed.sharded_maintain``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import index as ix
from repro_torch.core.state import (
    ERR_CHAIN_OVERFLOW,
    ERR_POOL_EXHAUSTED,
    SIVFConfig,
    SlabPoolState,
    clear_error,
    host_live_mask,
)

ABORT_BITS = ERR_POOL_EXHAUSTED | ERR_CHAIN_OVERFLOW

KINDS = ("split", "merge", "recluster")


@dataclasses.dataclass(frozen=True)
class MaintOp:
    """One maintenance operation over one or two lists."""

    kind: str                    # split | merge | recluster
    lists: tuple[int, ...]       # split/merge: (a, b); recluster: (a,)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown maintenance kind {self.kind!r}")
        want = 1 if self.kind == "recluster" else 2
        if len(self.lists) != want:
            raise ValueError(
                f"{self.kind} takes {want} list(s), got {self.lists}")
        if len(set(self.lists)) != len(self.lists):
            raise ValueError(f"{self.kind} lists must be distinct")


def split(a: int, victim: int) -> MaintOp:
    return MaintOp("split", (int(a), int(victim)))


def merge(a: int, b: int) -> MaintOp:
    return MaintOp("merge", (int(a), int(b)))


def recluster(a: int) -> MaintOp:
    return MaintOp("recluster", (int(a),))


@dataclasses.dataclass(frozen=True)
class MaintenanceReport:
    """Outcome of one committed-or-aborted maintenance op."""

    kind: str
    lists: tuple[int, ...]
    rows: int                    # live rows gathered / re-inserted
    committed: bool              # False: state unchanged (atomic abort)
    errors: int                  # raw error bits from the commit attempt
    n_live: int                  # pool live count after the op


# ---------------------------------------------------------------------------
# Host-side gather
# ---------------------------------------------------------------------------

def _shards(state) -> list:
    """The per-shard pools of a ``SlabPoolState`` (one) or a
    ``distributed.ShardedState``."""
    from repro_torch.core.distributed import ShardedState
    return state.shards if isinstance(state, ShardedState) else [state]


def shard_views(cfg: SIVFConfig, state, stores=None) -> list:
    """Views of the planes the gather needs, one dict per shard.

    ``owner`` / ``bitmap`` / ``ids`` come to the host; the payload planes
    stay where they are (the state's tensors, or the tiered host stores'
    arrays when the device ones are zero-width) and :func:`gather_live`
    reads only the rows it selects.
    """
    if cfg.tiered and stores is None:
        raise ValueError("tiered config: maintenance gather needs the "
                         "host stores (pass stores=runtime.stores)")
    views = []
    for s, sh in enumerate(_shards(state)):
        v = {"owner": sh.owner.cpu().numpy(),
             "bitmap": sh.bitmap.cpu().numpy(),
             "ids": sh.ids.cpu().numpy()}
        src = stores[s] if cfg.tiered else sh
        v["data"], v["codes"], v["attrs"] = src.data, src.codes, src.attrs
        views.append(v)
    return views


def _rows(plane, si: np.ndarray, so: np.ndarray) -> np.ndarray:
    """``plane[si, so]`` on the host; a tensor is indexed where it lies."""
    if isinstance(plane, torch.Tensor):
        dev = plane.device
        return plane[torch.from_numpy(si).to(dev),
                     torch.from_numpy(so).to(dev)].cpu().numpy()
    return np.asarray(plane[si, so])


def gather_live(cfg: SIVFConfig, state: SlabPoolState, views: list,
                target_lists) -> dict:
    """The live rows of ``target_lists``, id-sorted: ids, vectors (raw, or
    decoded from the stored codes without ``store_raw``), codes, attrs
    and each row's current list."""
    tl = np.asarray(sorted(target_lists), np.int32)
    ids_parts, vec_parts, code_parts, attr_parts = [], [], [], []
    list_parts = []
    for v in views:
        mask_slab = np.isin(v["owner"], tl)
        live = host_live_mask(cfg, v["bitmap"])
        si, so = np.nonzero(live & mask_slab[:, None])
        ids_parts.append(v["ids"][si, so].astype(np.int32))
        list_parts.append(v["owner"][si].astype(np.int32))
        if cfg.payload_dim:
            vec_parts.append(_rows(v["data"], si, so))
        if cfg.code_m:
            code_parts.append(_rows(v["codes"], si, so))
        if cfg.n_attrs:
            attr_parts.append(_rows(v["attrs"], si, so))
    ids = (np.concatenate(ids_parts) if ids_parts
           else np.zeros((0,), np.int32)).astype(np.int32)
    order = np.argsort(ids, kind="stable")
    ids = ids[order]
    src_lists = (np.concatenate(list_parts)[order].astype(np.int32)
                 if list_parts else np.zeros((0,), np.int32))
    codes = (np.concatenate(code_parts)[order].astype(np.uint8)
             if cfg.code_m and code_parts else
             (np.zeros((0, cfg.code_m), np.uint8) if cfg.code_m else None))
    attrs = (np.concatenate(attr_parts)[order].astype(np.int32)
             if cfg.n_attrs and attr_parts else
             (np.zeros((0, cfg.n_attrs), np.int32) if cfg.n_attrs else None))
    if cfg.payload_dim:
        vecs = (np.concatenate(vec_parts)[order]
                if vec_parts else np.zeros((0, cfg.dim), np.float32))
        vecs = np.asarray(vecs, np.float32)[:, :cfg.dim]
    else:
        # PQ without store_raw: stand-in vectors decoded from the stored
        # codes. They feed only the norms plane and the centroid means;
        # the codes ride the re-insert verbatim.
        cb = _shards(state)[0].pq_codebooks.cpu().numpy().astype(
            np.float32)                  # shard 0's replica on a mesh
        m = cb.shape[0]
        if len(ids):
            c = codes.astype(np.int64)                   # [N, m]
            vecs = cb[np.arange(m)[None, :], c].reshape(len(ids), cfg.dim)
            vecs = vecs.astype(np.float32)
        else:
            vecs = np.zeros((0, cfg.dim), np.float32)
    return {"ids": ids, "vecs": vecs, "codes": codes, "attrs": attrs,
            "lists": src_lists}


# ---------------------------------------------------------------------------
# Centroid refinement (host numpy; deterministic)
# ---------------------------------------------------------------------------

def _kmeans2(x: np.ndarray, iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic local 2-means: farthest-point init + Lloyd."""
    mean = x.mean(axis=0)
    c0 = x[int(np.argmax(((x - mean) ** 2).sum(-1)))]
    c1 = x[int(np.argmax(((x - c0) ** 2).sum(-1)))]
    cents = np.stack([c0, c1])
    for _ in range(iters):
        d = ((x[:, None] - cents[None]) ** 2).sum(-1)    # [N, 2]
        assign = d.argmin(axis=1)
        for j in (0, 1):
            sel = x[assign == j]
            if len(sel):
                cents[j] = sel.mean(axis=0)
    return cents.astype(np.float32), assign


def _route2(vecs: np.ndarray, cents2: np.ndarray, metric: str) -> np.ndarray:
    """Index (0/1) of the nearer of two centroids under the index metric."""
    if metric == "ip":
        scores = vecs @ cents2.T                         # higher = nearer
        return scores.argmax(axis=1)
    d = ((vecs[:, None] - cents2[None]) ** 2).sum(-1)
    return d.argmin(axis=1)


def plan_op(cfg: SIVFConfig, op: MaintOp, gathered: dict,
            centroids: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """Host planning: -> (new centroids [n_lists, D], per-row routing [N]).

    ``None`` means the op is a no-op on the current state (nothing to
    move, no centroid change) and no device commit should run.
    """
    vecs, n = gathered["vecs"], len(gathered["ids"])
    new_cents = np.array(centroids, np.float32, copy=True)
    if op.kind == "recluster":
        (a,) = op.lists
        if n == 0:
            return None
        new_cents[a] = vecs.mean(axis=0)
        return new_cents, np.full((n,), a, np.int32)
    a, b = op.lists
    if op.kind == "merge":
        tgt = min(a, b)
        if n == 0:
            return None
        # both rows become the merged mean: the quantizer's stable argmin
        # ties toward min(a, b), so future inserts route to the target
        new_cents[a] = new_cents[b] = vecs.mean(axis=0)
        return new_cents, np.full((n,), tgt, np.int32)
    # split: the 2-means is trained on the skewed list's own rows; the
    # union of both lists' rows then re-routes to the nearer of the pair
    if n < 2:
        return None
    hot = vecs[gathered["lists"] == a]
    cents2, _ = _kmeans2(hot if len(hot) >= 2 else vecs)
    new_cents[a], new_cents[b] = cents2[0], cents2[1]
    route = _route2(vecs, cents2, cfg.metric)
    return new_cents, np.where(route == 0, a, b).astype(np.int32)


# ---------------------------------------------------------------------------
# Batch padding
# ---------------------------------------------------------------------------

def maint_batch_size(cfg: SIVFConfig, n_shards: int = 1) -> int:
    """Fixed pad width for maintenance batches (the reference's: one jit
    shape there). An op touches at most two lists, each of at most
    ``max_chain`` slabs of ``capacity`` rows per shard, clamped to the id
    space and rounded up to a power of two."""
    hard = 2 * cfg.max_chain * cfg.capacity * n_shards
    b = min(hard, cfg.n_max)
    p = 1
    while p < b:
        p <<= 1
    return p


def pad_batch(cfg: SIVFConfig, gathered: dict, lists: np.ndarray,
              width: int) -> dict:
    """-1-padded fixed-width arrays (padding rows set no error bits)."""
    n = len(gathered["ids"])
    if n > width:
        raise AssertionError(
            f"maintenance gather ({n} rows) exceeds the chain-bound batch "
            f"width ({width}) — max_chain accounting is broken")
    ids = np.full((width,), -1, np.int32)
    ids[:n] = gathered["ids"]
    vecs = np.zeros((width, cfg.dim), np.float32)
    vecs[:n] = gathered["vecs"]
    lst = np.zeros((width,), np.int32)
    lst[:n] = lists
    out = {"ids": ids, "vecs": vecs, "lists": lst, "codes": None,
           "attrs": None, "rows": n}
    if cfg.code_m:
        codes = np.zeros((width, cfg.code_m), np.uint8)
        codes[:n] = gathered["codes"]
        out["codes"] = codes
    if cfg.n_attrs:
        attrs = np.zeros((width, cfg.n_attrs), np.int32)
        attrs[:n] = gathered["attrs"]
        out["attrs"] = attrs
    return out


# ---------------------------------------------------------------------------
# Atomic device commit
# ---------------------------------------------------------------------------

def _commit_op(cfg: SIVFConfig, state: SlabPoolState, new_cents, batch: dict,
               want_plan: bool = False):
    """Staged re-insert under the NEW centroids, one commit point.

    ``_insert_impl`` returns its staged input on abort, which carries the
    new centroids: the ``where`` restores the old plane then, so an
    aborted op changes nothing observable. Returns ``(state, aux)`` or,
    with ``want_plan``, ``(state, aux, plan)``; ``aux`` holds device
    scalars ``errors``, ``committed``, ``n_live``.
    """
    dev = state.device
    put = (lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(dev))
    st0 = clear_error(state)
    new_cents = put(np.asarray(new_cents, np.float32))
    staged = dataclasses.replace(st0, centroids=new_cents)
    out = ix._insert_impl(
        cfg, staged, put(batch["vecs"]), put(batch["ids"]),
        put(batch["lists"]),
        codes=put(batch["codes"]) if cfg.pq is not None else None,
        attrs=put(batch["attrs"]) if cfg.n_attrs else None,
        want_plan=want_plan)
    st, plan = out if want_plan else (out, None)
    aborted = (st.error & ABORT_BITS) != 0
    st = dataclasses.replace(
        st, centroids=torch.where(aborted, st0.centroids, new_cents))
    aux = {"errors": st.error.clone(),
           "committed": (~aborted).to(torch.int32),
           "n_live": st.n_live.clone()}
    st = clear_error(st)
    return (st, aux, plan) if want_plan else (st, aux)


def _commit_op_mesh(cfg: SIVFConfig, mesh, axis: str, state, new_cents,
                    batch: dict, want_plan: bool = False):
    """The mesh twin of :func:`_commit_op` (``distributed.sharded_maintain``):
    the batch broadcast to every shard, one vote, every shard committed or
    every shard kept as it was. ``aux`` adds ``shard_errors`` [S], each
    shard's own bits, and ``errors`` ORs them."""
    from repro_torch.core import distributed as dist
    dev = state.device
    put = (lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(dev))
    out = dist.sharded_maintain(cfg, mesh, axis, want_plan)(
        state, put(np.asarray(new_cents, np.float32)), put(batch["vecs"]),
        put(batch["ids"]), put(batch["lists"]),
        put(batch["codes"]) if cfg.pq is not None else None,
        put(batch["attrs"]) if cfg.n_attrs else None)
    st, errs = out[0], out[1]
    bits = torch.zeros((), dtype=torch.int32, device=dev)
    for e in errs:
        bits = bits | e
    aux = {"errors": bits,
           "committed": (~torch.any((errs & ABORT_BITS) != 0)).to(
               torch.int32),
           "n_live": st.stacked("n_live").sum(dtype=torch.int32),
           "shard_errors": errs}
    return (st, aux, out[2]) if want_plan else (st, aux)


def read_aux(aux: dict) -> dict:
    """An op's aux scalars on the host, in one copy."""
    keys = ("errors", "committed", "n_live")
    vals = torch.stack([aux[k].reshape(()) for k in keys]).tolist()
    return dict(zip(keys, vals))


def maintain(cfg: SIVFConfig, state: SlabPoolState, op: MaintOp,
             stores=None) -> tuple[SlabPoolState, MaintenanceReport]:
    """Functional single-device maintenance: run one op atomically.

    The session layer (``Index.maintain``) wraps this with the tiered
    plan queue; this entry point is the testable core. Returns the
    (possibly unchanged) state and a report. The state passed in must not
    be used again (the commit updates planes in place).
    """
    views = shard_views(cfg, state, stores)
    gathered = gather_live(cfg, state, views, op.lists)
    plan = plan_op(cfg, op, gathered, state.centroids.cpu().numpy())
    if plan is None:
        return state, MaintenanceReport(op.kind, op.lists,
                                        len(gathered["ids"]), True, 0,
                                        int(state.n_live))
    new_cents, lists = plan
    batch = pad_batch(cfg, gathered, lists, maint_batch_size(cfg))
    if cfg.tiered:
        st, aux, dev_plan = _commit_op(cfg, state, new_cents, batch, True)
        replay_plan_to_store(cfg, stores[0], dev_plan, batch["vecs"],
                             batch["attrs"])
    else:
        st, aux = _commit_op(cfg, state, new_cents, batch)
    aux = read_aux(aux)
    rep = MaintenanceReport(op.kind, op.lists, batch["rows"],
                            bool(aux["committed"]), int(aux["errors"]),
                            int(aux["n_live"]))
    return st, rep


def replay_plan_to_store(cfg: SIVFConfig, store, plan, vecs, attrs) -> None:
    """Mirror a commit plan into the host store (tiered pools).

    The plan names exactly the payload writes the commit applied (-1
    rows wrote nothing). The session layer goes through
    ``TieredRuntime.queue_plan`` instead (same replay + dirty tracking).
    """
    slab = plan["slab"].cpu().numpy()
    rows = np.flatnonzero(slab >= 0)
    if not len(rows):
        return
    slot = plan["slot"].cpu().numpy()
    if cfg.payload_dim:
        store.data[slab[rows], slot[rows]] = \
            np.asarray(vecs)[rows, :cfg.payload_dim]
    if cfg.code_m:
        store.codes[slab[rows], slot[rows]] = \
            plan["codes"].cpu().numpy()[rows]
    if cfg.n_attrs:
        store.attrs[slab[rows], slot[rows]] = np.asarray(attrs)[rows]


# ---------------------------------------------------------------------------
# Drift-triggered policy
# ---------------------------------------------------------------------------

def plan_ops(list_occupancy, cursor: int = 0, max_ops: int = 2,
             skew_hi: float = 2.0, skew_lo: float = 0.25
             ) -> tuple[list[MaintOp], int]:
    """Occupancy-driven maintenance schedule (reads ``stats()`` counters).

    Priority: (1) split the most-skewed list into a near-empty victim,
    (2) merge the two most under-full lists, then (3) round-robin
    recluster from ``cursor``. Returns (ops, advanced cursor).
    """
    occ = np.asarray(list_occupancy, np.int64)
    nl = len(occ)
    ops: list[MaintOp] = []
    mean = float(occ.mean()) if nl else 0.0
    used = set()
    if nl >= 2 and mean > 0:
        hot = int(occ.argmax())
        cold = int(occ.argmin())
        if (occ[hot] > skew_hi * mean and occ[cold] < skew_lo * mean
                and hot != cold and len(ops) < max_ops):
            ops.append(split(hot, cold))
            used.update((hot, cold))
        small = [i for i in np.argsort(occ, kind="stable")
                 if i not in used and occ[i] > 0]
        if (len(small) >= 2 and occ[small[0]] < skew_lo * mean
                and occ[small[1]] < skew_lo * mean and len(ops) < max_ops):
            ops.append(merge(int(small[0]), int(small[1])))
            used.update((int(small[0]), int(small[1])))
    for _ in range(nl):
        if len(ops) >= max_ops:
            break
        cand = cursor % max(nl, 1)
        cursor += 1
        if cand not in used and occ[cand] > 0:
            ops.append(recluster(cand))
            used.add(cand)
    return ops, cursor % max(nl, 1)
