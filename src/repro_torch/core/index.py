"""SIVF index operations: batched insert / delete / search (paper §3),
PyTorch counterpart of ``repro/core/index.py``.

The plans are the reference's, line for line: sort-by-list plus segmented
prefix sums give every row of an insert batch a conflict-free
(slab, slot); a delete clears validity bits and reclaims slabs that
dropped to zero occupancy; a search probes the coarse quantizer, turns the
probed lists into a slab table and streams it through the fused
scan->top-k (``kernels/sivf_scan``).

The kernels are imported where they are called, as in the reference,
since they import ``core.bitmap`` themselves.

PyTorch runs eagerly, so where the reference donated the state to ``jit``
these functions **update the state planes in place** and return the state
to use afterwards. The state passed in must not be used again after a
mutation: it may share planes with the returned one.

Every ``.at[...].set(mode="drop")`` of the reference becomes an update
restricted to the rows it would not drop. No ``set`` site has duplicate
target indices among those rows, so results do not depend on the order
in which the card applies writes. Bitmap, cursor and live-count updates
are integer additions (``accumulate=True``), exact in any order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import quantizer
from repro_torch.core.state import (
    ERR_CHAIN_OVERFLOW,
    ERR_ID_RANGE,
    ERR_POOL_EXHAUSTED,
    SIVFConfig,
    SlabPoolState,
    host_live_mask,
    memory_report,
)
from repro_torch.utils import ceil_div, exclusive_cumsum

_I32_MAX = torch.iinfo(torch.int32).max
_I32 = torch.int32

# planes a delete rewrites; the staged overwrite-delete of an insert runs
# on clones of these and shares every payload plane (``data`` above all)
_DELETE_PLANES = ("bitmap", "nxt", "prv", "owner", "cursor", "live", "heads",
                  "free_stack", "free_top", "att_slab", "n_live", "tables",
                  "table_len", "table_pos")


def _first_of_runs(sorted_keys: torch.Tensor) -> torch.Tensor:
    """``True`` where a sorted key differs from its predecessor."""
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return first


def _set_where(plane: torch.Tensor, idx: torch.Tensor, val,
               mask: torch.Tensor) -> None:
    """``plane[idx[mask]] = val[mask]`` for an int32 plane, without a sync.

    Adds ``val - plane[idx]`` where ``mask`` holds and 0 elsewhere. The
    masked-in targets must be distinct and the masked-out ones in range
    (callers clip them), so every target receives at most one non-zero
    addend and the integer result is exact whatever the order.
    """
    delta = torch.where(mask, val - plane[idx], 0).to(plane.dtype)
    plane.index_put_((idx,), delta, accumulate=True)


# ---------------------------------------------------------------------------
# Insert (paper Alg. 1 Insert / Alg. 2)
# ---------------------------------------------------------------------------

def _dedupe_keep_last(ext_ids: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    """Within-batch duplicate ids: keep only the last occurrence."""
    key = torch.where(valid, ext_ids, _I32_MAX)
    ks, order = torch.sort(key, stable=True)     # same ids: ascending position
    keep_sorted = torch.ones_like(valid)
    keep_sorted[:-1] = ks[:-1] != ks[1:]         # last of each run
    keep = torch.empty_like(valid).scatter_(0, order, keep_sorted)
    return valid & keep


def _insert_impl(cfg: SIVFConfig, state: SlabPoolState, vecs: torch.Tensor,
                 ext_ids: torch.Tensor, lists: torch.Tensor
                 ) -> SlabPoolState:
    """All-or-nothing batched insert (reference ``_insert_impl``).

    The overwrite-deletes run on clones of the delete planes (``staged``)
    while ``state`` stays intact; the allocation plan is computed exactly
    on the staged pool. One host read of ``(ok, rows, new slabs)`` then
    picks the outcome: an aborted batch (``POOL_EXHAUSTED`` /
    ``CHAIN_OVERFLOW``) returns ``state`` untouched except for its error
    bits; a committed batch writes its payloads into the shared payload
    planes in place and returns ``staged``.
    """
    b = vecs.shape[0]
    c = cfg.capacity
    ns, nl, nm = cfg.n_slabs, cfg.n_lists, cfg.n_max
    dev = state.device
    ext_ids = ext_ids.to(_I32)

    # -- sanitize ids ------------------------------------------------------
    in_range = (ext_ids >= 0) & (ext_ids < nm)
    err_range = torch.any((~in_range) & (ext_ids != -1))
    valid0 = _dedupe_keep_last(ext_ids, in_range)

    # -- stage delete-then-insert for already-present ids -------------------
    eid0 = torch.where(valid0, ext_ids, 0).long()
    present = valid0 & (state.att_slab[eid0] >= 0)
    staged = dataclasses.replace(
        state, **{f: getattr(state, f).clone() for f in _DELETE_PLANES})
    staged = _delete_impl(cfg, staged, torch.where(present, ext_ids, -1))

    # -- sort batch by target list; rank within list -----------------------
    lists_key = torch.where(valid0, lists.to(_I32), nl)
    sl, order = torch.sort(lists_key, stable=True)             # [B] sorted
    first_ix = torch.searchsorted(sl, sl, side="left")
    rank = (torch.arange(b, device=dev) - first_ix).to(_I32)
    counts = torch.bincount(lists_key, minlength=nl + 1)[:nl].to(_I32)

    # -- per-list capacity plan (segmented prefix sums) --------------------
    heads = staged.heads
    cur_l = torch.where(heads >= 0, staged.cursor[heads.clamp(min=0).long()],
                        c)
    space_l = (c - cur_l).to(_I32)                             # head free slots
    n_new_l = ceil_div((counts - space_l).clamp(min=0), c).to(_I32)
    offs_l = exclusive_cumsum(n_new_l)
    total_new = n_new_l.sum(dtype=_I32)
    pool_ok = total_new <= staged.free_top                     # fail-fast
    chain_ok = torch.all(staged.table_len + n_new_l <= cfg.max_chain)

    # the one host sync of an insert: valid rows are a prefix of the
    # list-sorted batch and new slabs a prefix of the allocation order
    ok, n_valid, n_new = torch.stack(
        [pool_ok & chain_ok, (sl < nl).sum(), total_new]).tolist()
    range_bit = torch.where(err_range, ERR_ID_RANGE, 0).to(_I32)
    if not ok:
        state.error |= (torch.where(pool_ok, 0, ERR_POOL_EXHAUSTED)
                        | torch.where(chain_ok, 0, ERR_CHAIN_OVERFLOW)
                        ).to(_I32) | range_bit
        return state

    # -- per-item coordinates (valid rows only) ----------------------------
    sl, rank = sl[:n_valid].long(), rank[:n_valid]
    rows = order[:n_valid]
    sv, sids = vecs[rows], ext_ids[rows]
    h_item = heads[sl]
    space_item = space_l[sl]
    in_head = (rank < space_item) & (h_item >= 0)
    over = rank - space_item
    new_ord = torch.where(in_head, 0, over // c)
    new_slot = torch.where(in_head, 0, over % c)
    stack_pos = staged.free_top - 1 - (offs_l[sl] + new_ord)
    new_slab = staged.free_stack[stack_pos.clamp(0, ns - 1).long()]
    item_slab = torch.where(in_head, h_item, new_slab).long()
    item_slot = torch.where(in_head, c - space_item + rank, new_slot).long()

    # -- per-new-slab metadata (g = global allocation ordinal) -------------
    if n_new:
        top = staged.free_top
        g = torch.arange(n_new, device=dev, dtype=_I32)
        fs = staged.free_stack
        slab_of_g = fs[(top - 1 - g).long()]
        slab_prev_g = fs[(top - g).clamp(0, ns - 1).long()]
        slab_next_g = fs[(top - 2 - g).clamp(0, ns - 1).long()]
        # new slab g belongs to the list whose allocation range holds g
        list_of_g = torch.searchsorted(offs_l + n_new_l, g, right=True)
        ord_of_g = g - offs_l[list_of_g]
        # chain links: new slab j links next -> (j==0 ? old head : slab
        # j-1); the last new slab of each list becomes its head (Alg. 2)
        nxt_of_g = torch.where(ord_of_g == 0, heads[list_of_g], slab_prev_g)
        prv_of_g = torch.where(ord_of_g == n_new_l[list_of_g] - 1, -1,
                               slab_next_g)
        gi = slab_of_g.long()
        staged.nxt[gi] = nxt_of_g
        staged.prv[gi] = prv_of_g.to(_I32)
        staged.owner[gi] = list_of_g.to(_I32)
        staged.cursor[gi] = 0
        staged.live[gi] = 0
        staged.bitmap[gi] = 0
        # per-list head relink
        has_new = n_new_l > 0
        first_new_l = slab_of_g[offs_l.clamp(0, n_new - 1).long()]
        last_new_l = slab_of_g[(offs_l + n_new_l - 1).clamp(0, n_new - 1)
                               .long()]
        _set_where(staged.prv, heads.clamp(min=0).long(), first_new_l,
                   has_new & (heads >= 0))
        staged.heads = torch.where(has_new, last_new_l, heads)
        # dense chain tables (maintained incrementally)
        pos_g = staged.table_len[list_of_g] + ord_of_g
        staged.tables[list_of_g, pos_g.clamp(0, cfg.max_chain - 1).long()] \
            = slab_of_g
        staged.table_pos[gi] = pos_g
        staged.table_len += n_new_l
        staged.free_top -= n_new

    # -- payload writes + publication (distinct bits per word: add == OR) --
    staged.data[item_slab, item_slot] = sv[:, :cfg.payload_dim].to(cfg.dtype)
    staged.ids[item_slab, item_slot] = sids
    staged.norms[item_slab, item_slot] = torch.sum(
        sv.to(torch.float32) ** 2, dim=-1)
    word, bit = bm.slot_word_bit(item_slot)
    staged.bitmap.index_put_((item_slab, word), bit, accumulate=True)
    one = torch.ones_like(item_slab, dtype=_I32)
    staged.cursor.index_put_((item_slab,), one, accumulate=True)
    staged.live.index_put_((item_slab,), one, accumulate=True)
    staged.att_slab[sids.long()] = item_slab.to(_I32)
    staged.att_slot[sids.long()] = item_slot.to(_I32)
    staged.n_live += n_valid
    staged.error |= range_bit
    return staged


def insert(cfg: SIVFConfig, state: SlabPoolState, vecs: torch.Tensor,
           ext_ids: torch.Tensor, lists: torch.Tensor | None = None
           ) -> SlabPoolState:
    """Batched ingest. ``vecs`` [B, D], ``ext_ids`` [B] (-1 rows = padding).

    ``lists`` may pre-route vectors; otherwise the coarse quantizer
    assigns. Updates ``state`` in place; use the returned state.
    """
    vecs = vecs.to(cfg.dtype)
    if lists is None:
        lists = quantizer.assign(state.centroids, vecs, cfg.metric)
    return _insert_impl(cfg, state, vecs, ext_ids, lists)


# ---------------------------------------------------------------------------
# Delete (paper Alg. 1 Delete / Alg. 4)
# ---------------------------------------------------------------------------

def _delete_impl(cfg: SIVFConfig, state: SlabPoolState,
                 ext_ids: torch.Tensor) -> SlabPoolState:
    """Batched delete, in place and without a host sync.

    The reference walks every batch row in a ``fori_loop``
    (``repro/core/index.py:361``). Its loop condition reads only
    ``owner[s_i]``, which only row ``i``'s own slab resets, so the rows
    that reclaim a slab are computed here at once: a row reclaims its slab
    iff it deleted a live entry, the slab's live count is now 0, the slab
    is owned, and no earlier row deleted from the same slab ("earlier" in
    the id-sorted order the reference loop walks). The unlink and
    swap-with-last of those slabs, which must run in that order, go to
    ``kernels/reclaim``.
    """
    nm = cfg.n_max
    ext_ids = ext_ids.to(_I32)
    valid = (ext_ids >= 0) & (ext_ids < nm)
    # dedupe (paper: repeated deletes are idempotent, Thm 3.3)
    ke = torch.sort(torch.where(valid, ext_ids, _I32_MAX), stable=True).values
    act0 = _first_of_runs(ke) & (ke != _I32_MAX)
    ke_c = torch.where(act0, ke, 0).long()
    s = state.att_slab[ke_c]                                   # [B]
    o = state.att_slot[ke_c]
    act = act0 & (s >= 0)                                      # live entries

    # -- logical deletion: clear validity bits (linearization point) -------
    s_c = torch.where(act, s, 0).long()
    word, bit = bm.slot_word_bit(o)
    clear = torch.zeros_like(state.bitmap).index_put_(
        (s_c, torch.where(act, word, 0).long()), torch.where(act, bit, 0),
        accumulate=True)
    state.bitmap &= ~clear
    state.live.index_put_((s_c,), -act.to(_I32), accumulate=True)
    _set_where(state.att_slab, ke_c, -1, act)
    state.n_live -= act.sum(dtype=_I32)

    # -- slab-wise reclamation (Alg. 4 lines 15-19) -------------------------
    first_in_slab = torch.empty_like(act)
    ks, ko = torch.sort(torch.where(act, s, _I32_MAX), stable=True)
    first_in_slab.scatter_(0, ko, _first_of_runs(ks))
    do = act & (state.live[s_c] == 0) & (state.owner[s_c] >= 0) \
        & first_in_slab
    # reclaimed slabs first, in row order; the count stays on the device
    from repro_torch.kernels.reclaim.ops import reclaim_slabs
    slabs = s[torch.argsort((~do).to(torch.uint8), stable=True)]
    reclaim_slabs(state, slabs, do.sum(dtype=_I32).reshape(1))
    return state


def delete(cfg: SIVFConfig, state: SlabPoolState, ext_ids: torch.Tensor
           ) -> SlabPoolState:
    """Batched lazy eviction. ``ext_ids`` [B]; -1 entries are no-ops."""
    return _delete_impl(cfg, state, ext_ids)


# ---------------------------------------------------------------------------
# Search (paper Alg. 3)
# ---------------------------------------------------------------------------

def walk_chains(cfg: SIVFConfig, state: SlabPoolState, lists: torch.Tensor
                ) -> torch.Tensor:
    """Paper-faithful pointer walk: lists [Q, P] -> slab table [Q, P*T].

    ``max_chain`` gathers over ``nxt`` with the Alg. 3 traversal bound and
    self-loop guard. -1 pads exhausted chains.
    """
    s = torch.where(lists >= 0, state.heads[lists.clamp(min=0).long()], -1)
    seq = []
    for _ in range(cfg.max_chain):
        seq.append(s)
        n = torch.where(s >= 0, state.nxt[s.clamp(min=0).long()], -1)
        s = torch.where(n == s, -1, n)               # self-loop guard
    return torch.stack(seq, dim=-1).reshape(lists.shape[0], -1)


def gather_tables(cfg: SIVFConfig, state: SlabPoolState, lists: torch.Tensor
                  ) -> torch.Tensor:
    """Dense-table path: one gather, no pointer chasing."""
    t = torch.where(lists.unsqueeze(-1) >= 0,
                    state.tables[lists.clamp(min=0).long()], -1)  # [Q, P, T]
    return t.reshape(lists.shape[0], -1)


def scan_slabs_topk(cfg: SIVFConfig, state: SlabPoolState,
                    queries: torch.Tensor, table: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Validity-masked distance scan + streaming top-k, plain PyTorch.

    The reference's column-by-column scan (``repro/core/index.py:468``);
    it runs on any device and is what the fused kernel is held against.
    """
    from repro_torch.kernels.sivf_scan.ref import sivf_fused_search_ref
    return sivf_fused_search_ref(
        queries.to(torch.float32), table, state.data, state.ids, state.norms,
        state.bitmap, k, metric=cfg.metric)


def _scan_dispatch(cfg: SIVFConfig, state: SlabPoolState,
                   queries: torch.Tensor, table: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route a slab table through the fused scan->top-k for its device.

    A CPU state takes the plain version; a CUDA state launches the
    hand-written kernel (``kernels/sivf_scan/fused.py``) or raises. This
    replaces the reference's ``impl="xla" | "pallas"`` switch.
    """
    from repro_torch.kernels.sivf_scan.ops import sivf_fused_search
    return sivf_fused_search(
        queries.to(torch.float32), table, state.data, state.ids, state.norms,
        state.bitmap, k, metric=cfg.metric)


def search(cfg: SIVFConfig, state: SlabPoolState, queries: torch.Tensor,
           k: int, nprobe: int, use_tables: bool | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k search. queries [Q, D] -> (distances [Q, k], labels [Q, k]).

    ``use_tables`` selects the dense-table slab lookup (default from the
    config) or the pointer walk; both feed the same fused scan->top-k.
    """
    ut = cfg.track_tables if use_tables is None else use_tables
    queries = queries.to(cfg.dtype)
    lists = quantizer.probe(state.centroids, queries, nprobe, cfg.metric)
    table = (gather_tables if ut else walk_chains)(cfg, state, lists)
    return _scan_dispatch(cfg, state, queries, table, k)


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def _memory_stats(cfg: SIVFConfig) -> dict:
    """Pool memory footprint (one source of truth: ``memory_report``)."""
    mr = memory_report(cfg)
    return {k: mr[k] for k in ("payload_bytes", "code_bytes", "attr_bytes",
                               "host_bytes", "device_bytes",
                               "device_cache_bytes")}


def stats(cfg: SIVFConfig, state: SlabPoolState) -> dict:
    """Occupancy / fragmentation report (paper §5.6.2)."""
    occ = _list_occupancy(cfg, state)
    free_top, n_live, error = torch.stack(
        [state.free_top, state.n_live, state.error]).tolist()
    table_len = state.table_len.cpu().numpy()
    used = cfg.n_slabs - free_top
    alloc_slots = used * cfg.capacity
    return {
        "n_live": n_live,
        "slabs_used": used,
        "free_slabs": free_top,
        "alloc_slots": alloc_slots,
        "fill_frac": n_live / max(alloc_slots, 1),
        "error": error,
        "max_chain_len": int(table_len.max()),
        "mean_chain_len": float(table_len.mean()),
        "list_occupancy": occ.tolist(),
        "list_skew": float(occ.max() / occ.mean()) if occ.any() else 0.0,
        **_memory_stats(cfg),
    }


def _list_occupancy(cfg: SIVFConfig, state: SlabPoolState) -> np.ndarray:
    """Exact per-list live-row counts, recounted from bitmaps + ownership."""
    owner = state.owner.cpu().numpy()
    per_slab = host_live_mask(cfg, state.bitmap).sum(-1)
    occ = np.zeros((cfg.n_lists,), np.int64)
    sel = owner >= 0
    np.add.at(occ, owner[sel], per_slab[sel])
    return occ
