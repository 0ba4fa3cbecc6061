"""SIVF index operations: batched insert / delete / search (paper §3),
PyTorch counterpart of ``repro/core/index.py``.

The plans are the reference's, line for line: sort-by-list plus segmented
prefix sums give every row of an insert batch a conflict-free
(slab, slot); a delete clears validity bits and reclaims slabs that
dropped to zero occupancy; a search probes the coarse quantizer, turns the
probed lists into a slab table and streams it through the fused
scan->top-k (``kernels/sivf_scan``). With ``cfg.pq`` set, inserts encode
each batch to uint8 codes once and searches score the codes by ADC
against one table per query batch; with ``cfg.attributes`` set, inserts
stamp each row's attributes and a compiled predicate masks slots inside
the scan, before the top-k fold.

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
from repro_torch.core import pq as pqmod
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
from repro_torch.obs.trace import OFF
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


class _InsertStage:
    """An insert batch up to its commit decision (:func:`_insert_stage`)."""

    __slots__ = ("vecs", "ext_ids", "staged", "reclaimed", "sl", "order",
                 "rank", "space_l", "n_new_l", "offs_l", "pool_ok",
                 "chain_ok", "range_bit", "decision")


def _insert_stage(cfg: SIVFConfig, state: SlabPoolState, vecs: torch.Tensor,
                  ext_ids: torch.Tensor, lists: torch.Tensor) -> _InsertStage:
    """The first half of an insert, on the device and without a host read.

    Sanitizes the ids, stages the overwrite-deletes on clones of the
    delete planes (``state`` stays intact), sorts the batch by list and
    plans each list's capacity. ``decision`` is the int64 device vector
    ``(ok, valid rows, new slabs)`` that :func:`_insert_commit` needs on
    the host: a mesh reads every shard's in one copy. ``reclaimed`` is
    the device count of slabs the staged overwrite-deletes reclaim, which
    the pool gives up only if the batch commits.
    """
    b = vecs.shape[0]
    c = cfg.capacity
    nl, nm = cfg.n_lists, cfg.n_max
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
    staged, reclaimed = _delete_impl(cfg, staged,
                                     torch.where(present, ext_ids, -1))

    # -- sort batch by target list; rank within list -----------------------
    lists_key = torch.where(valid0, lists.to(_I32), nl)
    sl, order = torch.sort(lists_key, stable=True)             # [B] sorted
    first_ix = torch.searchsorted(sl, sl, side="left")
    rank = (torch.arange(b, device=dev) - first_ix).to(_I32)
    # per-list counts by integer adds (exact in any order); unlike
    # ``bincount`` this reads no device value on the host
    counts = torch.zeros((nl + 1,), dtype=_I32, device=dev).index_add_(
        0, lists_key.long(), torch.ones_like(lists_key))[:nl]

    # -- per-list capacity plan (segmented prefix sums) --------------------
    heads = staged.heads
    cur_l = torch.where(heads >= 0, staged.cursor[heads.clamp(min=0).long()],
                        c)
    space_l = (c - cur_l).to(_I32)                             # head free slots
    n_new_l = ceil_div((counts - space_l).clamp(min=0), c).to(_I32)
    total_new = n_new_l.sum(dtype=_I32)

    st = _InsertStage()
    st.vecs, st.ext_ids, st.staged = vecs, ext_ids, staged
    st.reclaimed = reclaimed
    st.sl, st.order, st.rank = sl, order, rank
    st.space_l, st.n_new_l = space_l, n_new_l
    st.offs_l = exclusive_cumsum(n_new_l)
    st.pool_ok = total_new <= staged.free_top                  # fail-fast
    st.chain_ok = torch.all(staged.table_len + n_new_l <= cfg.max_chain)
    st.range_bit = torch.where(err_range, ERR_ID_RANGE, 0).to(_I32)
    # valid rows are a prefix of the list-sorted batch and new slabs a
    # prefix of the allocation order: three numbers place every write
    st.decision = torch.stack([(st.pool_ok & st.chain_ok).long(),
                               (sl < nl).sum(), total_new.long()])
    return st


def _stage_error_bits(st: _InsertStage) -> torch.Tensor:
    """The error bits the staged batch raises if it aborts (device int32)."""
    return (torch.where(st.pool_ok, 0, ERR_POOL_EXHAUSTED)
            | torch.where(st.chain_ok, 0, ERR_CHAIN_OVERFLOW)
            ).to(_I32) | st.range_bit


def _insert_commit(cfg: SIVFConfig, state: SlabPoolState, st: _InsertStage,
                   decision, codes: torch.Tensor | None = None,
                   attrs: torch.Tensor | None = None,
                   want_plan: bool = False):
    """The second half of an insert: ``decision`` is ``st.decision`` read
    on the host as ``(ok, n_valid, n_new)``. An aborted batch returns
    ``state`` untouched except for its error bits; a committed one writes
    its payloads into the shared payload planes in place and returns the
    staged state. See :func:`_insert_impl` for ``want_plan``."""
    ok, n_valid, n_new = (int(x) for x in decision)
    b = st.vecs.shape[0]
    c = cfg.capacity
    ns = cfg.n_slabs
    dev = state.device
    staged, heads = st.staged, st.staged.heads
    if want_plan:
        plan = {"slab": torch.full((b,), -1, dtype=_I32, device=dev),
                "slot": torch.zeros((b,), dtype=_I32, device=dev),
                "codes": torch.zeros((b, cfg.code_m), dtype=torch.uint8,
                                     device=dev)}
    if not ok:
        state.error |= _stage_error_bits(st)
        return (state, plan) if want_plan else state

    # -- per-item coordinates (valid rows only) ----------------------------
    space_l, n_new_l, offs_l = st.space_l, st.n_new_l, st.offs_l
    sl, rank = st.sl[:n_valid].long(), st.rank[:n_valid]
    rows = st.order[:n_valid]
    sv, sids = st.vecs[rows], st.ext_ids[rows]
    if cfg.pq is not None:
        new_codes = pqmod.encode(staged.pq_codebooks, sv) if codes is None \
            else codes[rows].to(torch.uint8)
    if cfg.n_attrs:
        sattrs = torch.zeros((n_valid, cfg.n_attrs), dtype=_I32,
                             device=dev) if attrs is None \
            else attrs[rows].to(_I32)
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
        # index_fill_, not ``[gi] = 0``: a Python scalar assigned through an
        # index tensor is copied to the device first, and the host waits
        for plane in (staged.cursor, staged.live, staged.bitmap):
            plane.index_fill_(0, gi, 0)
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
    if cfg.payload_slabs:              # tiered: the host store replays them
        if cfg.payload_dim:
            staged.data[item_slab, item_slot] = sv.to(cfg.dtype)
        if cfg.pq is not None:
            staged.codes[item_slab, item_slot] = new_codes
        if cfg.n_attrs:
            staged.attrs[item_slab, item_slot] = sattrs
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
    staged.error |= st.range_bit
    if not want_plan:
        return staged
    plan["slab"][rows] = item_slab.to(_I32)
    plan["slot"][rows] = item_slot.to(_I32)
    if cfg.pq is not None:
        plan["codes"][rows] = new_codes
    return staged, plan


def _insert_impl(cfg: SIVFConfig, state: SlabPoolState, vecs: torch.Tensor,
                 ext_ids: torch.Tensor, lists: torch.Tensor,
                 codes: torch.Tensor | None = None,
                 attrs: torch.Tensor | None = None,
                 want_plan: bool = False):
    """All-or-nothing batched insert (reference ``_insert_impl``).

    The overwrite-deletes run on clones of the delete planes (``staged``)
    while ``state`` stays intact; the allocation plan is computed exactly
    on the staged pool. One host read of ``(ok, rows, new slabs)`` then
    picks the outcome: an aborted batch (``POOL_EXHAUSTED`` /
    ``CHAIN_OVERFLOW``) returns ``state`` untouched except for its error
    bits; a committed batch writes its payloads into the shared payload
    planes in place and returns ``staged``.

    With ``cfg.pq``, ``codes`` [B, m] may carry pre-encoded codewords;
    omitted, the batch's rows are encoded once. With ``cfg.attributes``,
    ``attrs`` [B, n_attrs] stamps each row (zeros when omitted). Both ride
    the batch's sort and its commit; an aborted batch writes neither.

    With ``want_plan=True`` (the tiered pool, ``core/tiered.py``) the
    return value is ``(state, plan)``: ``plan["slab"]`` / ``plan["slot"]``
    [B] int32 give the (slab, slot) the commit wrote for each *input*
    row, slab -1 (slot 0) for padding rows, ids out of range, rows
    superseded by a later duplicate and every row of an aborted batch;
    ``plan["codes"]`` [B, code_m] uint8 holds the device-encoded PQ codes
    in input order (zeros where the slab is -1). The plan stays on the
    device. In tiered mode (``cfg.payload_slabs == 0``) the payload
    planes are zero-width and their writes are skipped: the host store
    replays them from the plan.
    """
    st = _insert_stage(cfg, state, vecs, ext_ids, lists)
    # the one host read of an insert
    return _insert_commit(cfg, state, st, st.decision.tolist(), codes, attrs,
                          want_plan)


def insert(cfg: SIVFConfig, state: SlabPoolState, vecs: torch.Tensor,
           ext_ids: torch.Tensor, lists: torch.Tensor | None = None,
           codes: torch.Tensor | None = None,
           attrs: torch.Tensor | None = None) -> SlabPoolState:
    """Batched ingest. ``vecs`` [B, D], ``ext_ids`` [B] (-1 rows = padding).

    ``lists`` may pre-route vectors; otherwise the coarse quantizer
    assigns. With ``cfg.pq``, ``codes`` may carry pre-encoded codewords;
    otherwise the batch encodes on ingest. With ``cfg.attributes``,
    ``attrs`` [B, n_attrs] stamps filter attributes (zeros when omitted).
    Updates ``state`` in place; use the returned state.
    """
    vecs = vecs.to(cfg.dtype)
    if lists is None:
        lists = quantizer.assign(state.centroids, vecs, cfg.metric)
    return _insert_impl(cfg, state, vecs, ext_ids, lists, codes, attrs)


# ---------------------------------------------------------------------------
# Delete (paper Alg. 1 Delete / Alg. 4)
# ---------------------------------------------------------------------------

def _delete_impl(cfg: SIVFConfig, state: SlabPoolState,
                 ext_ids: torch.Tensor
                 ) -> tuple[SlabPoolState, torch.Tensor]:
    """Batched delete, in place and without a host sync: the state and
    the number of slabs the batch reclaimed (a device int32 scalar).

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
    n_reclaimed = do.sum(dtype=_I32)
    reclaim_slabs(state, slabs, n_reclaimed.reshape(1))
    return state, n_reclaimed


def delete(cfg: SIVFConfig, state: SlabPoolState, ext_ids: torch.Tensor
           ) -> SlabPoolState:
    """Batched lazy eviction. ``ext_ids`` [B]; -1 entries are no-ops."""
    return _delete_impl(cfg, state, ext_ids)[0]


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
                    queries: torch.Tensor, table: torch.Tensor, k: int,
                    fstruct: tuple | None = None,
                    fconsts: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Validity-masked distance scan + streaming top-k, plain PyTorch.

    The reference's column-by-column scan (``repro/core/index.py:468``);
    it runs on any device and is what the fused kernel is held against.
    ``fstruct``/``fconsts`` (a compiled predicate, ``core/filters.py``)
    mask failing slots like deleted ones, before the fold.
    """
    from repro_torch.kernels.sivf_scan.ref import sivf_fused_search_ref
    return sivf_fused_search_ref(
        queries.to(torch.float32), table, state.data, state.ids, state.norms,
        state.bitmap, k, metric=cfg.metric, attrs=state.attrs,
        fstruct=fstruct, fconsts=fconsts)


def scan_slabs_topk_pq(cfg: SIVFConfig, state: SlabPoolState,
                       queries: torch.Tensor, table: torch.Tensor, k: int,
                       adc: torch.Tensor | None = None,
                       fstruct: tuple | None = None,
                       fconsts: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """ADC scan + streaming top-k over PQ codes, plain PyTorch
    (``repro/core/index.py:516``).

    A slot's distance is the sum of its ``m`` lookups in its query's ADC
    table, in ascending subspace order; fed the same ``adc`` tensor, the
    PQ kernel and the reference's scan agree with it bit for bit. The
    table is built here when ``adc`` is omitted.
    """
    from repro_torch.kernels.sivf_scan.ref import sivf_pq_fused_search_ref
    if adc is None:
        adc = pqmod.adc_tables(state.pq_codebooks, queries, cfg.metric)
    return sivf_pq_fused_search_ref(
        adc, table, state.codes, state.ids, state.bitmap, k,
        attrs=state.attrs, fstruct=fstruct, fconsts=fconsts)


def _scan_dispatch(cfg: SIVFConfig, state: SlabPoolState,
                   queries: torch.Tensor, table: torch.Tensor, k: int,
                   fstruct: tuple | None = None,
                   fconsts: torch.Tensor | None = None,
                   adc: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route a slab table through the fused scan->top-k for its device.

    A CPU state takes the plain versions; a CUDA state launches the
    hand-written kernels (``kernels/sivf_scan/fused.py``,
    ``kernels/sivf_scan/pq_fused.py``) or raises. This replaces the
    reference's ``impl="xla" | "pallas"`` switch. With ``cfg.pq`` the ADC
    table (``adc``, built here when omitted) is built once per query
    batch and that one table scores.
    """
    if fstruct is not None and cfg.n_attrs == 0:
        raise ValueError("filtered search needs SIVFConfig(attributes=...)")
    from repro_torch.kernels.sivf_scan import ops
    filt = dict(attrs=state.attrs, fstruct=fstruct, fconsts=fconsts)
    if cfg.pq is not None:
        if adc is None:
            adc = pqmod.adc_tables(state.pq_codebooks, queries, cfg.metric)
        return ops.sivf_pq_fused_search(adc, table, state.codes, state.ids,
                                        state.bitmap, k, **filt)
    return ops.sivf_fused_search(
        queries.to(torch.float32), table, state.data, state.ids, state.norms,
        state.bitmap, k, metric=cfg.metric, **filt)


def search(cfg: SIVFConfig, state: SlabPoolState, queries: torch.Tensor,
           k: int, nprobe: int, use_tables: bool | None = None,
           fstruct: tuple | None = None, fconsts: torch.Tensor | None = None,
           tel=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k search. queries [Q, D] -> (distances [Q, k], labels [Q, k]).

    ``use_tables`` selects the dense-table slab lookup (default from the
    config) or the pointer walk; both feed the same fused scan->top-k.
    ``fstruct``/``fconsts`` come from ``filters.compile_filter`` (the
    constants as an int32 tensor on the state's device). With ``tel`` (a
    ``repro_torch.obs.Telemetry``) each stage is a span timed on the
    device too: ``probe``, ``tables``, ``adc`` (PQ only) and ``scan``.
    """
    ut = cfg.track_tables if use_tables is None else use_tables
    span = (OFF if tel is None else tel).span
    dev = state.device
    queries = queries.to(cfg.dtype)
    with span("probe", device=dev):
        lists = quantizer.probe(state.centroids, queries, nprobe, cfg.metric)
    with span("tables", device=dev):
        table = (gather_tables if ut else walk_chains)(cfg, state, lists)
    adc = None
    if cfg.pq is not None:
        with span("adc", device=dev):
            adc = pqmod.adc_tables(state.pq_codebooks, queries, cfg.metric)
    with span("scan", device=dev):
        return _scan_dispatch(cfg, state, queries, table, k, fstruct,
                              fconsts, adc)


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def _memory_stats(cfg: SIVFConfig, n_shards: int = 1) -> dict:
    """Pool memory footprint (one source of truth: ``memory_report``), the
    per-pool planes scaled by the shard count; ``compression_ratio``
    (shard-count invariant) only with PQ."""
    mr = memory_report(cfg)
    out = {k: mr[k] * n_shards
           for k in ("payload_bytes", "code_bytes", "attr_bytes",
                     "host_bytes", "device_bytes", "device_cache_bytes")}
    if cfg.pq is not None:
        out["compression_ratio"] = mr["compression_ratio"]
    return out


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
    """Exact per-list live-row counts, recounted from bitmaps + ownership
    (of one pool, or summed over a mesh's stacked ``[S, ...]`` planes)."""
    owner = state.owner.cpu().numpy()
    per_slab = host_live_mask(cfg, state.bitmap).sum(-1)
    occ = np.zeros((cfg.n_lists,), np.int64)
    sel = owner >= 0
    np.add.at(occ, owner[sel], per_slab[sel])
    return occ
