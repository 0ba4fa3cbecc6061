"""Slab-paged KV cache: the paper's slab memory manager applied to serving.

Counterpart of ``repro/serve/kv_cache.py``, with the same mapping from
SIVF to the KV cache:

  =====================  =====================================
  SIVF                   paged KV cache
  =====================  =====================================
  slab pool              page pool  [n_pages, page, Hkv, dh]
  global free stack      page free stack + top
  address table (ATT)    per-sequence block table [B, max_pages]
  validity bitmap        (start, length) live window per sequence
  lazy eviction (Alg.4)  O(1) sequence eviction / sliding-window
                         page drop: pages pushed back to the stack,
                         no data movement
  =====================  =====================================

The state is seven tensors on one device. The operations are tensor ops
on that device and update the state in place (the reference donates its
buffers to ``jit``), returning it as the reference returns its new state.
The reference's ``mode="drop"`` scatters become masked writes of the
entries that do write; their targets are distinct (a page sits in one
table row, a stack slot takes one page), so no write depends on the
order a card runs it in. ``allocate`` reads its ``ok`` on the host, as
the reference's engine does right after each call.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import resolve_device

PLANES = ("tables", "lengths", "starts", "offsets", "active", "free_stack",
          "free_top")


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    n_pages: int
    page_size: int
    max_pages_per_seq: int
    max_seqs: int


@dataclasses.dataclass
class PageState:
    tables: torch.Tensor      # [max_seqs, max_pages] int32 page ids (-1)
    lengths: torch.Tensor     # [max_seqs] int32 tokens written (cache coords)
    starts: torch.Tensor      # [max_seqs] int32 window start (cache coords)
    offsets: torch.Tensor     # [max_seqs] int32 absolute-position offset
                              #   (tokens dropped by sliding windows so far)
    active: torch.Tensor      # [max_seqs] bool
    free_stack: torch.Tensor  # [n_pages] int32
    free_top: torch.Tensor    # [] int32


def init_page_state(cfg: PagedKVConfig, device="cuda") -> PageState:
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return PageState(
        tables=torch.full((cfg.max_seqs, cfg.max_pages_per_seq), -1, **i32),
        lengths=torch.zeros((cfg.max_seqs,), **i32),
        starts=torch.zeros((cfg.max_seqs,), **i32),
        offsets=torch.zeros((cfg.max_seqs,), **i32),
        active=torch.zeros((cfg.max_seqs,), dtype=torch.bool, device=dev),
        free_stack=torch.arange(cfg.n_pages, **i32),
        free_top=torch.tensor(cfg.n_pages, **i32),
    )


def allocate(cfg: PagedKVConfig, st: PageState, seq: int, n_new: int
             ) -> tuple[PageState, bool]:
    """Pop ``n_new`` pages for ``seq`` (paper Alg. 1 Allocate) onto the end
    of its table row and mark it active. Returns (state, ok); when the pool
    or the row has no room, ``ok`` is False and the state is unchanged."""
    have = int((st.tables[seq] >= 0).sum())
    top = int(st.free_top)
    if not (top >= n_new and have + n_new <= cfg.max_pages_per_seq):
        return st, False
    idx = torch.arange(n_new, device=st.tables.device)
    st.tables[seq, have:have + n_new] = st.free_stack[top - 1 - idx]
    st.active[seq] = True
    st.free_top -= n_new
    return st, True


def _push(cfg: PagedKVConfig, st: PageState, pages: torch.Tensor) -> None:
    """Push ``pages`` (in order) onto the free stack."""
    n = pages.numel()
    top = st.free_top.long()
    dst = top + torch.arange(n, device=pages.device)
    st.free_stack[dst] = pages
    st.free_top += n


def evict_seq(cfg: PagedKVConfig, st: PageState, seq: int) -> PageState:
    """O(1) sequence eviction (paper Alg. 4): push the sequence's pages
    back onto the free stack in table order; no data movement."""
    row = st.tables[seq]
    _push(cfg, st, row[row >= 0])
    st.tables[seq] = -1
    st.lengths[seq] = 0
    st.starts[seq] = 0
    st.offsets[seq] = 0
    st.active[seq] = False
    return st


def slide_window(cfg: PagedKVConfig, st: PageState, seq: int, new_start
                 ) -> PageState:
    """Sliding-window eviction: free the whole pages of ``seq`` that fall
    before ``new_start`` (the paper's streaming-window eviction, §5.5),
    compact its table row and shift its window into the new coordinates."""
    row = st.tables[seq]
    first_live_page = new_start // cfg.page_size
    pidx = torch.arange(cfg.max_pages_per_seq, device=row.device)
    used = row >= 0
    drop = (pidx < first_live_page) & used
    n = drop.sum().to(torch.int32)
    _push(cfg, st, row[drop])
    kept = row[~drop & used]
    new_row = torch.full_like(row, -1)
    new_row[:kept.numel()] = kept
    st.tables[seq] = new_row
    shift = n * cfg.page_size
    st.lengths[seq] -= shift
    st.starts[seq] = new_start - shift
    st.offsets[seq] += shift
    return st


def pages_needed(length, add: int, page: int):
    """Pages to allocate so ``length + add`` tokens fit."""
    return (length + add + page - 1) // page - (length + page - 1) // page
