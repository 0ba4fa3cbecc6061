"""Public entry points of the slab scans, dispatched by device.

Counterparts of ``repro/kernels/sivf_scan/ops.py`` (``sivf_scan``, the
unfused scan that writes the whole ``[Q, T*C]`` candidate matrix for
``kernels.topk``, and ``sivf_fused_search``) and of the reference's PQ
dispatch (``repro/core/index.py:601-615``). A CPU tensor takes the plain
version (``ref.py``); a CUDA tensor launches the hand-written kernel
(``sivf_scan.py``, ``fused.py``, ``pq_fused.py``) or raises. There is
no fallback from the card to the plain versions. The launch counts live
on the kernels' wrappers (``sivf_scan.launches``, ``fused.launches``,
``pq_fused.launches`` and the latter two's ``filtered_launches``).

:func:`translate_table` (the reference's, an XLA op there, not a
Pallas kernel) rewrites a slab table into the cache-frame coordinates of
the tiered pool (``core/tiered.py``); the scans then run unchanged on the
frame-indexed planes.

The PQ entry takes a materialized ADC table (``core.pq.adc_tables``),
never queries and codebooks: the table is built once per query batch and
the same tensor scores, whichever implementation runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sivf_scan import fused, pq_fused
from repro_torch.kernels.sivf_scan import sivf_scan as unfused
from repro_torch.kernels.sivf_scan.ref import (
    sivf_fused_search_ref,
    sivf_pq_fused_search_ref,
    sivf_scan_ref,
)


def sivf_scan(queries: torch.Tensor, table: torch.Tensor, data: torch.Tensor,
              ids: torch.Tensor, norms: torch.Tensor, bitmap: torch.Tensor,
              metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Validity-masked slab distance scan (unfused): queries [Q,D], table
    [Q,T] -> (dists [Q,T*C], labels [Q,T*C]); ``+inf`` / ``-1`` for dead
    and padded slots."""
    if queries.device.type == "cpu":
        return sivf_scan_ref(queries, table, data, ids, norms, bitmap, metric)
    return unfused.sivf_scan_cuda(
        queries.contiguous(), table.to(torch.int32).contiguous(), data, ids,
        norms, bitmap, metric)


def sivf_fused_search(queries: torch.Tensor, table: torch.Tensor,
                      data: torch.Tensor, ids: torch.Tensor,
                      norms: torch.Tensor, bitmap: torch.Tensor, k: int,
                      metric: str = "l2", attrs: torch.Tensor | None = None,
                      fstruct: tuple | None = None,
                      fconsts: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan->top-k: queries [Q,D], table [Q,T] -> ([Q,k], [Q,k]).

    ``attrs``/``fstruct``/``fconsts`` add the in-scan predicate mask.
    """
    filt = dict(attrs=attrs, fstruct=fstruct, fconsts=fconsts)
    if queries.device.type == "cpu":
        return sivf_fused_search_ref(queries, table, data, ids, norms,
                                     bitmap, k, metric, **filt)
    return fused.sivf_fused_search_cuda(
        queries.contiguous(), table.to(torch.int32).contiguous(), data, ids,
        norms, bitmap, k, metric, **filt)


def sivf_pq_fused_search(adc: torch.Tensor, table: torch.Tensor,
                         codes: torch.Tensor, ids: torch.Tensor,
                         bitmap: torch.Tensor, k: int,
                         attrs: torch.Tensor | None = None,
                         fstruct: tuple | None = None,
                         fconsts: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ADC scan->top-k: adc [Q,m,ksub], table [Q,T] -> ([Q,k], [Q,k]).

    ``attrs``/``fstruct``/``fconsts`` add the in-scan predicate mask.
    """
    filt = dict(attrs=attrs, fstruct=fstruct, fconsts=fconsts)
    if adc.device.type == "cpu":
        return sivf_pq_fused_search_ref(adc, table, codes, ids, bitmap, k,
                                        **filt)
    return pq_fused.sivf_pq_fused_search_cuda(
        adc.contiguous(), table.to(torch.int32).contiguous(), codes, ids,
        bitmap, k, **filt)


def translate_table(table: torch.Tensor, frame_of: torch.Tensor
                    ) -> torch.Tensor:
    """Rewrite a pool-slab-id table into cache-frame coordinates.

    ``table`` [Q, T] int32 pool slab ids (-1 pad), ``frame_of`` [n_slabs]
    int32 residency map (slab -> frame, -1 cold). Returns the same-shape
    int32 table with each live entry replaced by its frame, pads kept.
    Every live entry must be resident; the tiered prefetch makes it so.
    Both scans order candidates by (distance, t, slot), never by slab id,
    so a translated table scores the same candidates in the same order.
    """
    return torch.where(table >= 0, frame_of[table.clamp(min=0).long()],
                       -1).to(torch.int32)
