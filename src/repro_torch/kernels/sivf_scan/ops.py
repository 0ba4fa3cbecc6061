"""Public entry point of the fused scan->top-k, dispatched by device.

Counterpart of ``repro/kernels/sivf_scan/ops.py::sivf_fused_search``. A
CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the hand-written kernel (``fused.py``) or raises. There is no fallback
from the card to the plain version. The launch count lives on the
kernel's wrapper: ``fused.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sivf_scan import fused
from repro_torch.kernels.sivf_scan.ref import sivf_fused_search_ref


def sivf_fused_search(queries: torch.Tensor, table: torch.Tensor,
                      data: torch.Tensor, ids: torch.Tensor,
                      norms: torch.Tensor, bitmap: torch.Tensor, k: int,
                      metric: str = "l2"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan->top-k: queries [Q,D], table [Q,T] -> ([Q,k], [Q,k])."""
    if queries.device.type == "cpu":
        return sivf_fused_search_ref(queries, table, data, ids, norms,
                                     bitmap, k, metric)
    return fused.sivf_fused_search_cuda(
        queries.contiguous(), table.to(torch.int32).contiguous(), data, ids,
        norms, bitmap, k, metric)
