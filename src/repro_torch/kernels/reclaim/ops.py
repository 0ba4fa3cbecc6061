"""Slab reclamation dispatched by device: the plain loop for a CPU state,
the CUDA kernel for a CUDA state (no fallback between them)."""
from __future__ import annotations

import torch

from repro_torch.kernels.reclaim.reclaim import reclaim_cuda
from repro_torch.kernels.reclaim.ref import reclaim_ref


def reclaim_slabs(state, slabs: torch.Tensor, count: torch.Tensor) -> None:
    """Reclaim ``slabs[:count]`` of ``state`` (a ``SlabPoolState``) in place.

    ``slabs`` [B] int32 holds the reclaimed slabs first, in batch-row
    order; ``count`` [1] int32 says how many there are.
    """
    run = reclaim_ref if slabs.device.type == "cpu" else reclaim_cuda
    run(slabs, count, state.heads, state.nxt, state.prv,
        state.owner, state.cursor, state.free_stack, state.free_top,
        state.tables, state.table_len, state.table_pos)
