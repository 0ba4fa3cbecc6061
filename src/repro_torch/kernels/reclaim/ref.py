"""Plain version of slab reclamation: the sequential loop, on the CPU.

The body of the reference's ``fori_loop`` in
``repro/core/index.py::_delete_impl`` (``index.py:361-401``), run only
over the slabs a delete batch reclaims, in row order. It updates the
planes in place through numpy views of the CPU tensors.
"""
from __future__ import annotations

import torch


def reclaim_ref(slabs: torch.Tensor, count: torch.Tensor,
                heads: torch.Tensor, nxt: torch.Tensor, prv: torch.Tensor,
                owner: torch.Tensor, cursor: torch.Tensor,
                free_stack: torch.Tensor, free_top: torch.Tensor,
                tables: torch.Tensor, table_len: torch.Tensor,
                table_pos: torch.Tensor) -> None:
    """Unlink, swap-with-last and push ``slabs[:count]`` (int32 CPU planes)."""
    heads_, nxt_, prv_, owner_ = (t.numpy() for t in (heads, nxt, prv, owner))
    cursor_, stack_, tables_ = (t.numpy() for t in (cursor, free_stack, tables))
    tlen_, tpos_ = table_len.numpy(), table_pos.numpy()
    top = int(free_top)
    for si in slabs[:int(count.reshape(()))].tolist():
        li = int(owner_[si])
        p, n = int(prv_[si]), int(nxt_[si])
        # unlink
        if p < 0:
            heads_[li] = n
        else:
            nxt_[p] = n
        if n >= 0:
            prv_[n] = p
        # dense-table removal: swap-with-last
        pos = max(int(tpos_[si]), 0)
        last = max(int(tlen_[li]) - 1, 0)
        moved = int(tables_[li, last])
        tables_[li, pos] = moved
        tables_[li, last] = -1
        if moved >= 0:
            tpos_[moved] = pos
        tpos_[si] = -1
        tlen_[li] -= 1
        # recycle (instant reuse; paper §3.1 "immediate reclamation")
        stack_[top] = si
        top += 1
        owner_[si] = -1
        cursor_[si] = 0
        nxt_[si] = -1
        prv_[si] = -1
    free_top.fill_(top)
