"""Plain PyTorch fused search: the oracle for ``fused.py``'s CUDA kernel.

Counterpart of ``repro/kernels/sivf_scan/ref.py`` plus the running top-k
fold of ``repro/kernels/sivf_scan/fused.py:61-91`` and
``repro/core/index.py:468-513``: the slab table is scanned column by
column, and each column's ``[Q, C]`` masked candidates are folded into a
running ``[Q, k]`` list. The merge row is ``[running k | C candidates in
slot order]`` and a *stable* sort keeps the lowest merge-row index on
equal distances, as ``lax.top_k`` does; every ``+inf`` result carries
label ``-1``. The ``[Q, T*C]`` candidate matrix is never built.

Dot products and ``||q||^2`` are summed in index order, one rounded
product and one rounded sum per term (:func:`dot_in_order`). The CUDA
kernel does the same arithmetic in the same order, so the two agree bit
for bit on every device; the reference's ``einsum`` sums in another order
and agrees within fp32 rounding.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmap as bm


def dot_in_order(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``q [Q, D]`` . ``x [Q, C, D]`` -> ``[Q, C]``, summed over d in order."""
    acc = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
    for i in range(x.shape[2]):
        acc = acc + q[:, i:i + 1] * x[:, :, i]
    return acc


def fold_topk(run_d: torch.Tensor, run_l: torch.Tensor, d: torch.Tensor,
              lab: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold ``[Q, C]`` candidates into the running ``[Q, k]`` top-k."""
    alld = torch.cat([run_d, d], dim=1)                        # [Q, k+C]
    alll = torch.cat([run_l, lab], dim=1)
    nd, idx = torch.sort(alld, dim=1, stable=True)
    nd, idx = nd[:, :k], idx[:, :k]
    nl = torch.gather(alll, 1, idx)
    return nd, torch.where(torch.isinf(nd), -1, nl)


def sivf_fused_search_ref(queries: torch.Tensor, table: torch.Tensor,
                          data: torch.Tensor, ids: torch.Tensor,
                          norms: torch.Tensor, bitmap: torch.Tensor, k: int,
                          metric: str = "l2"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q,D], table [Q,T] (-1 pad) -> (dists [Q,k], labels [Q,k]).

    data [n_slabs,C,D] f32, ids [n_slabs,C] i32, norms [n_slabs,C] f32,
    bitmap [n_slabs,W] i32 words. L2 scores ``||q||^2 - 2 q.x + ||x||^2``,
    IP scores ``-q.x``; dead slots and ``-1`` pads score ``+inf``.
    """
    qn = queries.shape[0]
    c = data.shape[1]
    qf = queries.to(torch.float32)
    qq = dot_in_order(qf, qf.unsqueeze(1))                     # [Q, 1]
    run_d = torch.full((qn, k), torch.inf, dtype=torch.float32,
                       device=queries.device)
    run_l = torch.full((qn, k), -1, dtype=torch.int32, device=queries.device)
    # a column of -1 pads only adds +inf candidates: folding it is a no-op
    for t in torch.nonzero((table >= 0).any(0)).reshape(-1).tolist():
        col = table[:, t]
        sc = col.clamp(min=0).long()
        x = data[sc].to(torch.float32)                         # [Q, C, D]
        ok = bm.unpack_batch(bitmap[sc], c) & (col >= 0).unsqueeze(1)
        dot = dot_in_order(qf, x)
        d = qq - 2.0 * dot + norms[sc] if metric == "l2" else -dot
        d = torch.where(ok, d, torch.inf)
        lab = torch.where(ok, ids[sc], -1)
        run_d, run_l = fold_topk(run_d, run_l, d, lab, k)
    return run_d, run_l
