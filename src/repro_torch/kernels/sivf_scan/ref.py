"""Plain PyTorch scans: the oracles for the CUDA kernels
``csrc/sivf_fused_search.cu`` (raw fp32), ``csrc/sivf_pq_fused_search.cu``
(PQ/ADC) and ``csrc/sivf_scan.cu`` (the unfused raw scan).

Counterpart of ``repro/kernels/sivf_scan/ref.py`` plus the running top-k
fold of ``repro/kernels/sivf_scan/fused.py:61-91`` and the column scans of
``repro/core/index.py:468-571``: the slab table is scanned column by
column, and each column's ``[Q, C]`` masked candidates are folded into a
running ``[Q, k]`` list. The merge row is ``[running k | C candidates in
slot order]`` and a *stable* sort keeps the lowest merge-row index on
equal distances, as ``lax.top_k`` does; every ``+inf`` result carries
label ``-1``. The ``[Q, T*C]`` candidate matrix is never built, except
by :func:`sivf_scan_ref`, whose output it is (counterpart of
``repro/kernels/sivf_scan/ref.py``): it writes each column's block in
place of the fold.

:func:`sivf_fused_search_split_ref` computes the fused search's function
in the grouped CUDA route's order instead (:func:`plan`, each slab's
entries scored together, a partial top-k per ``(q, t)`` entry, a merge per
query), and :func:`sivf_pq_fused_search_split_ref` the PQ search's in its
compacted route's order (live entries compacted, rounds of candidates
folded at once into several lists, a merge; optionally contiguous shares
and a merge per query): the k smallest of the total
order ``(distance, t, slot)`` are one set whatever the order, so each
equals the fold bit for bit.

A slot is a candidate when its validity bit is set, its table entry is
not ``-1`` and, for a filtered search, its attributes pass the compiled
predicate (``core/filters.py``); anything else scores ``+inf`` / ``-1``
before the fold, so it never displaces a passing row.

Raw scores: dot products and ``||q||^2`` are summed over d in eight
float32 lane accumulators ``a0..a7``, each from ``+0.0``: term ``d`` goes
into lane ``d mod 8``, one rounded product and one rounded sum per term
(no fused multiply-add), and the result is ``((a0 + a1) + (a2 + a3)) +
((a4 + a5) + (a6 + a7))`` (:func:`dot_lanes`). ADC scores: the ``m``
table lookups are summed in ascending subspace
order starting from the ``s = 0`` term. The CUDA kernels do the same
arithmetic in the same order, so each agrees with its plain version bit
for bit on every device; the reference's raw ``einsum`` sums in another
order and agrees within fp32 rounding, its ADC scan bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.filters import eval_structure


def dot_lanes(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``q [Q, D]`` . ``x [Q, C, D]`` -> ``[Q, C]`` in eight lanes: term
    ``d`` into lane ``d mod 8`` (the lanes of a group of eight columns step
    together: one product and one sum a term; the lanes past ``D`` stay
    ``+0.0``), then ``((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7))``."""
    d = x.shape[2]
    acc = torch.zeros((*x.shape[:2], 8), dtype=torch.float32,
                      device=x.device)
    for i in range(0, d - 7, 8):
        acc = acc + q[:, None, i:i + 8] * x[:, :, i:i + 8]
    r = d % 8
    if r:
        acc[..., :r] = acc[..., :r] + q[:, None, d - r:] * x[:, :, d - r:]
    acc = acc[..., 0::2] + acc[..., 1::2]
    acc = acc[..., 0::2] + acc[..., 1::2]
    return acc[..., 0] + acc[..., 1]


def adc_in_order(adc: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``adc [Q, m, ksub]``, ``codes [Q, C, m]`` -> ``[Q, C]``: the sum of
    ``adc[q, s, codes[q, c, s]]`` over ``s`` in ascending order, starting
    from the ``s = 0`` term (so a ``-0.0`` first term stays ``-0.0``)."""
    d = None
    for s in range(adc.shape[1]):
        term = torch.gather(adc[:, s, :], 1, codes[..., s].long())
        d = term if d is None else d + term
    return d


def predicate_mask(attrs_rows: torch.Tensor, fstruct: tuple,
                   fconsts: torch.Tensor) -> torch.Tensor:
    """``attrs_rows [..., A]`` int32 -> bool ``[...]``: the compiled
    predicate (``fstruct`` with constants ``fconsts``) on each row."""
    return eval_structure(fstruct, lambda j: attrs_rows[..., j],
                          lambda i: fconsts[i])


def fold_topk(run_d: torch.Tensor, run_l: torch.Tensor, d: torch.Tensor,
              lab: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold ``[Q, C]`` candidates into the running ``[Q, k]`` top-k."""
    alld = torch.cat([run_d, d], dim=1)                        # [Q, k+C]
    alll = torch.cat([run_l, lab], dim=1)
    nd, idx = torch.sort(alld, dim=1, stable=True)
    nd, idx = nd[:, :k], idx[:, :k]
    nl = torch.gather(alll, 1, idx)
    return nd, torch.where(torch.isinf(nd), -1, nl)


def _columns(score, table: torch.Tensor, ids: torch.Tensor,
             bitmap: torch.Tensor, attrs, fstruct, fconsts):
    """The column scan every plain version shares: yields ``(t, d, lab)``,
    column ``t``'s masked ``[Q, C]`` candidates, for each column that holds
    a live entry. ``score(sc)`` gives the ``[Q, C]`` distances of column
    slabs ``sc`` [Q] (pads clipped to 0); a column of ``-1`` pads only
    holds ``+inf`` / ``-1`` candidates and is skipped."""
    c = ids.shape[1]
    for t in torch.nonzero((table >= 0).any(0)).reshape(-1).tolist():
        col = table[:, t]
        sc = col.clamp(min=0).long()
        ok = bm.unpack_batch(bitmap[sc], c) & (col >= 0).unsqueeze(1)
        if fstruct is not None:
            ok &= predicate_mask(attrs[sc], fstruct, fconsts)
        yield t, torch.where(ok, score(sc), torch.inf), \
            torch.where(ok, ids[sc], -1)


def _scan_topk(score, table: torch.Tensor, ids: torch.Tensor,
               bitmap: torch.Tensor, k: int, attrs, fstruct, fconsts
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold every column's candidates into a running ``[Q, k]`` top-k."""
    qn = table.shape[0]
    run_d = torch.full((qn, k), torch.inf, dtype=torch.float32,
                       device=table.device)
    run_l = torch.full((qn, k), -1, dtype=torch.int32, device=table.device)
    for _, d, lab in _columns(score, table, ids, bitmap, attrs, fstruct,
                              fconsts):
        run_d, run_l = fold_topk(run_d, run_l, d, lab, k)
    return run_d, run_l


def _raw_score(queries: torch.Tensor, data: torch.Tensor,
               norms: torch.Tensor, metric: str):
    """``score(sc)`` of the raw fp32 scans: L2 ``||q||^2 - 2 q.x + ||x||^2``,
    IP ``-q.x``, each sum over d in eight lanes (:func:`dot_lanes`)."""
    qf = queries.to(torch.float32)
    qq = dot_lanes(qf, qf.unsqueeze(1))                        # [Q, 1]

    def score(sc):
        dot = dot_lanes(qf, data[sc].to(torch.float32))
        return qq - 2.0 * dot + norms[sc] if metric == "l2" else -dot

    return score


def sivf_scan_ref(queries: torch.Tensor, table: torch.Tensor,
                  data: torch.Tensor, ids: torch.Tensor, norms: torch.Tensor,
                  bitmap: torch.Tensor, metric: str = "l2"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q,D], table [Q,T] (-1 pad) -> (dists [Q,T*C] f32, labels
    [Q,T*C] i32): slot ``c`` of entry ``t`` at column ``t*C + c``.

    Operands as in :func:`sivf_fused_search_ref`. A dead slot or a ``-1``
    entry's slots are ``+inf`` / ``-1``. Scores column by column (no
    ``[Q, T, C, D]`` gather), with the fused scan's arithmetic.
    """
    qn, t = table.shape
    c = ids.shape[1]
    dists = torch.full((qn, t, c), torch.inf, dtype=torch.float32,
                       device=table.device)
    labels = torch.full((qn, t, c), -1, dtype=torch.int32,
                        device=table.device)
    for col, d, lab in _columns(_raw_score(queries, data, norms, metric),
                                table, ids, bitmap, None, None, None):
        dists[:, col] = d
        labels[:, col] = lab
    return dists.reshape(qn, t * c), labels.reshape(qn, t * c)


def sivf_fused_search_ref(queries: torch.Tensor, table: torch.Tensor,
                          data: torch.Tensor, ids: torch.Tensor,
                          norms: torch.Tensor, bitmap: torch.Tensor, k: int,
                          metric: str = "l2", attrs: torch.Tensor | None = None,
                          fstruct: tuple | None = None,
                          fconsts: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q,D], table [Q,T] (-1 pad) -> (dists [Q,k], labels [Q,k]).

    data [n_slabs,C,D] f32, ids [n_slabs,C] i32, norms [n_slabs,C] f32,
    bitmap [n_slabs,W] i32 words. L2 scores ``||q||^2 - 2 q.x + ||x||^2``,
    IP scores ``-q.x``. With ``fstruct``, ``attrs`` [n_slabs,C,A] i32 and
    ``fconsts`` [n_consts] i32 mask the slots that fail the predicate.
    """
    return _scan_topk(_raw_score(queries, data, norms, metric), table, ids,
                      bitmap, k, attrs, fstruct, fconsts)


def plan(table: torch.Tensor, n_slabs: int
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The grouped scan's plan: ``table [Q, T]`` inverted into a CSR map
    from slab to the live ``(q, t)`` entries that probe it.

    Returns ``(offsets [n_slabs + 1], entries [n_live])``, both int64:
    slab ``s``'s entries, each ``q * T + t``, are
    ``entries[offsets[s]:offsets[s + 1]]``. ``-1`` entries drop out. Here
    a slab's entries are in ascending order; the kernel's order inside a
    slab is free, since every output is keyed by ``(q, t)``.
    """
    flat = table.reshape(-1).long()
    live = torch.nonzero(flat >= 0).reshape(-1)
    slabs = flat[live]
    offsets = torch.zeros(n_slabs + 1, dtype=torch.long, device=table.device)
    offsets[1:] = torch.cumsum(torch.bincount(slabs, minlength=n_slabs), 0)
    return offsets, live[torch.sort(slabs, stable=True).indices]


def sivf_fused_search_split_ref(queries: torch.Tensor, table: torch.Tensor,
                                data: torch.Tensor, ids: torch.Tensor,
                                norms: torch.Tensor, bitmap: torch.Tensor,
                                k: int, metric: str = "l2",
                                attrs: torch.Tensor | None = None,
                                fstruct: tuple | None = None,
                                fconsts: torch.Tensor | None = None,
                                slab_order: list[int] | None = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sivf_fused_search_ref`'s function in the grouped kernel's
    order (``csrc/sivf_fused_search.cu``, route ``grouped``).

    The running fold returns, for each query, the k smallest candidates
    under the total order ``(d, t, c)`` (distance, table column, slot;
    ``-0.0`` ties ``+0.0``). The k smallest of a total order are one set
    whatever the order the candidates are seen in, and a candidate outside
    its own entry's ``min(k, C)`` smallest under ``(d, c)`` cannot reach the
    answer. So: :func:`plan`; then each slab, in ``slab_order`` (ascending
    by default; the kernel's blocks take slabs in no fixed order), scores
    its entries' queries at once, and each ``(q, t)`` entry keeps its
    ``min(k, C)`` smallest under ``(d, c)`` (a stable sort over slots); then
    each query merges its entries' partials, laid out in ``(t, position)``
    order, under ``(d, t, position)`` (a stable sort). Every ``+inf``
    carries ``-1``. Operands as in :func:`sivf_fused_search_ref`.
    """
    qn, t_len = table.shape
    n_slabs, c = ids.shape
    kk = min(k, c)
    offsets, entries = plan(table, n_slabs)
    qf = queries.to(torch.float32)
    qq = dot_lanes(qf, qf.unsqueeze(1))                        # [Q, 1]
    part_d = torch.full((qn * t_len, kk), torch.inf, dtype=torch.float32,
                        device=table.device)
    part_l = torch.full((qn * t_len, kk), -1, dtype=torch.int32,
                        device=table.device)
    probed = torch.nonzero(offsets[1:] > offsets[:-1]).reshape(-1).tolist()
    for s in probed if slab_order is None else \
            [x for x in slab_order if x in set(probed)]:
        e = entries[offsets[s]:offsets[s + 1]]
        q = e // t_len
        ok = bm.unpack_batch(bitmap[s], c)                     # [C]
        if fstruct is not None:
            ok &= predicate_mask(attrs[s], fstruct, fconsts)
        x = data[s].to(torch.float32).expand(len(e), c, -1)
        dot = dot_lanes(qf[q], x)                              # [n, C]
        d = qq[q] - 2.0 * dot + norms[s] if metric == "l2" else -dot
        sd, idx = torch.sort(torch.where(ok, d, torch.inf), dim=1,
                             stable=True)
        part_d[e] = sd[:, :kk]
        part_l[e] = torch.where(torch.isinf(sd[:, :kk]), -1,
                                ids[s][idx[:, :kk]])
    md = part_d.reshape(qn, t_len * kk)
    ml = part_l.reshape(qn, t_len * kk)
    if t_len * kk < k:                                         # pad to k
        md = torch.cat([md, torch.full((qn, k - t_len * kk), torch.inf,
                                       device=md.device)], 1)
        ml = torch.cat([ml, torch.full((qn, k - t_len * kk), -1,
                                       dtype=torch.int32,
                                       device=ml.device)], 1)
    nd, idx = torch.sort(md, dim=1, stable=True)
    nd, idx = nd[:, :k], idx[:, :k]
    return nd, torch.where(torch.isinf(nd), -1, torch.gather(ml, 1, idx))


def sivf_pq_fused_search_ref(adc: torch.Tensor, table: torch.Tensor,
                             codes: torch.Tensor, ids: torch.Tensor,
                             bitmap: torch.Tensor, k: int,
                             attrs: torch.Tensor | None = None,
                             fstruct: tuple | None = None,
                             fconsts: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """adc [Q,m,ksub] f32, table [Q,T] (-1 pad) -> ([Q,k] f32, [Q,k] i32).

    codes [n_slabs,C,m] uint8, ids [n_slabs,C] i32, bitmap [n_slabs,W]
    i32 words. A slot scores the sum of its ``m`` lookups in its query's
    ADC table (:func:`adc_in_order`); the table is already metric-shaped
    (``core.pq.adc_tables``). Filter operands as in the raw version.
    """
    return _scan_topk(lambda sc: adc_in_order(adc, codes[sc]), table, ids,
                      bitmap, k, attrs, fstruct, fconsts)


def sivf_pq_fused_search_split_ref(adc: torch.Tensor, table: torch.Tensor,
                                   codes: torch.Tensor, ids: torch.Tensor,
                                   bitmap: torch.Tensor, k: int,
                                   attrs: torch.Tensor | None = None,
                                   fstruct: tuple | None = None,
                                   fconsts: torch.Tensor | None = None,
                                   n_split: int = 1, window: int = 2048,
                                   streams: int = 8, lanes: int = 32
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sivf_pq_fused_search_ref`'s function in the compacted
    kernel's order (``csrc/sivf_pq_fused_search.cu``, route ``compacted``,
    which runs ``n_split=1``; ``n_split > 1`` is the order of a row cut
    into shares, held to the fold as well).

    Each query's live table entries (``table >= 0``) are compacted in t
    order and cut into ``n_split`` contiguous shares, share ``s`` taking
    entries ``[s * n // n_split, (s + 1) * n // n_split)`` of its ``n``. A
    share's candidates ``g = entry * C + slot`` are screened ``window`` at
    a time; each window lists its live (passing) ones in g order and deals
    them, ``lanes`` at a time, to ``streams`` streams in turn (a warp
    each), every stream folding its chunks into its own running top-k (a
    stable sort of ``[running k | chunk]``: the lower g wins a tie). The
    streams' lists are merged under ``(distance, g)``, then the shares'
    partials, laid out in ``(share, position)`` order, under ``(distance,
    share, position)`` (stable sorts). Every ``+inf`` carries ``-1``.
    Operands as in :func:`sivf_pq_fused_search_ref`.
    """
    qn, t_len = table.shape
    c = ids.shape[1]
    dev = table.device
    inf_d = torch.full((k,), torch.inf, device=dev)
    none_l = torch.full((k,), -1, dtype=torch.int64, device=dev)
    out_d, out_l = [], []
    for q in range(qn):
        slabs = table[q][table[q] >= 0].long()
        n = slabs.numel()
        part_d, part_l = [], []
        for s in range(n_split):
            sl = slabs[s * n // n_split:(s + 1) * n // n_split]
            ok = bm.unpack_batch(bitmap[sl], c).reshape(-1)     # [n_e * C]
            if fstruct is not None:
                ok &= predicate_mask(attrs[sl], fstruct,
                                     fconsts).reshape(-1)
            d = adc_in_order(adc[q:q + 1],
                             codes[sl].reshape(1, -1, codes.shape[2]))[0]
            g_all = torch.arange(ok.numel(), device=dev)
            runs = [(inf_d, none_l)] * streams                   # (d, g)
            for w0 in range(0, ok.numel(), window):
                live = g_all[w0:w0 + window][ok[w0:w0 + window]]
                for j, c0 in enumerate(range(0, live.numel(), lanes)):
                    gs = live[c0:c0 + lanes]
                    rd, rg = runs[j % streams]
                    runs[j % streams] = fold_topk(
                        rd[None], rg[None], d[gs][None], gs[None], k)
                    runs[j % streams] = (runs[j % streams][0][0],
                                         runs[j % streams][1][0])
            rd = torch.cat([r[0] for r in runs])
            rg = torch.cat([r[1] for r in runs])
            by_g = torch.sort(torch.where(rg < 0, ok.numel() + 1, rg),
                              stable=True).indices
            idx = torch.sort(rd[by_g], stable=True).indices[:k]
            pd, pg = rd[by_g][idx], rg[by_g][idx]
            lab = torch.cat([ids[sl].reshape(-1).long(), none_l[:1]])
            part_d.append(pd)
            part_l.append(torch.where(torch.isinf(pd), -1,
                                      lab[torch.where(pg < 0, -1, pg)]))
        md, ml = torch.cat(part_d), torch.cat(part_l)
        idx = torch.sort(md, stable=True).indices[:k]
        out_d.append(md[idx])
        out_l.append(torch.where(torch.isinf(md[idx]), -1, ml[idx]))
    return (torch.stack(out_d) if qn else torch.empty((0, k), device=dev),
            (torch.stack(out_l) if qn else torch.empty((0, k), device=dev))
            .to(torch.int32))
