"""The comparison that decides ``correct``.

It judges answers (the program's, or the control's in its place) against
the float64 reference of ``ivf.py`` and the log of operations the
benchmark drove. Every number it returns has a limit, and a run is correct
when no number exceeds its limit:

``report_wrong``    mutation reports whose counts or error bits differ
                    from the batch the client sent (exact: 0);
``live_ids_wrong``  ids live in the index's final state that the log says
                    are gone, or gone that it says are live (exact: 0);
``pool_violations`` broken invariants of the slab pool's final state:
                    per-slab counts against the bitmaps, owned slabs that
                    hold no live row (not reclaimed), the free stack
                    against the unowned slabs, each list's table against
                    its slabs, and more slabs in a list than its live rows
                    need plus one (removes take the oldest rows, so a list
                    holds at most one part-drained slab and one part-
                    filled head) (exact: 0);
``payload_wrong``   final live rows whose stored vector is not the row
                    inserted under that id (raw payloads; exact: 0);
``assign_gap``      the widest gap, over final live rows, by which the
                    list a row sits in lies farther from it than its
                    nearest centroid, as a share of ``|x|^2 + |c|^2``;
``code_gap``        the same for each PQ subspace's codeword (PQ only);
``search_wrong``    entries of sampled search calls that break the exact
                    semantics: a label not live at the call, a duplicate,
                    a row of a list the query cannot have probed, results
                    out of order, or a row that had to be returned and was
                    not (exact: 0);
``dist_err``        the widest gap between a returned distance and the
                    float64 distance of its row, as a share of the scale a
                    float32 expansion rounds at.

Near-ties are decided by the limits themselves: a row whose two nearest
centroids lie within ``assign_gap``'s limit of each other may sit in
either list, a list within it of the ``nprobe``-th may or may not be
probed, and a row whose distance is within ``dist_err``'s limit of the
k-th returned one may or may not be returned. Answers that only such
near-ties separate are all correct.
"""
from __future__ import annotations

import dataclasses

import torch

from bench.reference import ivf

WORD = 32


def unpack_bits(words: torch.Tensor, capacity: int) -> torch.Tensor:
    """``[..., W]`` int32 words -> ``[..., capacity]`` bool, slot
    ``32 w + s`` at bit ``s`` of word ``w``."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = ((words.unsqueeze(-1) >> shifts) & 1) != 0
    return bits.reshape(*words.shape[:-1], capacity)


# ---------------------------------------------------------------------------
# The final state
# ---------------------------------------------------------------------------

def pool_violations(planes: dict, capacity: int, n_lists: int) -> int:
    """Broken invariants of the slab pool (see the module docstring)."""
    owner, live = planes["owner"].long(), planes["live"].long()
    ns = owner.shape[0]
    owned = owner >= 0
    pop = unpack_bits(planes["bitmap"], capacity).sum(1)
    bad = int(((pop != live) & owned).sum())
    bad += int((owned & (live == 0)).sum())                 # not reclaimed
    top = int(planes["free_top"])
    stack = planes["free_stack"][:top].long()
    in_stack = torch.zeros(ns, dtype=torch.long, device=owner.device)
    in_stack.index_add_(0, stack, torch.ones_like(stack))
    bad += int((in_stack > 1).sum()) + int(((in_stack > 0) == owned).sum())
    lst = owner.clamp(min=0)
    slabs_l = torch.zeros(n_lists, dtype=torch.long, device=owner.device
                          ).index_add_(0, lst, owned.long())
    live_l = torch.zeros(n_lists, dtype=torch.long, device=owner.device
                         ).index_add_(0, lst, torch.where(owned, live, 0))
    tlen = planes["table_len"].long()
    bad += int((tlen != slabs_l).sum())
    width = planes["tables"].shape[1]
    tab = planes["tables"].long()
    used = torch.arange(width, device=tab.device).unsqueeze(0) \
        < tlen.unsqueeze(1)
    ent = torch.where(used, tab, 0)
    rows = torch.arange(n_lists, device=tab.device).unsqueeze(1)
    bad += int((used & (owner[ent] != rows)).sum())
    heads = planes["heads"].long()
    bad += int(((heads >= 0) != (tlen > 0)).sum())
    bad += int(((heads >= 0) & (owner[heads.clamp(min=0)] != torch.arange(
        n_lists, device=heads.device))).sum())
    need = (live_l + capacity - 1) // capacity
    bad += int((slabs_l > need + 1).sum())
    bad += int(int(planes["n_live"]) != int(live_l.sum()))
    return bad


def final_answers(planes: dict, capacity: int, live_ids: torch.Tensor,
                  rows: torch.Tensor | None) -> dict:
    """What the final state says of each id the log says is live:
    ``found`` (its slot is live and holds it), its list, its PQ codes, and
    ``live_ids_wrong`` / ``payload_wrong`` (``rows``: the raw rows the log
    inserted under those ids, or None under PQ)."""
    ids = live_ids.long()
    slab = planes["att_slab"][ids].long()
    slot = planes["att_slot"][ids].long()
    s0, t0 = slab.clamp(min=0), slot.clamp(min=0, max=capacity - 1)
    word = planes["bitmap"][s0, t0 // WORD]
    bit = ((word >> (t0 % WORD).to(torch.int32)) & 1) != 0
    found = (slab >= 0) & bit & (planes["ids"][s0, t0].long() == ids) \
        & (planes["owner"][s0] >= 0)
    pop = int(unpack_bits(planes["bitmap"], capacity)[
        planes["owner"] >= 0].sum())
    n = int(ids.numel())
    wrong = int((~found).sum()) + abs(pop - n) \
        + abs(int(planes["n_live"]) - n) \
        + abs(int((planes["att_slab"] >= 0).sum()) - n)
    out = {"found": found, "list": planes["owner"][s0].long(),
           "live_ids_wrong": wrong}
    if planes["codes"].shape[-1]:
        out["codes"] = planes["codes"][s0, t0]
    if rows is not None:
        out["payload_wrong"] = int(((planes["data"][s0, t0] != rows).any(1)
                                    & found).sum())
    return out


def assign_gap(rows: torch.Tensor, lists: torch.Tensor, found: torch.Tensor,
               centroids: torch.Tensor, d1: torch.Tensor,
               block: int = ivf.BLOCK) -> float:
    """max over rows of ``(|x - c_list|^2 - min_c |x - c|^2) / (|x|^2 +
    |c_list|^2)`` in float64 (``d1``: the nearest distances)."""
    worst = 0.0
    cents = centroids.double()
    for a in range(0, rows.shape[0], block):
        x = rows[a:a + block].double()
        c = cents[lists[a:a + block]]
        d = ((x - c) ** 2).sum(1)
        g = (d - d1[a:a + block]) / ((x * x).sum(1) + (c * c).sum(1))
        g = g[found[a:a + block]]
        if g.numel():
            worst = max(worst, float(g.max()))
    return worst


def code_gap(rows: torch.Tensor, codes: torch.Tensor, found: torch.Tensor,
             codebooks: torch.Tensor, block: int = ivf.BLOCK) -> float:
    """max over rows and subspaces of the chosen codeword's distance above
    the nearest, as a share of ``|x_s|^2 + |c|^2``, in float64."""
    worst = 0.0
    m = codebooks.shape[0]
    cc = (codebooks.double() ** 2).sum(-1)                       # [m, ksub]
    for a in range(0, rows.shape[0], block):
        d = ivf.sub_dist(rows[a:a + block], codebooks, "f64")     # [B, m, K]
        ch = codes[a:a + block].long().unsqueeze(-1)
        x = rows[a:a + block].double().reshape(d.shape[0], m, -1)
        scale = (x * x).sum(-1) + torch.gather(
            cc.unsqueeze(0).expand(d.shape[0], -1, -1), 2, ch).squeeze(-1)
        g = ((torch.gather(d, 2, ch).squeeze(-1) - d.amin(-1)) / scale
             ).amax(1)[found[a:a + block]]
        if g.numel():
            worst = max(worst, float(g.max()))
    return worst


# ---------------------------------------------------------------------------
# Search calls
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Truth:
    """The float64 reference of every pool row, and the run's geometry."""

    pool: torch.Tensor            # [P, D] rows; counter c holds row c % P
    centroids: torch.Tensor
    assign: dict                  # ivf.assign(pool, centroids, "f64")
    codebooks: torch.Tensor | None
    encode: dict | None           # ivf.encode(pool, codebooks, "f64")
    n_max: int
    k: int
    nprobe: int
    limits: dict

    @property
    def P(self) -> int:
        return self.pool.shape[0]


@dataclasses.dataclass
class Known:
    """An answer's own lists and codes of the rows live at the end of the
    log (counters ``lo`` to ``lo + n``): rows judged there are judged by
    where the answer put them."""

    lo: int
    lists: torch.Tensor
    found: torch.Tensor
    codes: torch.Tensor | None = None


def _row_facts(truth: Truth, known: Known, counters: torch.Tensor) -> dict:
    """For rows by counter: the lists they may sit in (``l1`` certain when
    ``sure``; else ``l1`` or ``l2``), their codes and whether the codes are
    certain."""
    pos = counters % truth.P
    a = truth.assign
    tau = truth.limits["assign_gap"]
    l1, l2 = a["list"][pos], a["list2"][pos]
    sure = (a["d2"][pos] - a["d1"][pos]) > 2 * tau * a["scale"][pos]
    j = counters - known.lo
    have = (j >= 0) & (j < known.lists.shape[0])
    jc = j.clamp(0, max(known.lists.shape[0] - 1, 0))
    if known.lists.shape[0]:
        have = have & known.found[jc]
        l1 = torch.where(have, known.lists[jc], l1)
    sure = sure | have
    out = {"l1": l1, "l2": l2, "sure": sure, "pos": pos}
    if truth.codebooks is not None:
        codes = truth.encode["codes"][pos]
        csure = truth.encode["margin"][pos] > 2 * truth.limits["code_gap"]
        if known.codes is not None and known.lists.shape[0]:
            codes = torch.where(have.unsqueeze(-1), known.codes[jc], codes)
        out["codes"] = codes
        out["code_sure"] = csure | have
    return out


def _distances(truth: Truth, q: torch.Tensor, facts: dict, tables
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 distances of queries ``q [Q, D]`` to ``[Q, k]`` rows given
    by ``facts`` (pool positions, codes under PQ), and the scale a float32
    expansion rounds at."""
    pos = facts["pos"]
    qd = q.double()
    qq = (qd ** 2).sum(-1)
    if tables is None:
        x = truth.pool[pos].double()                            # [Q, k, D]
        d = ((qd.unsqueeze(1) - x) ** 2).sum(-1)
        return d, qq.unsqueeze(1) + (x * x).sum(-1)
    codes = facts["codes"].long()                               # [Q, k, m]
    cb = truth.codebooks.double()
    cc = (cb ** 2).sum(-1)                                      # [m, ksub]
    qs = (qd.reshape(q.shape[0], cb.shape[0], -1) ** 2).sum(-1)  # [Q, m]
    d = torch.zeros(codes.shape[:2], dtype=torch.float64, device=q.device)
    sc = torch.zeros_like(d)
    for s in range(cb.shape[0]):
        d += torch.gather(tables[:, s], 1, codes[..., s])
        sc += qs[:, s:s + 1] + cc[s][codes[..., s]]
    return d, sc


def judge_call(truth: Truth, known: Known, queries: torch.Tensor, lo: int,
               hi: int, labels: torch.Tensor, dists: torch.Tensor,
               chunk: int = 32) -> dict:
    """One search call made while counters ``[lo, hi)`` were live:
    ``search_wrong`` (count), ``dist_err`` (max) and ``unverifiable``
    (returned PQ rows whose code the reference cannot know)."""
    dev = queries.device
    k, nprobe, n_max = truth.k, truth.nprobe, truth.n_max
    tau_a, tau_d = truth.limits["assign_gap"], truth.limits["dist_err"]
    labels = labels.to(dev).long()
    dists = dists.to(dev).double()
    qn = queries.shape[0]
    pr = ivf.probe(queries, truth.centroids, nprobe, "f64")
    vp = pr["sorted"][:, nprobe - 1:nprobe]
    vp1 = pr["sorted"][:, nprobe:nprobe + 1] if pr["sorted"].shape[1] \
        > nprobe else torch.full_like(vp, float("inf"))
    slack = 2 * tau_a * pr["scale"]
    sure_probe = pr["dist"] < vp1 - slack
    may_probe = pr["dist"] <= vp + slack
    tables = None if truth.codebooks is None else ivf.sub_dist(
        queries, truth.codebooks, "f64")                        # ADC tables

    bad = 0
    # -- the returned entries themselves -----------------------------------
    valid = labels >= 0
    bad += int((valid[:, 1:] & ~valid[:, :-1]).sum())         # -1 then a row
    ctr = lo + torch.remainder(labels - lo, n_max)
    live = valid & (labels < n_max) & (ctr < hi)
    bad += int((valid & ~live).sum())
    srt = torch.sort(torch.where(live, labels, -1 - torch.arange(
        k, device=dev).unsqueeze(0)), dim=1).values
    bad += int((srt[:, 1:] == srt[:, :-1]).sum())              # duplicates
    both = valid[:, 1:] & valid[:, :-1]
    bad += int((both & (dists[:, 1:] < dists[:, :-1])).sum())  # order
    facts = _row_facts(truth, known, torch.where(live, ctr, lo))
    qi = torch.arange(qn, device=dev).unsqueeze(1)
    may = may_probe[qi, facts["l1"]] | (~facts["sure"]
                                        & may_probe[qi, facts["l2"]])
    bad += int((live & ~may).sum())
    d64, scale = _distances(truth, queries, facts, tables)
    check = live & facts.get("code_sure", torch.ones_like(live))
    unverifiable = int((live & ~check).sum())
    err = ((dists - d64).abs() / scale)[check]
    worst = float(err.max()) if err.numel() else 0.0
    # the k-th returned distance: its row's, or as reported where the
    # reference cannot know the row's code; +inf when fewer than k came
    dk = torch.where(check[:, -1], d64[:, -1], dists[:, -1])
    dk = torch.where(valid[:, -1], dk, float("inf"))

    # -- rows that had to be returned --------------------------------------
    # the rows surely in a list, by list; each query's surely probed lists
    ctrs = torch.arange(lo, hi, device=dev, dtype=torch.long)
    rf = _row_facts(truth, known, ctrs)
    row_sure = rf["sure"] & rf.get("code_sure", torch.ones_like(rf["sure"]))
    n_lists = truth.centroids.shape[0]
    grouped = ivf.Lists(torch.where(row_sure, rf["l1"], n_lists), n_lists)
    best_v = torch.empty((qn, k), dtype=torch.float64, device=dev)
    best_c = torch.empty((qn, k), dtype=torch.long, device=dev)
    best_s = torch.empty((qn, k), dtype=torch.float64, device=dev)
    for a in range(0, qn, chunk):
        b = min(a + chunk, qn)
        qi, ri = grouped.pairs(sure_probe[a:b])
        if not qi.numel():
            best_v[a:b], best_c[a:b], best_s[a:b] = float("inf"), -1, 0.0
            continue
        if tables is None:
            d = ivf.pair_sq(queries[a:b], truth.pool, qi, rf["pos"][ri],
                            "f64")
        else:
            d = ivf.pair_adc(tables[a:b], rf["codes"], qi, ri)
        v, e = ivf.segment_topk(qi, d, k, b - a)
        r = ri[e.clamp(min=0)]
        f = {"pos": rf["pos"][r]}
        if tables is not None:
            f["codes"] = rf["codes"][r]
        _, sc = _distances(truth, queries[a:b], f, None if tables is None
                           else tables[a:b])
        best_v[a:b] = v
        best_c[a:b] = torch.where(e >= 0, ctrs[r], -1)
        best_s[a:b] = sc
    returned = (best_c.unsqueeze(2) == torch.where(
        live, ctr, -2).unsqueeze(1)).any(2)
    missed = torch.isfinite(best_v) & ~returned \
        & (best_v < dk.unsqueeze(1) - tau_d * best_s)
    bad += int(missed.sum())
    return {"search_wrong": bad, "dist_err": worst,
            "unverifiable": unverifiable}


def judge_answers(truth: Truth, known: Known, calls: list) -> dict:
    """``assign_gap`` (and ``code_gap``) of the rows live at the end as
    ``known`` places them, and ``search_wrong``, ``dist_err`` and
    ``unverifiable`` over the search ``calls`` (dicts of ``queries``,
    ``lo``, ``hi``, ``labels``, ``dists``)."""
    pos = torch.arange(known.lo, known.lo + known.lists.shape[0],
                       device=truth.pool.device) % truth.P
    rows = truth.pool[pos]
    out = {"assign_gap": assign_gap(rows, known.lists, known.found,
                                    truth.centroids, truth.assign["d1"][pos])}
    if truth.codebooks is not None:
        out["code_gap"] = code_gap(rows, known.codes, known.found,
                                   truth.codebooks)
    del rows
    out.update(search_wrong=0, dist_err=0.0, unverifiable=0)
    for c in calls:
        r = judge_call(truth, known, c["queries"], c["lo"], c["hi"],
                       c["labels"], c["dists"])
        out["search_wrong"] += r["search_wrong"]
        out["dist_err"] = max(out["dist_err"], r["dist_err"])
        out["unverifiable"] += r["unverifiable"]
    return out


# ---------------------------------------------------------------------------
# The control: the reference in the program's place
# ---------------------------------------------------------------------------

def control_answers(truth: Truth, mode: str, final_lo: int, final_hi: int,
                    calls: list) -> tuple[Known, list]:
    """What the reference computed in ``mode`` answers: the final rows'
    lists and codes, and each sampled call's labels and distances."""
    pool, dev = truth.pool, truth.pool.device
    lists = ivf.assign(pool, truth.centroids, mode)["list"]
    codes = None if truth.codebooks is None else ivf.encode(
        pool, truth.codebooks, mode)["codes"]
    fpos = torch.arange(final_lo, final_hi, device=dev) % truth.P
    known = Known(final_lo, lists[fpos],
                  torch.ones(fpos.numel(), dtype=torch.bool, device=dev),
                  None if codes is None else codes[fpos])
    out = []
    for c in calls:
        ctrs = torch.arange(c["lo"], c["hi"], device=dev)
        pos = ctrs % truth.P
        d, i = ivf.search(c["queries"], pool[pos], lists[pos],
                          truth.centroids, truth.k, truth.nprobe, mode,
                          truth.codebooks,
                          None if codes is None else codes[pos])
        lab = torch.where(i >= 0, ctrs[i.clamp(min=0)] % truth.n_max, -1)
        out.append({**c, "labels": lab, "dists": d.float()})
    return known, out
