"""Plain reference of an IVF index's answers, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
works out again, from the benchmark's own inputs (rows, queries,
centroids, codebooks) and the log of operations the benchmark drove, each
row's list, each row's PQ code, each query's probed lists and each search
call's exact top-k among the live rows of those lists.

Every function takes a ``mode``:

``f64``   float64, the exact answer the comparison judges by;
``f32``   the program's stated precision: float32 products and sums, the
          expansion ``|a|^2 - 2 a.b + |b|^2`` the program also uses;
``tf32``  the control: as ``f32``, with the operands of every matrix
          product rounded to TF32's 10 mantissa bits first (what a tensor
          core in TF32 mode reads), the step below float32.

``torch.backends.cuda.matmul.allow_tf32`` is kept off: ``tf32`` rounds
its operands itself, so the control reads the same on any device.
Large operands go in blocks of rows so that a float64 pass fits beside
the inputs.
"""
from __future__ import annotations

import torch

BLOCK = 1 << 15          # rows a block


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to nearest (ties to even) at 10 mantissa
    bits, as TF32 holds it."""
    i = x.float().contiguous().view(torch.int32).to(torch.int64)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    i = torch.where(i >= 1 << 31, i - (1 << 32), i)
    return i.to(torch.int32).view(torch.float32)


def cast(x: torch.Tensor, mode: str) -> torch.Tensor:
    return x.double() if mode == "f64" else x.float()


def sq_dist(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``[N, D] x [M, D] -> [N, M]`` squared L2 distances in ``mode``."""
    a, b = cast(a, mode), cast(b, mode)
    aa = (a * a).sum(1, keepdim=True)
    bb = (b * b).sum(1).unsqueeze(0)
    if mode == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return torch.addmm(bb, a, b.T, alpha=-2.0).add_(aa)


def assign(rows: torch.Tensor, centroids: torch.Tensor, mode: str,
           block: int = BLOCK) -> dict:
    """Each row's nearest centroid (the first of equals). In ``f64`` also
    the nearest distance, the runner-up list and its distance, and the
    scale ``|x|^2 + |c|^2`` a float32 expansion rounds at."""
    n = rows.shape[0]
    dev = rows.device
    out = {"list": torch.empty(n, dtype=torch.int64, device=dev)}
    if mode == "f64":
        for key in ("d1", "d2", "scale"):
            out[key] = torch.empty(n, dtype=torch.float64, device=dev)
        out["list2"] = torch.empty(n, dtype=torch.int64, device=dev)
        cc = (centroids.double() ** 2).sum(1)
    for i in range(0, n, block):
        d = sq_dist(rows[i:i + block], centroids, mode)
        if mode != "f64":
            out["list"][i:i + block] = d.argmin(1)
            continue
        v, j = torch.topk(d, 2, dim=1, largest=False, sorted=True)
        out["list"][i:i + block] = j[:, 0]
        out["list2"][i:i + block] = j[:, 1]
        out["d1"][i:i + block] = v[:, 0]
        out["d2"][i:i + block] = v[:, 1]
        x = rows[i:i + block].double()
        out["scale"][i:i + block] = (x * x).sum(1) + cc[j[:, 0]]
    return out


def sub_dist(rows: torch.Tensor, codebooks: torch.Tensor, mode: str
             ) -> torch.Tensor:
    """``[B, D]`` rows against ``[m, ksub, D/m]`` codebooks ->
    ``[B, m, ksub]`` squared distances per subspace."""
    m = codebooks.shape[0]
    x = cast(rows, mode).reshape(rows.shape[0], m, -1)
    cb = cast(codebooks, mode)
    xx = (x * x).sum(-1, keepdim=True)
    cc = (cb * cb).sum(-1).unsqueeze(0)
    if mode == "tf32":
        x, cb = round_tf32(x), round_tf32(cb)
    return xx - 2.0 * torch.einsum("bmd,mkd->bmk", x, cb) + cc


def encode(rows: torch.Tensor, codebooks: torch.Tensor, mode: str,
           block: int = BLOCK) -> dict:
    """Each row's nearest codeword per subspace (the first of equals). In
    ``f64`` also, per row, the smallest margin of any subspace's best
    codeword over its runner-up, as a share of that subspace's scale."""
    n, m = rows.shape[0], codebooks.shape[0]
    dev = rows.device
    out = {"codes": torch.empty((n, m), dtype=torch.uint8, device=dev)}
    if mode == "f64":
        out["margin"] = torch.empty(n, dtype=torch.float64, device=dev)
        cc = (codebooks.double() ** 2).sum(-1)                  # [m, ksub]
    for i in range(0, n, block):
        d = sub_dist(rows[i:i + block], codebooks, mode)
        if mode != "f64":
            out["codes"][i:i + block] = d.argmin(-1).to(torch.uint8)
            continue
        v, j = torch.topk(d, 2, dim=-1, largest=False, sorted=True)
        out["codes"][i:i + block] = j[..., 0].to(torch.uint8)
        x = rows[i:i + block].double().reshape(-1, m, codebooks.shape[-1])
        scale = (x * x).sum(-1) + torch.gather(
            cc.unsqueeze(0).expand(x.shape[0], -1, -1), 2,
            j[..., :1]).squeeze(-1)
        out["margin"][i:i + block] = ((v[..., 1] - v[..., 0]) / scale
                                      ).amin(1)
    return out


def probe(queries: torch.Tensor, centroids: torch.Tensor, nprobe: int,
          mode: str) -> dict:
    """Each query's ``nprobe`` nearest lists. In ``f64`` also the sorted
    distances to every list and the scale of each pair."""
    d = sq_dist(queries, centroids, mode)
    v, j = torch.sort(d, dim=1, stable=True)
    out = {"lists": j[:, :nprobe]}
    if mode == "f64":
        q = queries.double()
        out["dist"] = d
        out["scale"] = (q * q).sum(1, keepdim=True) \
            + (centroids.double() ** 2).sum(1).unsqueeze(0)
        out["sorted"] = v
    return out


class Lists:
    """Rows grouped by list, for ``(query, row)`` pairs of probed lists.
    ``row_list [N]``: each row's list; a list ``>= n_lists`` is probed by
    no query (rows left out)."""

    def __init__(self, row_list: torch.Tensor, n_lists: int):
        self.order = torch.argsort(row_list, stable=True)
        self.counts = torch.bincount(row_list, minlength=n_lists + 1)[
            :n_lists]
        self.starts = torch.cumsum(self.counts, 0) - self.counts

    def pairs(self, probed: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """``probed [Q, L]`` -> ``(query, row)`` of every row of every
        list each query probes, by query, then list, then row."""
        dev = probed.device
        qi, li = torch.nonzero(probed, as_tuple=True)
        n = self.counts[li]
        total = int(n.sum())
        pair = torch.repeat_interleave(torch.arange(qi.numel(), device=dev),
                                       n, output_size=total)
        off = torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[pair]
        return qi[pair], self.order[self.starts[li][pair] + off]


def segment_topk(q_of: torch.Tensor, d: torch.Tensor, k: int, n_q: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest ``d`` of each query's entries: ``(values [n_q,
    k], entry positions [n_q, k])``, +inf / -1 where fewer."""
    o1 = torch.sort(d, stable=True).indices
    order = o1[torch.sort(q_of[o1], stable=True).indices]
    qs = q_of[order]
    cnt = torch.bincount(qs, minlength=n_q)
    rank = torch.arange(qs.numel(), device=d.device) \
        - (torch.cumsum(cnt, 0) - cnt)[qs]
    keep = rank < k
    vals = torch.full((n_q, k), float("inf"), dtype=d.dtype, device=d.device)
    pos = torch.full((n_q, k), -1, dtype=torch.long, device=d.device)
    vals[qs[keep], rank[keep]] = d[order[keep]]
    pos[qs[keep], rank[keep]] = order[keep]
    return vals, pos


def pair_sq(queries: torch.Tensor, rows: torch.Tensor, qi: torch.Tensor,
            ri: torch.Tensor, mode: str) -> torch.Tensor:
    """Squared distance of each pair ``(queries[qi], rows[ri])``: exact
    differences in ``f64``; the program's expansion otherwise."""
    if mode == "f64":
        return ((queries[qi].double() - rows[ri].double()) ** 2).sum(1)
    q, x = queries[qi].float(), rows[ri].float()
    qq, xx = (q * q).sum(1), (x * x).sum(1)
    if mode == "tf32":
        q, x = round_tf32(q), round_tf32(x)
    return qq - 2.0 * (q * x).sum(1) + xx


def pair_adc(tables: torch.Tensor, codes: torch.Tensor, qi: torch.Tensor,
             ri: torch.Tensor) -> torch.Tensor:
    """ADC distance of each pair: the sum of query ``qi``'s table entries
    at row ``ri``'s codes."""
    m = tables.shape[1]
    c = codes[ri].long()                                          # [E, m]
    return tables[qi.unsqueeze(1), torch.arange(m, device=c.device), c
                  ].sum(1)


def search(queries: torch.Tensor, rows: torch.Tensor, row_list: torch.Tensor,
           centroids: torch.Tensor, k: int, nprobe: int, mode: str,
           codebooks: torch.Tensor | None = None,
           codes: torch.Tensor | None = None, chunk: int = 32
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k of each query among ``rows`` whose list
    (``row_list``) it probes: ``(distances [Q, k], row positions [Q, k])``
    with -1 where fewer rows are probed. Raw rows are scored by their
    squared distance; with ``codebooks`` the rows' ``codes`` are scored by
    ADC. Everything in ``mode``; ``chunk`` queries at a time."""
    qn, n_lists = queries.shape[0], centroids.shape[0]
    lists = probe(queries, centroids, nprobe, mode)["lists"]
    probed = torch.zeros((qn, n_lists), dtype=torch.bool,
                         device=queries.device).scatter_(1, lists, True)
    tables = None if codebooks is None else sub_dist(queries, codebooks,
                                                     mode)
    grouped = Lists(row_list, n_lists)
    dtype = torch.float64 if mode == "f64" else torch.float32
    out_d = torch.empty((qn, k), dtype=dtype, device=queries.device)
    out_r = torch.empty((qn, k), dtype=torch.long, device=queries.device)
    for a in range(0, qn, chunk):
        b = min(a + chunk, qn)
        qi, ri = grouped.pairs(probed[a:b])
        if not qi.numel():
            out_d[a:b], out_r[a:b] = float("inf"), -1
            continue
        d = pair_sq(queries[a:b], rows, qi, ri, mode) if tables is None \
            else pair_adc(tables[a:b], codes, qi, ri)
        v, e = segment_topk(qi, d, k, b - a)
        out_d[a:b] = v
        out_r[a:b] = torch.where(e >= 0, ri[e.clamp(min=0)], -1)
    return out_d, out_r
