"""The one general generator: a runbook client that drives ``Index``.

A traffic mix is a data file (``bench/traffic/<mix>.json``) that this
module reads; no mix has code of its own. A mix lists the ops of one
step, which one client runs in order and repeats (a closed loop: each call
waits for the one before):

``{"op": "add", "rows": n}``      ``Index.add`` of the next ``n`` rows of
                                  the stream, under the next ``n`` ids;
``{"op": "remove", "rows": n}``   ``Index.remove`` of the ``n`` oldest ids;
``{"op": "search", "calls": c, "queries": q, "from": src}``
                                  ``c`` calls of ``Index.search`` with ``q``
                                  queries each, drawn from the query set
                                  in a seeded order (``"query_set"``) or
                                  from the rows of the last add
                                  (``"last_add"``, a seeded choice of rows:
                                  a search that reads its writes).

Rows and ids are a stream: counter ``c`` carries row ``pool[c % P]`` and
id ``c % n_max``. Removes take the oldest counters, so the live set is
always one range ``[lo, hi)`` of counters, and the log of the run is
those two numbers at each call. The client copies every search's
results to the host before its next call; ``add`` and ``remove`` return
with their reports (eager calls).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


def ring_slice(t: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """``n`` rows of ``t`` from ``start``, wrapping at its end (a view
    unless it wraps)."""
    size = t.shape[0]
    start %= size
    if start + n <= size:
        return t[start:start + n]
    return torch.cat([t[start:], t[:n - (size - start)]])


@dataclasses.dataclass
class Call:
    kind: str          # "search" | "add" | "remove"
    t0: int            # perf_counter_ns at the call
    t_ret: int         # when Index returned (searches: before the copy)
    t1: int            # when the client had its answer on the host
    n: int             # rows or queries
    lo: int            # live counters [lo, hi) when the call was made
    hi: int
    src: tuple = ()    # a search's queries: ("set", offset) | ("add", c0, n)


class Client:
    """One runbook client over ``index`` (see the module docstring)."""

    def __init__(self, index, pool: torch.Tensor, queries: torch.Tensor,
                 gen: torch.Generator, config: dict, traffic: dict,
                 seed: int):
        self.index, self.pool, self.queries = index, pool, queries
        self.traffic = traffic
        self.steps = traffic["step"]
        ix = config["index"]
        self.k, self.nprobe = int(config["data"]["k"]), int(ix["nprobe"])
        self.n_max = int(ix["n_max"])
        dev = pool.device
        self.ids_ring = torch.arange(self.n_max, dtype=torch.int32,
                                     device=dev)
        qn = queries.shape[0]
        perm = torch.randperm(qn, generator=gen, device=dev)
        self.q_mat = queries[torch.cat([perm, perm])]   # a call reads a slice
        self.q_off = 0
        adds = [op["rows"] for op in self.steps if op["op"] == "add"]
        last_q = [op["queries"] for op in self.steps
                  if op["op"] == "search" and op["from"] == "last_add"]
        self.pick = torch.randperm(max(adds), generator=gen, device=dev)[
            :max(last_q)] if last_q else None
        self.lo = self.hi = 0
        self.last_add: tuple[int, int] | None = None
        self.rng = np.random.default_rng(seed)
        self.n_keep = int(traffic["check_search_calls"])
        self.kept: list[dict] = []       # reservoir of search calls
        self.last: dict | None = None    # the last search call
        self.n_search = 0
        self.reports_wrong = 0
        self.calls: list[Call] = []
        self.acked_rows = 0

    # -- the ops -------------------------------------------------------------

    def add(self, n: int, record: bool = True) -> None:
        c0 = self.hi
        rows = ring_slice(self.pool, c0, n)
        ids = ring_slice(self.ids_ring, c0, n)
        t0 = time.perf_counter_ns()
        rep = self.index.add(rows, ids)
        t1 = time.perf_counter_ns()
        ok = rep.accepted == n and rep.rejected == 0 \
            and rep.overwritten == 0 and int(rep.errors) == 0
        self.reports_wrong += not ok
        self.hi += n
        self.last_add = (c0, n)
        if record:
            self.acked_rows += int(rep.accepted)
            self.calls.append(Call("add", t0, t1, t1, n, self.lo, self.hi))

    def remove(self, n: int, record: bool = True) -> None:
        ids = ring_slice(self.ids_ring, self.lo, n)
        t0 = time.perf_counter_ns()
        rep = self.index.remove(ids)
        t1 = time.perf_counter_ns()
        ok = rep.accepted == n and int(rep.errors) == 0
        self.reports_wrong += not ok
        self.lo += n
        if record:
            self.calls.append(Call("remove", t0, t1, t1, n, self.lo,
                                   self.hi))

    def _queries(self, q: int, src: str) -> tuple[torch.Tensor, tuple]:
        if src == "query_set":
            off = self.q_off
            self.q_off = (off + q) % self.queries.shape[0]
            return self.q_mat[off:off + q], ("set", off)
        c0, n = self.last_add
        return ring_slice(self.pool, c0, n)[self.pick[:q]], ("add", c0, n)

    def search(self, q: int, src: str, record: bool = True) -> None:
        qs, where = self._queries(q, src)
        t0 = time.perf_counter_ns()
        res = self.index.search(qs, self.k, self.nprobe)
        t_ret = time.perf_counter_ns()
        dists, labels = res.distances.cpu(), res.labels.cpu()
        t1 = time.perf_counter_ns()
        if not record:
            return
        self.calls.append(Call("search", t0, t_ret, t1, q, self.lo, self.hi,
                               where))
        kept = {"call": self.n_search, "lo": self.lo, "hi": self.hi,
                "src": where, "n": q, "labels": labels, "dists": dists}
        j = self.n_search
        if j < self.n_keep:
            self.kept.append(kept)
        else:
            r = int(self.rng.integers(0, j + 1))
            if r < self.n_keep:
                self.kept[r] = kept
        self.last = kept
        self.n_search += 1

    def step(self, record: bool = True) -> None:
        for op in self.steps:
            if op["op"] == "add":
                self.add(int(op["rows"]), record)
            elif op["op"] == "remove":
                self.remove(int(op["rows"]), record)
            elif op["op"] == "search":
                for _ in range(int(op["calls"])):
                    self.search(int(op["queries"]), op["from"], record)
            else:
                raise ValueError(f"unknown op {op['op']!r}")

    # -- set-up and the window -----------------------------------------------

    def fill(self, live: int, batch: int) -> None:
        """Set-up: ingest the live set through ``add`` in ``batch``-row
        batches (the last one shorter)."""
        while self.hi < live:
            self.add(min(batch, live - self.hi), record=False)

    def run(self, seconds: float) -> tuple[int, int]:
        """Whole steps until ``seconds`` have passed: the window's start
        and end, perf_counter_ns."""
        t0 = time.perf_counter_ns()
        end = t0 + int(seconds * 1e9)
        while True:
            self.step()
            t1 = time.perf_counter_ns()
            if t1 >= end:
                return t0, t1

    def checked_calls(self) -> list[dict]:
        """The sampled search calls, and the last one, by call order."""
        out = {c["call"]: c for c in self.kept}
        if self.last is not None:
            out[self.last["call"]] = self.last
        return [out[j] for j in sorted(out)]

    def queries_of(self, src: tuple, q: int) -> torch.Tensor:
        """The ``q`` query rows a call with source ``src`` sent."""
        if src[0] == "set":
            return self.q_mat[src[1]:src[1] + q]
        return ring_slice(self.pool, src[1], src[2])[self.pick[:q]]
