"""Run one cell once: set-up, the measured window, the check, the result.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` prints, as the last line of its standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, then
``setup_phases`` and ``info``, and last ``checks``: each number the
comparison made, with its limit. The same numbers end its standard error.

``--control 1`` (not a timed run: no metrics are printed) also puts the
reference computed in TF32 in the program's place and prints what the
comparison says of it under ``control``: the readings that set the
limits.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from bench.lib import data as datamod
from bench.lib import spec as specmod
from bench.lib.runbook import Client
from bench.lib.trace import Profiler, Timeline, clock_offset, union
from bench.reference import ivf, judge

T_IMPORTED = time.perf_counter()    # numpy, torch and the harness loaded

# top-level module names that may not be loaded once the window closes:
# JAX, its libraries and the JAX package of this repository (whose names
# the port's names begin with, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "sivf")

PLANES = ("owner", "live", "bitmap", "free_stack", "free_top", "tables",
          "table_len", "heads", "n_live", "att_slab", "att_slot", "ids",
          "data", "codes")


def forbidden_modules(names=None) -> list[str]:
    """Top-level names in ``sys.modules`` (or ``names``) that are JAX or
    the JAX package, compared whole."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None
                                      else names)}
    return sorted(t for t in tops if t in FORBIDDEN)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Marks:
    """Set-up phases: seconds between marks, the device synchronised.
    ``before`` holds the phases timed before the first mark; ``process``
    is the rest of the time from ``t_start`` to it."""

    def __init__(self, dev, t_start: float, before: dict | None = None):
        self.dev, self.last = dev, time.perf_counter()
        self.phases = dict(before or {})
        self.phases["process"] = self.last - t_start - sum(
            self.phases.values())

    def __call__(self, name: str) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.phases[name] = now - self.last
        self.last = now


def index_config(config: dict):
    import sivf_torch
    ix = config["index"]
    pq = ix.get("pq")
    return sivf_torch.SIVFConfig(
        dim=int(config["data"]["dim"]), n_lists=int(ix["n_lists"]),
        n_slabs=int(ix["n_slabs"]), capacity=int(ix["capacity"]),
        n_max=int(ix["n_max"]), metric=config["data"]["metric"],
        max_chain=int(ix["max_chain"]),
        pq=None if not pq else sivf_torch.PQConfig(
            m=int(pq["m"]), nbits=int(pq["nbits"])))


def end_to_end(client: Client, w0: int, w1: int) -> dict:
    window_s = (w1 - w0) / 1e9
    lat = {"search": [], "add": [], "remove": []}
    queries = 0
    for c in client.calls:
        lat[c.kind].append((c.t1 - c.t0) / 1e6)
        if c.kind == "search":
            queries += c.n
    out = {"window_s": window_s}
    if lat["search"]:
        out["search_qps"] = queries / window_s
        out["search_p95_ms"] = percentile(lat["search"], 95)
        out["search_p50_ms"] = percentile(lat["search"], 50)
    if lat["add"]:
        out["ingest_rows_per_s"] = client.acked_rows / window_s
    if lat["remove"]:
        out["delete_p95_ms"] = percentile(lat["remove"], 95)
        out["delete_p50_ms"] = percentile(lat["remove"], 50)
    out["calls"] = {k: len(v) for k, v in lat.items()}
    return out


def list_stats(planes: dict, capacity: int, n_lists: int) -> dict:
    """The Faiss imbalance factor of the lists, the longest list and the
    longest chain of slabs."""
    owner = planes["owner"].long()
    owned = owner >= 0
    per = torch.zeros(n_lists, dtype=torch.float64, device=owner.device
                      ).index_add_(0, owner.clamp(min=0),
                                   torch.where(owned, planes["live"], 0
                                               ).double())
    tot = float(per.sum())
    return {"imbalance_factor": n_lists * float((per * per).sum())
            / max(tot * tot, 1.0),
            "longest_list": int(per.max()),
            "longest_chain": int(planes["table_len"].max()),
            "slabs_used": int(owned.sum())}


class Context:
    """What a per-layer metric's reader gets: the traced window's
    timeline, its calls, the work counts of sampled search calls, the
    configuration and the device's name."""

    def __init__(self, timeline: Timeline, work: dict, config: dict,
                 device_name: str):
        self.timeline, self.work, self.config = timeline, work, config
        self.device_name = device_name

    def calls(self, kind: str) -> list:
        return [c for c in self.timeline.calls if c.kind == kind]

    def busy_ms(self, call) -> float:
        return self.timeline.busy_ns(call.t0, call.t1) / 1e6

    def events(self, call) -> list:
        """``(name, start, end)`` of the device events that start inside
        ``call``, by start (``bench/lib/kernels.py`` tells them apart)."""
        return self.timeline.events_in(call.t0, call.t1)


def scan_work(truth: judge.Truth, client: Client, calls: list) -> dict:
    """For search calls: the live rows of the distinct lists their queries
    probe (by the reference's probe and lists) and the (query, row)
    pairs, keyed by the call's index among the window's calls."""
    out = {}
    n_lists = truth.centroids.shape[0]
    for j, c in calls:
        q = client.queries_of(c.src, c.n)
        lists = ivf.probe(q, truth.centroids, truth.nprobe, "f64")["lists"]
        pos = torch.arange(c.lo, c.hi, device=q.device) % truth.P
        per = torch.bincount(truth.assign["list"][pos], minlength=n_lists)
        rows = int(per[torch.unique(lists)].sum())
        pairs = int(per[lists].sum())
        out[j] = {"rows": rows, "pairs": pairs, "queries": c.n}
    return out


def run_cell(cell: specmod.Cell, seed: int, seconds: float, trace: bool,
             dev, t_start: float, control: bool = False, wrap_index=None,
             log=lambda s: print(s, file=sys.stderr, flush=True),
             before: dict | None = None) -> dict:
    """One run of ``cell`` on ``dev``. ``wrap_index`` (tests only) wraps
    the index after set-up, to plant a fault under the timed path;
    ``before``: set-up phases timed before the call (``Marks``)."""
    dev = torch.device(dev)
    config, traffic = cell.config, cell.traffic
    ix = config["index"]
    mark = Marks(dev, t_start, before)
    torch.zeros(1, device=dev)          # the device's context
    mark("context")
    import sivf_torch
    from repro_torch.kernels import _build
    mark("imports")
    if dev.type == "cuda":
        for name in config["kernels"]:
            _build.load(name)
    mark("libraries")
    torch.backends.cuda.matmul.allow_tf32 = False    # float32, as stated
    torch.backends.cudnn.allow_tf32 = False
    inputs = datamod.make_inputs(config, seed, dev, mark)
    index = sivf_torch.Index(index_config(config), inputs.centroids,
                             device=dev, pq_codebooks=inputs.codebooks)
    mark("index")
    client = Client(index, inputs.pool, inputs.queries, inputs.gen, config,
                    traffic, seed)
    client.fill(int(config["live_rows"]), int(config["ingest_batch"]))
    mark("ingest")
    if wrap_index is not None:
        client.index = wrap_index(index)
    for _ in range(int(traffic["warmup_steps"])):
        client.step(record=False)
    mark("warmup")
    setup_s = time.perf_counter() - t_start
    wrong_before = client.reports_wrong

    prof = Profiler(dev) if trace else None
    if prof is not None:
        prof.__enter__()
    offset = clock_offset()
    w0, w1 = client.run(seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e = end_to_end(client, w0, w1)
    failed = client.reports_wrong - wrong_before

    # -- the check: the final state first, then the program is freed -------
    t_check = time.perf_counter()
    st = index.state
    planes = {p: getattr(st, p) for p in PLANES}
    n_max, P = int(ix["n_max"]), int(config["pool_rows"])
    lo, hi = client.lo, client.hi
    fctr = torch.arange(lo, hi, device=dev)
    fpos = fctr % P
    pq = bool(ix.get("pq"))
    fa = judge.final_answers(planes, int(ix["capacity"]), fctr % n_max,
                             None if pq else inputs.pool[fpos])
    checks = {"report_wrong": client.reports_wrong,
              "live_ids_wrong": fa["live_ids_wrong"],
              "pool_violations": judge.pool_violations(
                  planes, int(ix["capacity"]), int(ix["n_lists"]))}
    if not pq:
        checks["payload_wrong"] = fa["payload_wrong"]
    lists = list_stats(planes, int(ix["capacity"]), int(ix["n_lists"]))
    del planes, st, index
    client.index = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limits = config["limits"]
    truth = judge.Truth(
        pool=inputs.pool, centroids=inputs.centroids,
        assign=ivf.assign(inputs.pool, inputs.centroids, "f64"),
        codebooks=inputs.codebooks,
        encode=None if not pq else ivf.encode(inputs.pool, inputs.codebooks,
                                              "f64"),
        n_max=n_max, k=int(config["data"]["k"]), nprobe=int(ix["nprobe"]),
        limits=limits)
    sampled = client.checked_calls()
    for c in sampled:
        c["queries"] = client.queries_of(c["src"], c["n"])
    judged = judge.judge_answers(
        truth, judge.Known(lo, fa["list"], fa["found"], fa.get("codes")),
        sampled)
    unver = judged.pop("unverifiable")
    checks.update(judged)
    limit_of = {name: limits.get(name, 0) for name in checks}
    correct = all(checks[n] <= limit_of[n] for n in checks)
    check_s = time.perf_counter() - t_check

    info = {"window_s": e2e["window_s"], "calls": e2e["calls"],
            "search_calls_checked": len(sampled),
            "queries_checked": sum(c["n"] for c in sampled),
            "unverifiable": unver, "check_s": check_s,
            "final_live": hi - lo, **lists}
    for key in ("search_p50_ms", "delete_p50_ms", "delete_p95_ms"):
        if key in e2e:
            info[key] = e2e[key]
    result = {"correct": bool(correct),
              "attempted": sum(e2e["calls"].values()), "failed": failed}
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": name, "count": 1, "memory_peak_bytes": int(peak)}
    result["device"] = device

    if trace:
        events = prof.events()
        tl = Timeline(events, union(events), client.calls, offset, w0, w1)
        device["busy_s"] = tl.busy_s
        device["window_s"] = tl.window_s
        searches = [(j, c) for j, c in enumerate(client.calls)
                    if c.kind == "search"]
        rng = np.random.default_rng(seed + 1)
        n_work = min(len(searches), int(traffic["roofline_calls"]))
        pick = sorted(rng.choice(len(searches), n_work, replace=False)) \
            if n_work else []
        work = scan_work(truth, client, [searches[i] for i in pick])
        ctx = Context(tl, work, config, name)
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = tl.breakdown()
    else:
        result["metrics"] = {
            m["name"]: {"value": float(setup_s if m["name"] == "setup_s"
                                       else e2e[m["name"]]),
                        "unit": m["unit"]}
            for m in cell.end_to_end}
    result["setup_phases"] = mark.phases
    result["info"] = info

    if control:
        t_c = time.perf_counter()
        cnum = judge.judge_answers(truth, *judge.control_answers(
            truth, "tf32", lo, hi, sampled))
        del cnum["unverifiable"]
        result["control"] = {
            "mode": "tf32", "seconds": time.perf_counter() - t_c,
            "correct": all(cnum[n] <= limit_of[n] for n in cnum),
            "numbers": {n: {"value": v, "limit": limit_of[n]}
                        for n, v in cnum.items()}}
        del result["metrics"]

    result["checks"] = {n: {"value": checks[n], "limit": limit_of[n]}
                        for n in checks}
    for n in checks:
        log(f"check {n} {checks[n]!r} limit {limit_of[n]!r}")
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = specmod.resolve(args.workload)
    t_lookup = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    t_probe = time.perf_counter()
    before = {"torch_import": T_IMPORTED - t_start,
              "lookup": t_lookup - T_IMPORTED,
              "cuda_probe": t_probe - t_lookup}
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t_start, control=bool(args.control),
                      before=before)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
