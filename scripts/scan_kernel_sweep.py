#!/usr/bin/env python3
"""Time a scan kernel on one NVIDIA GPU at its path's table, alone or in
turns with another checkout.

    python3 scripts/scan_kernel_sweep.py [--kernel raw|pq|scan|topk|kmeans]
                                         [--seed 0] [--reps 20] [--tree DIR]
                                         [--baseline DIR]

``--kernel raw`` (the default) times kernel 1, ``csrc/sivf_fused_search.cu``;
``--kernel pq`` times kernel 2, ``csrc/sivf_pq_fused_search.cu``;
``--kernel scan`` and ``--kernel topk`` time the unfused pair, kernel 3
(``csrc/sivf_scan.cu``) on the raw path's table and kernel 4
(``csrc/topk.cu``) on kernel 3's ``[Q, T*C]`` output of it, k = 10, each
at Q = 16, 64, 256 and 1024 (the first rows), on the wrapper's own route
and, where the checkout's wrapper has routes, on each route that takes
the shape; before it is timed each variant is held ``==`` to the plain version
on the first 64 queries (the top-k on all rows), then makes ``--reps``
untimed calls at each Q (the first timings of a process ran slow
without them). For ``scan`` the default
call is also timed on a table of ``-1`` pads only (``all_pad_table_ms``:
writing the outputs without a slab to score). ``--kernel kmeans`` times
no kernel but the k-means training on the card
(``core/quantizer.py::train_kmeans``) as ``chip_smoke.py`` trains: the
coarse IVF4096 centroids on its 65,536-row sample of the workload, and
the PQ32 x 256 codebooks on the same rows, each ``--reps`` times from one
generator state after a first training, with each run's ms (between
CUDA events) and the digests of what it trained, which must all be
equal. For the other kernels the script
builds the kernel's source of the checkout at ``--tree`` (this one by
default) and prints its instances' registers and spills from the ``nvcc
-Xptxas -v`` log. Then it builds the path's index of ``chip_smoke.py`` with
that script's own workload and traffic, through that checkout's
``sivf_torch.Index`` (SIFT1M shape: 1,000,000 rows of a 128-wide Gaussian
mixture made from ``--seed``, IVF4096, C=128, 16,384 overwrites, 100,000
removals; for ``pq`` the IVF4096,PQ32 index trained on 65,536 rows),
probes its 1024 queries at nprobe=32 into the ``[1024, 1024]`` slab table
(and for ``pq`` builds their ADC tables once), and times the kernel's
wrapper on it (the median of ``--reps`` back-to-back calls between CUDA
events, the whole wrapper call): unfiltered at Q = 16, 64, 256 and 1024
(the first rows of the table), and filtered at about 1 %, 10 % and 50 % at
Q = 1024; where the checkout's wrapper has routes (``ROUTES``), each route
too. At Q = 16 .. 256 a call is mostly host time, so each variant's call
is also captured in a CUDA graph and its replays timed the same way
(``graph_ms``: the device's time). Before it is timed, each variant is held
to the plain version (``==`` on distances and labels) on the first 64
queries, unfiltered and at 10 %; for ``raw`` each variant's distances on
all queries, unfiltered and at 10 %, are read against the float64
distances of the rows they label (``fp32_limit_share``, the share of the
1e-5 limit used: ``chip_smoke.fp32_share``). For ``pq`` the set-up line
also gives a
digest of the codebooks trained on the card and the index's recall@10, so
that runs at one seed show whether training repeats itself.

With ``--baseline DIR`` (another checkout, say the parent commit unpacked
with ``git archive``) the script runs itself on the baseline, this tree,
this tree and the baseline again, one process each, so that both are
timed in turns on the same card. One JSON object per line, each naming
its tree; the card's ``nvidia-smi`` name and power limit first. Exits 2
without a GPU.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def raw_index(torch, cs, seed: int):
    """The raw path's index after ``chip_smoke.py``'s traffic (its own
    ``phase_workload`` and ``drive``, checks included), and its queries."""
    import sivf_torch
    wl, _ = cs.phase_workload(torch, seed)
    index = sivf_torch.Index(sivf_torch.SIVFConfig(**cs.CFG), wl["cents"],
                             device="cuda")
    cs.drive(torch, index, wl, "raw", {})
    torch.cuda.synchronize()
    return index, wl["queries"], {}


def pq_index(torch, cs, seed: int):
    """The PQ path's index (trained as ``chip_smoke.py``'s ``pq`` path
    trains it) after the same traffic, its queries, and its codebooks'
    digest and recall@10 against exact search."""
    import sivf_torch
    wl, _ = cs.phase_workload(torch, seed)
    cfg = sivf_torch.SIVFConfig(**cs.CFG, pq=sivf_torch.PQConfig(
        m=cs.PQ_M, nbits=cs.PQ_NBITS))
    index = sivf_torch.Index(cfg, wl["cents"], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    index.train(wl["sample"], generator=gen)
    out = {}
    cs.drive(torch, index, wl, "pq", out)
    torch.cuda.synchronize()
    return index, wl["queries"], {
        "pq_codebooks_sha256": cs.digest(index.state.pq_codebooks),
        "recall_at_10_vs_exact": cs.recall(torch, out["result"].labels,
                                           wl["oracle"]["unfiltered"])}


def graph_ms(torch, cs, fn, reps: int) -> float:
    """Median ms of replays of ``fn()`` captured in a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cs.cuda_median_ms(g.replay, reps)


def unfused_variants(mod, kernel: str) -> dict:
    """The timed variants of kernel 3 (``scan``) or 4 (``topk``): the
    wrapper's own route and each named route, as ``fn(rows, ...)``; a
    checkout whose wrapper has no routes gives the first alone."""
    if kernel == "scan":
        out = {"default": mod.sivf_scan_cuda}
        for r in getattr(mod, "ROUTES", ()):
            out[r] = (lambda r_: lambda *a: mod.scan_route(r_, *a))(r)
        return out
    out = {"default": mod.topk_cuda}
    for r in getattr(mod, "ROUTES", ()):
        out[r] = (lambda r_: lambda *a: mod.topk_route(r_, *a))(r)
    return out


def sweep_unfused(torch, cs, tree: Path, kernel: str, seed: int,
                  reps: int) -> int:
    """Kernel 3 or 4 at the raw path's table (see the module's text)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sivf_scan import sivf_scan as scan_mod
    from repro_torch.kernels.sivf_scan.ref import sivf_scan_ref
    from repro_torch.kernels.topk import topk as topk_mod
    from repro_torch.kernels.topk.ref import topk_ref
    secs = _build.build_all(("sivf_scan", "topk"))
    cs.emit({"tree": str(tree), "kernel": kernel, "build_seconds": secs,
             "ptxas": {n: cs.ptxas_usage(_build.build_log(n))
                       for n in ("sivf_scan", "topk")}})
    t0 = time.perf_counter()
    index, queries, _ = raw_index(torch, cs, seed)
    cfg, st = index.cfg, index.state
    _, table = cs.probe_table(torch, cfg, st, queries)
    cs.emit({"tree": str(tree), "setup_seconds": time.perf_counter() - t0,
             "table": list(table.shape),
             **cs.scan_counts(torch, cfg, st, table)})
    planes = (st.data, st.ids, st.norms, st.bitmap)
    inputs = {}                 # Q -> the timed variants' operands
    for q in cs.SWEEP_QUERIES:
        a = (queries[:q], table[:q].contiguous()) + planes
        inputs[q] = a if kernel == "scan" else \
            scan_mod.sivf_scan_cuda(*a, cfg.metric) + (cs.K,)
    mod = scan_mod if kernel == "scan" else topk_mod
    failed = False
    for vname, fn in unfused_variants(mod, kernel).items():
        line = {"tree": str(tree), "kernel": kernel, "variant": vname}
        try:
            if kernel == "scan":
                a = inputs[cs.N_QUERIES]
                sub = (a[0][:cs.CHECK_QUERIES],
                       a[1][:cs.CHECK_QUERIES].contiguous()) + planes
                dk, lk = fn(*sub, cfg.metric)
                torch.cuda.synchronize()
                cs.check_equal(vname, dk, lk, *sivf_scan_ref(*sub,
                                                            cfg.metric))
            else:
                a = inputs[cs.N_QUERIES]
                dk, lk = fn(*a)
                torch.cuda.synchronize()
                cs.check_equal(vname, dk, lk, *topk_ref(*a))
            del dk, lk
            line["held_to_plain"] = True
            ms, gms, routes = {}, {}, {}
            calls = {q: (lambda a_: lambda: fn(*a_, cfg.metric))(a)
                     if kernel == "scan" else (lambda a_: lambda: fn(*a_))(a)
                     for q, a in inputs.items()}
            for call in calls.values():        # untimed: a card at rest
                for _ in range(reps):          # first runs small calls slow
                    call()
            for q, a in inputs.items():
                call = calls[q]
                ms[f"Q={q}"] = cs.cuda_median_ms(call, reps)
                if q < cs.N_QUERIES:
                    gms[f"Q={q}"] = graph_ms(torch, cs, call, reps)
                if vname == "default" and hasattr(mod, "ROUTES"):
                    routes[f"Q={q}"] = (
                        mod.launch_plan(*a[:3]) if kernel == "scan"
                        else mod.launch_plan(a[0], cs.K))["route"]
            line.update(ms=ms, graph_ms=gms)
            if routes:
                line["route"] = routes
            if kernel == "scan" and vname == "default":
                # the same call on a table of -1 pads only: the output's
                # fill alone (and the plan), without a slab to score
                a = inputs[cs.N_QUERIES]
                pads = (a[0], torch.full_like(a[1], -1)) + planes
                line["all_pad_table_ms"] = cs.cuda_median_ms(
                    lambda: fn(*pads, cfg.metric), reps)
        except Exception as e:                 # report, go on, fail
            failed = True
            line["error"] = f"{type(e).__name__}: {e}"[:600]
        cs.emit(line)
    return 1 if failed else 0


def sweep_kmeans(torch, cs, tree: Path, seed: int, reps: int) -> int:
    """The coarse and PQ k-means trainings (see the module's text)."""
    import sivf_torch
    from repro_torch.core import pq
    base, _, _ = cs.make_data(torch, seed, cs.N_BASE)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sample = base[torch.randperm(cs.N_BASE, generator=gen, device="cuda")
                  [:cs.TRAIN_ROWS]]
    coarse_state = gen.get_state()
    del base
    jobs = {"coarse": (lambda g: sivf_torch.train_kmeans(
                sample, cs.N_LISTS, generator=g), coarse_state,
                       [cs.TRAIN_ROWS, cs.DIM, cs.N_LISTS]),
            "pq": (lambda g: pq.train_pq(sample, cs.PQ_M, cs.PQ_NBITS,
                                         generator=g),
                   torch.Generator(device="cuda").manual_seed(seed).get_state(),
                   [cs.PQ_M, cs.TRAIN_ROWS, cs.DIM // cs.PQ_M,
                    1 << cs.PQ_NBITS])}
    failed = False
    for name, (job, state, shape) in jobs.items():
        ms, digests = [], []
        for i in range(reps + 1):             # the first: first use
            g = torch.Generator(device="cuda")
            g.set_state(state)
            out, t = cs.timed(lambda: job(g))
            digests.append(cs.digest(out))
            if i:
                ms.append(t)
        repeats = len(set(digests)) == 1
        failed |= not repeats
        cs.emit({"tree": str(tree), "kernel": "kmeans", "job": name,
                 "shape": shape, "ms": ms, "median_ms": statistics.median(ms),
                 "digests": sorted(set(digests)), "repeats": repeats})
    return 1 if failed else 0


def sweep(tree: Path, kernel: str, seed: int, reps: int) -> int:
    import torch
    sys.path[:0] = [str(ROOT), str(tree / "src")]
    import chip_smoke as cs
    import sivf_torch  # noqa: F401  (the core first: the kernels import it)
    from repro_torch.kernels import _build
    from repro_torch.kernels.sivf_scan import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    if kernel == "kmeans":
        return sweep_kmeans(torch, cs, tree, seed, reps)
    if kernel in ("scan", "topk"):
        return sweep_unfused(torch, cs, tree, kernel, seed, reps)
    source = "sivf_fused_search" if kernel == "raw" else "sivf_pq_fused_search"
    secs = _build.build_all((source,))
    cs.emit({"tree": str(tree), "kernel": kernel, "build_seconds": secs,
             "ptxas": cs.ptxas_usage(_build.build_log(source))})
    t0 = time.perf_counter()
    index, queries, quality = (raw_index if kernel == "raw" else pq_index)(
        torch, cs, seed)
    cfg, st = index.cfg, index.state
    _, table = cs.probe_table(torch, cfg, st, queries)
    cs.emit({"tree": str(tree), "setup_seconds": time.perf_counter() - t0,
             "table": list(table.shape), **quality,
             **cs.scan_counts(torch, cfg, st, table)})
    if kernel == "raw":
        from repro_torch.kernels.sivf_scan import fused as mod
        rows, planes = queries, (st.data, st.ids, st.norms, st.bitmap)
        plain, default = ref.sivf_fused_search_ref, mod.sivf_fused_search_cuda
    else:
        from repro_torch.core import pq
        from repro_torch.kernels.sivf_scan import pq_fused as mod
        rows = pq.adc_tables(st.pq_codebooks, queries,
                             cfg.metric).contiguous()
        planes = (st.codes, st.ids, st.bitmap)
        plain = ref.sivf_pq_fused_search_ref
        default = mod.sivf_pq_fused_search_cuda
    routes = getattr(mod, "ROUTES", None)
    variants = {"default": default}
    for r in routes or ():
        variants[r] = (lambda r_: lambda *a, **kw: mod.search_route(
            r_, *a, **kw))(r)
    filters = {}
    for name, pred in cs.filters_of().items():
        fs, fc = cs.compiled(torch, pred)
        filters[name] = dict(attrs=st.attrs, fstruct=fs, fconsts=fc)
    failed = False
    sub = (rows[:cs.CHECK_QUERIES], table[:cs.CHECK_QUERIES].contiguous())
    for vname, fn in variants.items():
        line = {"tree": str(tree), "kernel": kernel, "variant": vname}
        try:
            for kw in ({}, filters[cs.REPRESENTATIVE]):
                dp, lp = plain(*sub, *planes, cs.K, **kw)
                dk, lk = fn(*sub, *planes, cs.K, **kw)
                torch.cuda.synchronize()
                cs.check_equal(f"{vname} {sorted(kw)}", dk, lk, dp, lp)
            line["held_to_plain"] = True
            if kernel == "raw":     # all queries, against float64
                line["fp32_limit_share"] = {
                    name: cs.fp32_share(torch, st, rows, *fn(
                        rows, table, *planes, cs.K, **kw))
                    for name, kw in (("unfiltered", {}), (
                        cs.REPRESENTATIVE, filters[cs.REPRESENTATIVE]))}
            ms, gms = {}, {}
            for q in cs.SWEEP_QUERIES:
                a = (rows[:q], table[:q].contiguous()) + planes
                ms[f"Q={q}"] = cs.cuda_median_ms(lambda: fn(*a, cs.K), reps)
                if q < cs.N_QUERIES:
                    gms[f"Q={q}"] = graph_ms(torch, cs,
                                             lambda: fn(*a, cs.K), reps)
            a = (rows, table) + planes
            for name, kw in filters.items():
                ms[name] = cs.cuda_median_ms(lambda: fn(*a, cs.K, **kw), reps)
            line["ms"] = ms
            line["graph_ms"] = gms
            if routes:
                line["route_at_Q=1024"] = (
                    mod.route(*table.shape, cfg.capacity, cs.K)
                    if kernel == "raw" else
                    mod.launch_plan(rows, table, st.codes, cs.K))
        except Exception as e:                 # report, go on, fail
            failed = True
            line["error"] = f"{type(e).__name__}: {e}"[:600]
        cs.emit(line)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("raw", "pq", "scan", "topk",
                                         "kmeans"),
                    default="raw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--baseline", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("scan_kernel_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    print(cs.smi(), flush=True)
    if args.baseline is None:
        return sweep(args.tree.resolve(), args.kernel, args.seed, args.reps)
    rc = 0
    for tree in (args.baseline, ROOT, ROOT, args.baseline):
        rc |= subprocess.run(
            [sys.executable, __file__, "--kernel", args.kernel, "--seed",
             str(args.seed), "--reps", str(args.reps), "--tree",
             str(tree.resolve())], timeout=900).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
