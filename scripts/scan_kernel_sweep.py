#!/usr/bin/env python3
"""Time the fused raw scan -> top-k (kernel 1) on one NVIDIA GPU at the
raw path's table, alone or in turns with another checkout.

    python3 scripts/scan_kernel_sweep.py [--seed 0] [--reps 20]
                                         [--tree DIR] [--baseline DIR]

Builds ``csrc/sivf_fused_search.cu`` of the checkout at ``--tree`` (this
one by default) and prints its instances' registers and spills from the
``nvcc -Xptxas -v`` log. Then it builds the raw index of ``chip_smoke.py``
with that script's own workload and traffic, through that checkout's
``sivf_torch.Index`` (SIFT1M shape: 1,000,000
rows of a 128-wide Gaussian mixture made from ``--seed``, IVF4096, C=128,
16,384 overwrites, 100,000 removals), probes its 1024 queries at
nprobe=32 into the ``[1024, 1024]`` slab table, and times
``sivf_fused_search_cuda`` on it (the median of ``--reps`` back-to-back
calls between CUDA events, the whole wrapper call): unfiltered at
Q = 16, 64, 256 and 1024 (the first rows of the table), and filtered at
about 1 %, 10 % and 50 % at Q = 1024; where the checkout's wrapper has
routes (``fused.ROUTES``), each route too. Before it is timed, each
variant is held to the plain version (``==`` on distances and labels) on
the first 64 queries, unfiltered and at 10 %.

With ``--baseline DIR`` (another checkout, say the parent commit unpacked
with ``git archive``) the script runs itself on the baseline, this tree,
this tree and the baseline again, one process each, so that both are
timed in turns on the same card. One JSON object per line, each naming
its tree; the card's ``nvidia-smi`` name and power limit first. Exits 2
without a GPU.
"""
from __future__ import annotations

import argparse
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
    return index, wl["queries"]


def sweep(tree: Path, seed: int, reps: int) -> int:
    import torch
    sys.path[:0] = [str(ROOT), str(tree / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.sivf_scan import fused
    from repro_torch.kernels.sivf_scan.ref import sivf_fused_search_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    secs = _build.build_all(("sivf_fused_search",))
    cs.emit({"tree": str(tree), "build_seconds": secs,
             "ptxas": cs.ptxas_usage(_build.build_log("sivf_fused_search"))})
    t0 = time.perf_counter()
    index, queries = raw_index(torch, cs, seed)
    cfg, st = index.cfg, index.state
    _, table = cs.probe_table(torch, cfg, st, queries)
    cs.emit({"tree": str(tree), "setup_seconds": time.perf_counter() - t0,
             "table": list(table.shape),
             **cs.scan_counts(torch, cfg, st, table)})
    planes = (st.data, st.ids, st.norms, st.bitmap)
    routes = getattr(fused, "ROUTES", None)
    variants = {"default": fused.sivf_fused_search_cuda}
    for r in routes or ():
        variants[r] = (lambda r_: lambda *a, **kw: fused.search_route(
            r_, *a, **kw))(r)
    filters = {}
    for name, pred in cs.filters_of().items():
        fs, fc = cs.compiled(torch, pred)
        filters[name] = dict(attrs=st.attrs, fstruct=fs, fconsts=fc)
    failed = False
    sub = (queries[:cs.CHECK_QUERIES], table[:cs.CHECK_QUERIES].contiguous())
    for vname, fn in variants.items():
        line = {"tree": str(tree), "variant": vname}
        try:
            for kw in ({}, filters[cs.REPRESENTATIVE]):
                dp, lp = sivf_fused_search_ref(*sub, *planes, cs.K, **kw)
                dk, lk = fn(*sub, *planes, cs.K, **kw)
                torch.cuda.synchronize()
                cs.check_equal(f"{vname} {sorted(kw)}", dk, lk, dp, lp)
            line["held_to_plain"] = True
            ms = {}
            for q in cs.SWEEP_QUERIES:
                a = (queries[:q], table[:q].contiguous()) + planes
                ms[f"Q={q}"] = cs.cuda_median_ms(lambda: fn(*a, cs.K), reps)
            a = (queries, table) + planes
            for name, kw in filters.items():
                ms[name] = cs.cuda_median_ms(lambda: fn(*a, cs.K, **kw), reps)
            line["ms"] = ms
            if routes:
                line["route_at_Q=1024"] = fused.route(
                    *table.shape, cfg.capacity, cs.K)
        except Exception as e:                 # report, go on, fail
            failed = True
            line["error"] = f"{type(e).__name__}: {e}"[:600]
        cs.emit(line)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
        return sweep(args.tree.resolve(), args.seed, args.reps)
    rc = 0
    for tree in (args.baseline, ROOT, ROOT, args.baseline):
        rc |= subprocess.run(
            [sys.executable, __file__, "--seed", str(args.seed), "--reps",
             str(args.reps), "--tree", str(tree.resolve())],
            timeout=900).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
