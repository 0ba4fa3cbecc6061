#!/usr/bin/env python3
"""Smoke run of the PyTorch port of SIVF on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
for ``sm_90a``, holds each kernel against its plain PyTorch version on the
card, then drives the main path through ``sivf_torch.Index(device="cuda")``
at the shape of the SIFT1M benchmark (ann-benchmarks ``sift-128-euclidean``:
1,000,000 base vectors, dim 128, L2, k=10) with Faiss's ``IVF4096,Flat``
list count. The data is a synthetic 128-wide Gaussian mixture made from
``--seed`` with numpy; no dataset file is read.

Output: one JSON object per line, in this order: the card and toolchain,
the kernel build, the kernel-vs-plain checks, each main-path phase, the
full-size kernel checks and timings, the ``{"kernels": [...]}`` summary,
the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check makes the exit code 1
and suppresses the last line. Without a GPU it exits 2 and prints no
result. It imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# SIFT1M shape (ann-benchmarks sift-128-euclidean) with Faiss IVF4096,Flat
N_BASE, DIM, N_LISTS, K = 1_000_000, 128, 4096, 10
CFG = dict(dim=DIM, n_lists=N_LISTS, n_slabs=16384, capacity=128,
           n_max=1 << 21, max_chain=32, metric="l2")
INGEST_BATCH, OVERWRITE_ROWS = 16384, 16384
REMOVE_ROWS, REMOVE_BATCH = 100_000, 65536
N_QUERIES, NPROBE, TRAIN_ROWS = 1024, 32, 65536
RTOL = 1e-5                       # distance tolerance, kernel vs plain
FP32_PEAK = 67e12                 # H100 SXM fp32 (non-tensor) FLOP/s


class CheckFailed(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name: str) -> float:
    """Published HBM rate: 2.0 TB/s for H100 PCIe, else 3.35 TB/s (SXM)."""
    return 2.0e12 if "PCIe" in name else 3.35e12


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_topk(dk, lk, dp, lp) -> tuple[float, int]:
    """Hold a kernel's top-k against the plain version's.

    Distances: allclose(rtol=atol=1e-5). Labels: equal, except inside
    near-tie groups (adjacent plain distances within 1e-5 relative) where
    the label sets must agree; a group that reaches the k-th position may
    hold other tied candidates. Returns (max |dist diff|, tie groups).
    """
    dk, lk, dp, lp = (t.cpu().numpy() for t in (dk, lk, dp, lp))
    check(dk.shape == dp.shape and lk.shape == lp.shape, "shape mismatch")
    close = np.isclose(dk, dp, rtol=RTOL, atol=RTOL)
    if not close.all():
        r, j = np.argwhere(~close)[0]
        raise CheckFailed(
            f"{int((~close).sum())} of {close.size} distances differ beyond "
            f"rtol=atol=1e-5; first at row {r} pos {j}: kernel "
            f"{dk[r, j]!r} label {lk[r, j]} vs plain {dp[r, j]!r} label "
            f"{lp[r, j]}; kernel row {dk[r].tolist()} plain row "
            f"{dp[r].tolist()}")
    fin = np.isfinite(dp)
    err = float(np.abs(dk[fin] - dp[fin]).max()) if fin.any() else 0.0
    groups = 0
    for r in np.nonzero((lk != lp).any(axis=1))[0]:
        row = dp[r]
        near = np.isclose(row[1:], row[:-1], rtol=RTOL, atol=RTOL)
        starts = np.concatenate([[0], np.nonzero(~near)[0] + 1])
        ends = np.concatenate([starts[1:], [len(row)]])
        for a, b in zip(starts, ends):
            if (lk[r, a:b] == lp[r, a:b]).all():
                continue
            groups += 1
            tail = b == len(row)
            check(tail or sorted(lk[r, a:b]) == sorted(lp[r, a:b]),
                  f"row {r}: labels differ outside a near-tie group")
            check(b - a > 1 or tail,
                  f"row {r}: label differs at an untied position {a}")
        check(len(set(lk[r][lk[r] >= 0])) == int((lk[r] >= 0).sum()),
              f"row {r}: duplicate labels")
    return err, groups


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_card(torch) -> dict:
    nvcc = subprocess.run(
        [_build().nvcc(), "--version"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    return {"phase": "card", "nvidia_smi": smi(),
            "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "python": sys.version.split()[0], "torch": torch.__version__,
            "torch_cuda": torch.version.cuda,
            "nvcc": nvcc[-1] if nvcc else None, "triton": triton_version}


def _build():
    from repro_torch.kernels import _build as b
    return b


def phase_build() -> dict:
    b = _build()
    secs = b.build_all()
    ptxas = {n: [ln.strip() for ln in b.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in b.KERNELS}
    return {"phase": "build", "seconds": secs, "kernels": list(b.KERNELS),
            "arch": b.ARCH, "ptxas": ptxas}


def synthetic_pool(torch, rng, n_slabs, c, d, dead_frac):
    """Random slab planes with dead slots (bit 31 of a word included)."""
    data = rng.normal(size=(n_slabs, c, d)).astype(np.float32)
    data[1, 1] = data[1, 0]               # exact duplicates: forced ties
    data[2, 5] = data[1, 0]
    ids = rng.permutation(n_slabs * c).astype(np.int32).reshape(n_slabs, c)
    live = rng.random((n_slabs, c)) >= dead_frac
    live[3, :] = False                    # one empty slab
    live[1, :] = True                     # bit 31 of every word set
    live[4, :] = False
    live[4, 27:32] = True                 # 5 live slots: fewer than k
    words = np.packbits(live.reshape(n_slabs, c // 32, 32)[..., ::-1],
                        axis=-1).view(">u4")[..., 0].astype(np.uint32)
    norms = (data.astype(np.float32) ** 2).sum(-1)
    dev = "cuda"
    return (torch.from_numpy(data).to(dev), torch.from_numpy(ids).to(dev),
            torch.from_numpy(norms).to(dev),
            torch.from_numpy(words.view(np.int32)).to(dev))


def phase_kernel_checks(torch) -> dict:
    """sivf_fused_search vs its plain version on small synthetic cases,
    and a small op sequence (reclaim-heavy delete included) on the card
    against the same sequence on the CPU's plain versions."""
    from repro_torch.kernels.sivf_scan.fused import sivf_fused_search_cuda
    from repro_torch.kernels.sivf_scan.ref import sivf_fused_search_ref
    rng = np.random.default_rng(1234)
    cases, max_err, groups = [], 0.0, 0
    for metric in ("l2", "ip"):
        for c in (32, 128):
            for d, k, q, t in ((128, 10, 33, 12), (37, 64, 8, 5)):
                data, ids, norms, bitmap = synthetic_pool(
                    torch, rng, 24, c, d, dead_frac=0.3)
                table = np.stack([rng.permutation(24)[:t] for _ in
                                  range(q)]).astype(np.int32)
                table[rng.random((q, t)) < 0.3] = -1  # -1 pads
                table[0] = -1                        # an empty row
                table[1, :3] = (1, 2, 3)             # ties + empty slab
                table[2] = -1
                table[2, -1] = 4                     # fewer live than k
                qs = rng.normal(size=(q, d)).astype(np.float32)
                qs[1] = data[1, 0].cpu().numpy() + 0.5 * rng.normal(
                    size=d).astype(np.float32)       # near the tied rows
                args = (torch.from_numpy(qs).cuda(),
                        torch.from_numpy(table).cuda(), data, ids, norms,
                        bitmap, k)
                dk, lk = sivf_fused_search_cuda(*args, metric=metric)
                torch.cuda.synchronize()
                dp, lp = sivf_fused_search_ref(*args, metric=metric)
                err, g = compare_topk(dk, lk, dp, lp)
                check(bool((lk[0] == -1).all()), "empty row not all -1")
                max_err, groups = max(max_err, err), groups + g
                cases.append(f"{metric}/C={c}/D={d}/k={k}")
    return {"phase": "kernel_checks", "sivf_fused_search_cases": cases,
            "max_abs_err": max_err, "near_tie_groups": groups,
            "slice_card_vs_cpu": slice_small_check(torch, rng)}


def slice_small_check(torch, rng) -> dict:
    """The same small op sequence on the card and on the CPU: inserts with
    overwrites, in-batch duplicates and bad ids, a delete that empties
    whole chains (adjacent slabs of one list), then a search. Every plane
    must be equal (``norms`` allclose: reduction order), and the card's
    search must agree with the CPU's plain version."""
    import sivf_torch
    from repro_torch.core import index as ix
    from repro_torch.core.quantizer import assign
    from repro_torch.interop import state_to_numpy
    cfg = sivf_torch.SIVFConfig(dim=16, n_lists=8, n_slabs=256,
                                capacity=32, n_max=8192, max_chain=128)
    cents = rng.normal(size=(8, 16)).astype(np.float32)
    vecs = torch.from_numpy(rng.normal(size=(4000, 16)).astype(np.float32))
    lists = assign(torch.from_numpy(cents), vecs)       # routed once, on CPU
    ids = torch.arange(4000, dtype=torch.int32)
    ids[3990:] = torch.tensor([5, 5, -1, 9000, -3, 7, 7, 7, 1, 2])
    dels = torch.nonzero(lists < 3).reshape(-1).to(torch.int32)
    dels = torch.cat([dels, dels[:50], torch.arange(4000, 4100,
                                                    dtype=torch.int32)])
    qs = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        st = sivf_torch.init_state(cfg, cents, device=dev)
        st = ix.insert(cfg, st, vecs.to(dev), ids.to(dev), lists.to(dev))
        st = ix.insert(cfg, st, vecs[:500].to(dev) + 1, ids[:500].to(dev),
                       lists[:500].to(dev))                   # overwrites
        free0 = int(st.free_top)
        st = ix.delete(cfg, st, dels.to(dev))
        d, lab = ix.search(cfg, st, qs.to(dev), 10, 3)
        out[dev] = (state_to_numpy(st), free0, d, lab)
    torch.cuda.synchronize()
    (a, free0, dp, lp), (b, _, dk, lk) = out["cpu"], out["cuda"]
    for name in a:
        same = np.allclose(a[name], b[name], rtol=1e-6) if name == "norms" \
            else np.array_equal(a[name], b[name])
        check(same, f"card vs CPU: plane {name}")
    check(int(a["error"]) == 2, "bad ids should set ERR_ID_RANGE only")
    reclaimed = int(a["free_top"]) - free0
    check(reclaimed > 0, "the small delete reclaimed no slab")
    err, groups = compare_topk(dk, lk, dp, lp)
    return {"slabs_reclaimed": reclaimed, "planes_equal": True,
            "search_max_abs_err": err, "near_tie_groups": groups}


def make_data(torch, seed: int, n: int):
    """Gaussian mixture, 128 wide: 2048 centres, unit noise (numpy)."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=3.0, size=(2048, DIM)).astype(np.float32)
    which = rng.integers(0, len(centres), n + N_QUERIES)
    x = centres[which] + rng.normal(size=(n + N_QUERIES, DIM)).astype(
        np.float32)
    return torch.from_numpy(x[:n]).cuda(), torch.from_numpy(x[n:]).cuda(), rng


def phase_main(torch, seed: int, out: dict) -> list[dict]:
    """Drive sivf_torch.Index(device="cuda") through the main path."""
    import sivf_torch
    from repro_torch.kernels.reclaim import reclaim
    from repro_torch.kernels.sivf_scan import fused
    lines = []
    t0 = time.perf_counter()
    base, queries, rng = make_data(torch, seed, N_BASE)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sample = base[torch.randperm(N_BASE, generator=gen, device="cuda")
                  [:TRAIN_ROWS]]
    cents = sivf_torch.train_kmeans(sample, N_LISTS, generator=gen)
    torch.cuda.synchronize()
    lines.append({"phase": "setup", "seconds": time.perf_counter() - t0,
                  "n_base": N_BASE, "train_rows": TRAIN_ROWS})
    cfg = sivf_torch.SIVFConfig(**CFG)
    index = sivf_torch.Index(cfg, cents, device="cuda")

    fused.launches = reclaim.launches = 0         # counts of the main path
    ids = torch.arange(N_BASE, dtype=torch.int32, device="cuda")

    def timed(fn):
        """(result, ms between CUDA events around ``fn()``)."""
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        r = fn()
        end.record()
        torch.cuda.synchronize()
        return r, start.elapsed_time(end)

    reps, ms = [], 0.0
    for lo in range(0, N_BASE, INGEST_BATCH):
        r, dt = timed(lambda: index.add(base[lo:lo + INGEST_BATCH],
                                        ids[lo:lo + INGEST_BATCH]))
        reps.append(r)
        ms += dt
    accepted = sum(r.accepted for r in reps)
    check(accepted == N_BASE and all(r.ok for r in reps),
          f"ingest accepted {accepted}")
    lines.append({"phase": "ingest", "ms": ms, "batches": len(reps),
                  "accepted": accepted, "rows_per_s": N_BASE / ms * 1e3})

    ow_ids = torch.from_numpy(rng.choice(N_BASE, OVERWRITE_ROWS,
                                         replace=False).astype(np.int32))
    ow_vecs = base[ow_ids.cuda().long()] + 0.01
    r, dt = timed(lambda: index.add(ow_vecs, ow_ids.cuda()))
    check(r.ok and r.overwritten == OVERWRITE_ROWS and r.accepted == 0,
          f"overwrite report {r}")
    lines.append({"phase": "overwrite", "ms": dt, "overwritten":
                  r.overwritten, "accepted": r.accepted})

    rm_ids = torch.from_numpy(rng.choice(N_BASE, REMOVE_ROWS,
                                         replace=False).astype(np.int32))
    removed, ms, buckets = 0, 0.0, []
    for lo in range(0, REMOVE_ROWS, REMOVE_BATCH):
        r, dt = timed(lambda: index.remove(
            rm_ids[lo:lo + REMOVE_BATCH].cuda()))
        check(r.ok, f"remove report {r}")
        removed += r.accepted
        ms += dt
        buckets.append(r.padded_to)
    check(removed == REMOVE_ROWS, f"remove accepted {removed}")
    lines.append({"phase": "remove", "ms": ms, "accepted": removed,
                  "buckets": buckets, "n_live": index.n_live})

    n_search, lat = 6, []
    for _ in range(n_search):
        res, dt = timed(lambda: index.search(queries, k=K, nprobe=NPROBE))
        lat.append(dt)
    launches = {"sivf_fused_search": fused.launches,
                "reclaim": reclaim.launches}
    check(launches["sivf_fused_search"] == n_search,
          f"fused launches {launches['sivf_fused_search']} != {n_search}")
    check(launches["reclaim"] > 0, "reclaim kernel never launched")
    out["launches"] = launches
    lines.append({"phase": "search", "queries": N_QUERIES, "k": K,
                  "nprobe": NPROBE, "searches": n_search,
                  "ms_each": lat, "ms_median": float(np.median(lat)),
                  "qps": N_QUERIES / float(np.median(lat)) * 1e3,
                  "launches": launches})
    lines.append(check_results(torch, index, base, queries, rm_ids, res))
    out.update(index=index, base=base, queries=queries, cfg=cfg)
    return lines


def check_results(torch, index, base, queries, rm_ids, res) -> dict:
    """Search output: shape, finite, live labels, distances that match the
    stored vectors, and recall@10 against exact search (reported)."""
    d, lab = res.distances, res.labels
    check(tuple(d.shape) == (N_QUERIES, K) and lab.dtype == torch.int32,
          "result shape")
    check(bool(torch.isfinite(d).all()) and bool((lab >= 0).all()),
          "every query should have k finite results")
    removed = torch.zeros(N_BASE, dtype=torch.bool, device="cuda")
    removed[rm_ids.cuda().long()] = True
    check(not bool(removed[lab.long()].any()), "a removed id was returned")
    st = index.state
    slab, slot = st.att_slab[lab.long()].long(), st.att_slot[lab.long()].long()
    x = st.data[slab, slot].double()
    exact = ((x - queries.double()[:, None]) ** 2).sum(-1)
    check(bool(torch.allclose(d.double(), exact, rtol=1e-4, atol=1e-3)),
          "result distances do not match the stored vectors")
    live = ~removed
    live_ids = torch.nonzero(live).reshape(-1)
    # exact top-k over the live base set (stored vectors of live ids)
    lslab = st.att_slab[live_ids].long()
    lslot = st.att_slot[live_ids].long()
    xs = st.data[lslab, lslot]
    best = []
    for q0 in range(0, N_QUERIES, 128):
        dd = torch.cdist(queries[q0:q0 + 128].double(), xs.double())
        best.append(live_ids[dd.topk(K, largest=False).indices])
    best = torch.cat(best)
    hit = (lab.long()[:, :, None] == best[:, None, :]).any(-1).sum()
    return {"phase": "results", "finite": True, "labels_live": True,
            "dists_match_stored": True,
            "recall_at_10_vs_exact": float(hit) / (N_QUERIES * K)}


RECLAIM_PLANES = ("slabs", "count", "heads", "nxt", "prv", "owner", "cursor",
                  "free_stack", "free_top", "tables", "table_len",
                  "table_pos")


def reclaim_bytes(reclaim_ref, ops) -> int:
    """Bytes a reclaim must move: each distinct int32 word it reads or
    writes, once. ``ops`` are CPU planes in the kernel's argument order;
    the plain loop is replayed one slab at a time on copies of them, and
    the words each slab touches are read off the planes before its step."""
    import torch
    p = dict(zip(RECLAIM_PLANES, (t.clone() for t in ops)))
    words = {("count", 0), ("free_top", 0)}
    one = torch.ones((), dtype=torch.int32)
    for i in range(int(p["count"])):
        si = int(p["slabs"][i])
        li, prv, nxt = int(p["owner"][si]), int(p["prv"][si]), int(p["nxt"][si])
        pos = max(int(p["table_pos"][si]), 0)
        last = max(int(p["table_len"][li]) - 1, 0)
        moved = int(p["tables"][li, last])
        words |= {("slabs", i), ("owner", si), ("prv", si), ("nxt", si),
                  ("cursor", si), ("table_pos", si), ("table_len", li),
                  ("tables", (li, last)), ("tables", (li, pos)),
                  ("free_stack", int(p["free_top"]))}
        words.add(("heads", li) if prv < 0 else ("nxt", prv))
        if nxt >= 0:
            words.add(("prv", nxt))
        if moved >= 0:
            words.add(("table_pos", moved))
        reclaim_ref(p["slabs"][i:i + 1], one,
                    *(p[n] for n in RECLAIM_PLANES[2:]))
    return 4 * len(words)


def phase_full_size(torch, hbm: float, main: dict) -> tuple[list, dict]:
    """Kernel vs plain at the main path's shapes, with times and bounds."""
    from repro_torch.core import index as ix
    from repro_torch.core import quantizer
    from repro_torch.kernels.reclaim import ops as reclaim_ops
    from repro_torch.kernels.reclaim.reclaim import reclaim_cuda
    from repro_torch.kernels.reclaim.ref import reclaim_ref
    from repro_torch.kernels.sivf_scan.fused import sivf_fused_search_cuda
    from repro_torch.kernels.sivf_scan.ref import sivf_fused_search_ref
    index, queries, cfg = main["index"], main["queries"], main["cfg"]
    st = index.state
    lists = quantizer.probe(st.centroids, queries, NPROBE, cfg.metric)
    table = ix.gather_tables(cfg, st, lists)             # [1024, 1024]
    args = (queries, table, st.data, st.ids, st.norms, st.bitmap, K)
    sub = (queries[:64], table[:64].contiguous()) + args[2:]
    dk, lk = sivf_fused_search_cuda(*sub)
    torch.cuda.synchronize()
    dp, lp = sivf_fused_search_ref(*sub)
    err, groups = compare_topk(dk, lk, dp, lp)
    # times at the main path's shape (Q=1024, T=1024), and the search's
    # other steps on the same inputs
    ms = cuda_ms(lambda: sivf_fused_search_cuda(*args), reps=10)
    probe_ms = cuda_ms(lambda: quantizer.probe(st.centroids, queries, NPROBE,
                                               cfg.metric), reps=10)
    gather_ms = cuda_ms(lambda: ix.gather_tables(cfg, st, lists), reps=10)
    plain_ms = cuda_ms(lambda: sivf_fused_search_ref(*args), reps=1)
    # bound: bytes this table needs, each input read once, outputs once.
    # Of a probed slab the function needs its bitmap words, and the row,
    # id and norm of each live slot only; whole-slab and per-entry figures
    # are reported beside it.
    c, d, w = cfg.capacity, cfg.dim, cfg.words
    live_entries = table[table >= 0].long()
    slab_bytes = c * d * 4 + c * 8 + w * 4
    distinct_slabs = torch.unique(live_entries)
    distinct = int(distinct_slabs.numel())
    live_of_distinct = int(st.live[distinct_slabs].sum())
    io = N_QUERIES * d * 4 + table.numel() * 4 + N_QUERIES * K * 8
    bytes_once = live_of_distinct * (d * 4 + 8) + distinct * w * 4 + io
    live_slots = int(st.live[live_entries].sum())
    flops = 2 * live_slots * d
    bound_ms = max(bytes_once / hbm, flops / FP32_PEAK) * 1e3
    whole_slab_ms = (distinct * slab_bytes + io) / hbm * 1e3
    per_entry_ms = (live_entries.numel() * slab_bytes + io) / hbm * 1e3
    fused_row = {"name": "sivf_fused_search", "route": "cuda",
                 "source": "src/repro_torch/csrc/sivf_fused_search.cu",
                 "replaces": "src/repro/kernels/sivf_scan/fused.py:158",
                 "launches": main["launches"]["sivf_fused_search"],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms,
                 "bound_by": "bytes" if bytes_once / hbm >= flops / FP32_PEAK
                 else "operations", "library_ms": None}
    lines = [{"phase": "fused_full_size", "queries_checked": 64,
              "max_abs_err": err, "near_tie_groups": groups,
              "shape": {"Q": N_QUERIES, "T": int(table.shape[1]), "C": c,
                        "D": d, "k": K},
              "live_table_entries": int(live_entries.numel()),
              "distinct_live_slabs": distinct,
              "live_slots_of_distinct_slabs": live_of_distinct,
              "live_slots_scored": live_slots, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_ms_whole_slab_once": whole_slab_ms,
              "bound_ms_whole_slab_each_entry": per_entry_ms,
              "pct_of_bound": bound_ms / ms * 100,
              "search_steps_ms": {"probe": probe_ms,
                                  "gather_tables": gather_ms,
                                  "sivf_fused_search": ms}}]

    # reclaim: a 65,536-id delete that empties whole chains, captured at
    # the kernel boundary so kernel and plain loop get the same inputs
    captured = []

    def capture(*ops):
        captured.append([t.clone() for t in ops])
        reclaim_cuda(*ops)

    owner_of = st.owner[st.att_slab.clamp(min=0).long()]
    live_ids = torch.nonzero((st.att_slab >= 0) & (owner_of < 600))
    dels = live_ids.reshape(-1)[:REMOVE_BATCH].to(torch.int32)
    reclaim_ops.reclaim_cuda = capture
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        index.remove(dels)
        torch.cuda.synchronize()
        del_ms = (time.perf_counter() - t) * 1e3
    finally:
        reclaim_ops.reclaim_cuda = reclaim_cuda
    check(len(captured) == 1, "delete did not reach the reclaim kernel once")
    ops = captured[0]
    count = int(ops[1])
    check(count > 0, "reclaim-heavy delete reclaimed no slab")
    host = [t_.to("cpu", copy=True) for t_ in ops]  # the plain loop's copy
    r_bytes = reclaim_bytes(reclaim_ref, host)
    t = time.perf_counter()
    reclaim_ref(*host)
    plain_ms_r = (time.perf_counter() - t) * 1e3
    runs = [[t_.clone() for t_ in ops] for _ in range(6)]
    torch.cuda.synchronize()
    times = []
    for i, run in enumerate(runs):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        reclaim_cuda(*run)
        e.record()
        torch.cuda.synchronize()
        if i:
            times.append(s.elapsed_time(e))
    r_err = 0
    for name, a, b in zip(RECLAIM_PLANES, runs[0], host):
        a = a.cpu()
        r_err = max(r_err, int((a.long() - b.long()).abs().max()))
        check(torch.equal(a, b), f"reclaim full size: plane {name}")
    r_ms = float(np.median(times))
    reclaim_row = {"name": "reclaim", "route": "cuda",
                   "source": "src/repro_torch/csrc/reclaim.cu",
                   "replaces": "src/repro/core/index.py:361 (fori_loop in "
                               "_delete_impl; no Pallas kernel)",
                   "launches": main["launches"]["reclaim"],
                   "max_abs_err": r_err, "ms": r_ms, "plain_ms": plain_ms_r,
                   "bound_ms": r_bytes / hbm * 1e3, "bound_by": "bytes",
                   "library_ms": None}
    lines.append({"phase": "reclaim_full_size", "delete_ids": REMOVE_BATCH,
                  "slabs_reclaimed": count, "distinct_bytes": r_bytes,
                  "delete_ms": del_ms,
                  "kernel_ms": r_ms, "plain_loop_cpu_ms": plain_ms_r,
                  "planes_equal": True})
    return lines, {"kernels": [fused_row, reclaim_row]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import sivf_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []
    emit(phase_card(torch))
    emit(phase_build())

    def run(name, fn):
        try:
            return fn()
        except Exception:
            failed.append(name)
            emit({"phase": name, "ok": False,
                  "error": traceback.format_exc()[-3000:]})
            return None

    res = run("kernel_checks", lambda: phase_kernel_checks(torch))
    if res:
        emit(res)
    main_out: dict = {}
    lines = run("main_path", lambda: phase_main(torch, args.seed, main_out))
    for ln in lines or []:
        emit(ln)
    summary = None
    if lines:
        hbm = hbm_bytes_per_s(torch.cuda.get_device_name(0))
        got = run("full_size", lambda: phase_full_size(torch, hbm, main_out))
        if got:
            for ln in got[0]:
                emit(ln)
            summary = got[1]
    if summary:
        emit(summary)
    print(smi(), flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    raise SystemExit(main())
