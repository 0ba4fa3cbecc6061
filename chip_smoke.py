#!/usr/bin/env python3
"""Smoke run of the PyTorch port of SIVF on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
for ``sm_90a``, holds each kernel against its plain PyTorch version on the
card, then drives two main paths through ``sivf_torch.Index(device="cuda")``
at the shape of the SIFT1M benchmark (ann-benchmarks ``sift-128-euclidean``:
1,000,000 base vectors, dim 128, L2, k=10), both with the filter
attributes ``tenant`` (uniform over 100) and ``ts`` (uniform over 1000):

  * the raw fp32 index with Faiss's ``IVF4096,Flat`` list count;
  * the PQ index with Faiss's ``IVF4096,PQ32`` layout (32 one-byte codes of
    4 dims each, nbits=8), trained on a 65,536-row sample, whose searches
    take the PQ kernel's ``compacted`` route (each query's live table
    entries compacted, windows of candidates screened, the listed slots
    scored 32 dense lanes a step); both of its routes are held against its
    plain version on edge sets and at full size, the default on all
    queries.

Each path ingests, overwrites, removes, runs unfiltered searches and one
filtered search at each of three selectivities (about 1 %, 10 % and 50 %),
and is read against the exact top-10 over the live set (within each
predicate for the filtered searches). The raw path's searches take the
fused kernel's ``grouped`` route (each probed slab read once for all the
queries that probe it); both of its routes are held against its plain
version on edge sets and at full size, and one wrapper call is shown to
read no device value on the host. On the raw path's index a third
path, the unfused search (probe, ``gather_tables``, ``ops.sivf_scan``
writing the whole ``[Q, T*C]`` candidate matrix on its ``grouped`` route,
``ops.topk`` on its ``warp`` route), is held bit for bit against the
fused kernel and ``Index.search`` and each kernel against its plain
version on all queries, and swept against the fused kernel in time and
peak device memory over the batch size. The data
is a synthetic 128-wide Gaussian mixture made from ``--seed`` with numpy;
no dataset file is read.

On the raw path's index, after those phases, its lifecycle runs: the
``persist`` phase saves it (checkpoint format 3, under ``build/``),
loads it back on the card and holds every plane (digests) and six search
batches ``==``; the ``tiered`` phase loads the same checkpoint with
``device_slabs=8192`` (half the pool in cache frames, the payloads in
pinned host memory) and holds Q = 64 batches at nprobe 32, cold and then
warm, ``==`` the all-resident index, warm ones making no host-to-device
copy, through an overwrite and a remove applied to both and under a
filter, and runs one Q = 1024 batch over every live slab (``==``, or the
``device_slabs`` ``ValueError`` when they outnumber the frames); every
kernel-1 launch of the tiered index must take ``grouped``. The
``maintain`` phase applies three policy sweeps of ``Index.maintain`` and
an explicit split, merge and recluster to both indexes, and after each
op holds the live set (ids, payloads, attributes), the metadata planes
and the searches ``==``. The PQ path's ``pq_lifecycle`` saves and loads
its index the same way and runs one tiered batch on kernel 2's
``compacted`` route.

On the raw path's index, before its lifecycle, the sharded index runs on
``sivf_torch.ShardMesh.virtual(4, "cuda")``: four virtual shards on the
one card, each with the raw path's whole pool (``core/distributed.py``).
``mesh.main`` replays the path's traffic through
``Index(backend=mesh)`` and holds its live-row table ``==`` the single
index's, its searches ``==`` the single path's (distances bit for bit,
labels but inside groups of equal distances), its unfiltered and 10 %
filtered searches ``==`` the plain mesh version on the same card planes
(each shard's plain search, then ``topk_ref``), its recall@10 equal, its
launches (kernel 1 once a shard a batch, kernel 4 once a batch as the
cross-shard merge) and the host syncs of an add against the single
index's. ``mesh.lifecycle`` saves the 4-shard handle, loads it onto 4
shards (planes ``==``), reshards the live handle 4 -> 2 -> 3 -> 1
(tables and searches ``==``) with the checkpoint loaded onto 2 and onto
``"single"`` beside those steps (planes ``==`` the reshard's), runs a
split and a merge beside the single twin (tables and every shard's
centroids ``==``) and forces an abort on one shard of a small config
(every shard reverted, ``shard_errors`` naming it); ``mesh.tiered``
loads the checkpoint tiered (8,192 frames a shard) and holds Q = 64
batches, cold then warm, ``==`` the all-resident 4-shard handle;
``mesh.serve`` coalesces searches over the loaded 4-shard handle (tiles
``==`` direct searches ``==`` the plain mesh version). The PQ path's ``mesh.pq``
trains on four virtual shards (codebooks ``==`` the single index's) and
holds table and searches to the single path's the same way.

Then ``sivf_torch.ServeEngine`` serves the raw checkpoint (one scheduler
thread in front of a ``deferred=True`` index): ``serve.coalesce`` holds
every result of searches queued while the engine is paused, then
coalesced into tiles, ``==`` its rows of one direct ``Index.search`` of
its tile; ``serve.prefix`` streams 32 adds of 4,096 planted ids and 32
removes of 4,096 old ids while a reader searches planted vectors, and
holds every result to the prefix of mutations its epoch names;
``serve.load`` reads open-loop single-query latency at 1,000, 4,000 and
16,000 searches a second, idle and beside an ingest of 50,000 rows a
second each way (a reading, not a gate); ``serve.tiered`` runs a tiered
engine with 2,048 frames beside an all-resident one, tiles evicting each
other's frames, every result ``==``; ``serve.telemetry`` holds the
Prometheus text to the snapshot and the cache-event counters to
``stats()``. The PQ path ends with a coalescing burst on its checkpoint
(kernel 2 and 2f on ``compacted``).

Once the index paths are freed, the ``lm`` phase serves Llama-3-8B at
full width (32 layers, bf16, random weights from ``init_params`` seeded
with ``--seed``) through ``repro_torch.serve.paged_lm.PagedLMEngine``: a
page pool of 1024 pages of 16 slots, eight sequence slots; four prompts
of 2048, 1000, 517 and 129 tokens, 64 lockstep decode steps, a window
slide, an eviction, a fifth prompt of 300 tokens onto the freed pages,
16 more steps, every step fed teacher-forced tokens. Prefill runs the
flash kernel's tensor-core route (wgmma, P carried to ``P V`` as two
bf16 terms; every flash launch of the path must take it) and decode the
paged kernel's split over the window; both are held against their plain
versions on the path's own inputs, and the whole traffic is run again
with ``attn_impl="ref"`` and held to the same page state and to the
logits tolerance ``LM_LOGIT_RTOL``.

Then the ``rwkv`` phase serves RWKV6-3B whole (32 layers, bf16) and the
``hybrid`` phase Jamba-v0.1-52B at full width cut to one 8-layer period
(attention, Mamba and MoE layers; the whole model is 103 GB in bf16),
each through the same engine and traffic, with random weights from
``--seed``: the recurrence kernel (``wkv6``, ``mamba_scan``) is held
against its plain version on edge sets and on the path's own inputs,
each sequence slot to its own limit, where a decode step started from a
zeroed state must be refused; and the traffic is run again in float32 on
a kernel engine beside an ``attn_impl="ref"`` engine, held to the same
page state and to ``RNN_F32_RTOL`` on the logits and recurrent states of
the active slots after every operation, with a rounding-level control
engine reported beside it. For ``wkv6`` the kernel and its plain version
are also held against a float64 evaluation of the recurrence on the
path's step-0 and re-admit-step inputs, active and idle slots apart.

Between the index paths and the LM phases, the ``baselines`` phase runs
the paper's comparison engines (``repro_torch.baselines``) at the raw
path's shape beside a SIVF index of the raw configuration (no attributes,
no overwrite, which the baselines do not track): ``FlatIndex(128,
2,097,152)``, ``ContiguousIVF`` on the raw path's 4,096 centroids with
``list_cap`` 488 (2 N / lists, as ``benchmarks/paper.py`` sizes it) and
``LSHIndex`` (4 tables of 256 buckets of 8,192 rows) each ingest the 1M
rows in 16,384-row batches, remove 1,024 ids (the paper's Fig. 1a unit)
and then 100,000 in 65,536-id buckets, and run six Q=1024 searches (k=10,
ContiguousIVF and SIVF at nprobe 32); ``HNSWLite`` (m 8, ef 24) takes
800 rows and a 100-id delete that rebuilds the graph on the host. Flat
is held to the exact top-10 over the live set and ContiguousIVF to the
exact top-10 within the lists it and SIVF probe (labels ``==`` outside
ties, distances allclose 1e-5) and to SIVF's recall@10, HNSW's live
count to 700, and kernel 4's launches to the chunks the searches cut
(every Flat, ContiguousIVF and LSH search takes its k smallest through
it).

After the ``hybrid`` phase, the ``arch.*`` phases serve Qwen3-14B,
Phi-3-medium-14B, Granite-MoE-3B-A800M, MiniCPM3-4B (MLA: absorbed
latent pages, kernel 5 at one KV head of keys 288 and values 256 for 40
query heads, scale 96 ** -0.5; its prefill through kernel 6 at dh 96 with
V zero-padded from 64), Moonlight-16B-A3B (top-6 of 64 experts plus 2
shared) and LLaVA-NeXT-34B (its first admit with 576 image-patch
embeddings from ``--seed``) at full width, uncut (bf16, random weights
from ``--seed``) through the same engine on shorter traffic (admit 2,048
and 517 tokens, 16 decode steps): flash launches all on ``tensor_core``
and paged ones as counted, the first and last layer's calls held to the
plain versions at full width with their planted controls refused, each
kernel's layer-0 call timed (``kernel_times``), the traffic again through
``attn_impl="ref"`` (taking the first run's experts) held to page state
``==`` and ``LM_LOGIT_RTOL``, then the kernel run a second time, whose
logits must be ``==`` the first (the MoE combine adds in a fixed
order).

Inside the ``lm``, ``rwkv``, ``hybrid`` and ``arch.minicpm3-4b`` phases,
on the weights they already hold (RWKV6's and Jamba's float32 ones of
their ``vs_ref`` runs), one sequence of 32 prompt tokens and 16 fed ones
goes through ``PagedLMEngine`` and through the dense-cache
``init_decode_cache`` + ``decode_step`` from position 0 (kernel 5 over
each layer's cache read as one page a sequence, kernels 8 and 7 at T = 1;
counted), the dense logits held to the engine's (``*.dense_decode``;
within ``LM_LOGIT_RTOL`` in bf16, ``RNN_F32_RTOL`` in float32; an MoE
model's dense decode takes the engine's experts), a shifted control
refused. Then the ``whisper`` phase serves Whisper-base uncut in bf16
(random weights and ``N(0, 1)`` frames from ``--seed``): 4 sequences of
1,500 frames encoded, a decoder forward of 448 tokens over the encoding,
64 positions decoded token by token with the cross caches filled from
``cross_kv``; kernel 6 in the encoder (non-causal, 1,500 x 1,500), the
decoder's self-attention (causal) and its cross-attention (non-causal,
448 x 1,500), kernel 5 over the 448-slot self caches and the 1,500-slot
cross caches, each counted, held to its plain version on the path's
inputs with its control, and timed; ``impl="ref"``, the decoded
positions against the forward, and a second run ``==`` the first are
held, each with a control. Last the ``train`` phase runs the trainer's
``launch.train.main`` on the card (float32 master weights, bf16
activations, no kernel): Whisper-base uncut (4 x 448 tokens, 4 steps on
a repeated batch, then a run stopped after 2 steps and resumed from its
checkpoint, and two microbatches' gradient against one batch's) and
Llama-3-8B cut to 8 layers (2 x 1,024 tokens, 3 steps).

Then the model-axis plan runs on virtual model meshes of the one card
(``launch.mesh.ModelMesh.virtual``), one ``phase_model_axis`` a cell of
``MODEL_AXIS_CELLS``: Granite-MoE-3B on (data 1, model 16) and (data 2,
model 8), Phi-3-medium-14B and RWKV6-3B on (data 1, model 16), Jamba
cut to one 8-layer period on (data 2, model 8) and Whisper-base on (data
1, model 16) (its 1,500 frames a sequence), at full width in bf16 with
weights padded by ``make_plan`` (random, from ``--seed``), each through
the ``arch.*`` traffic one sequence at a time (prefill with
``forward(mesh=)``, the caches into the mesh's decode cache, steps of
``decode_step(mesh=)``): kernels 6, 8 and 7 launched per shard, kernel 5
per shard where KV heads shard (else the ``head_dim`` decode, plain
torch), the first and last layer's calls at the first and last shard
held to the plain versions with their controls; the logits held to the
unsharded padded model's within ``LM_LOGIT_RTOL`` (with the mesh's
per-shard MoE dispatch where the prefill takes the shard map), beside
the plain ``apply_moe``'s drops and choices; RWKV6's and Jamba's bf16
logits within ``AXIS_WITNESS_FACTOR`` of the unsharded model's own gap
to its plain versions, and in float32 within ``RNN_F32_RTOL``; prefill
and step ms sharded, unsharded padded and unpadded (views of the padded
weights). Last, Granite's two ZeRO-1 train steps on (data 2, model 8)
(float32 master weights, no kernel), with the moments' bytes per
shard.

The coarse centroids are trained twice from one generator state and the
PQ codebooks twice from one seed: k-means sums in a fixed order, so each
pair must agree bit for bit.

Output: one JSON object per line, in this order: the card and toolchain,
the kernel build, the kernel-vs-plain checks, the workload, the k-means
repeat, each path's
phases and full-size kernel checks and timings (the unfused path's after
the raw path's phases), the mesh's ``mesh.*`` traffic lines, ``mesh.main``,
``mesh.lifecycle``, ``mesh.tiered`` and ``mesh.serve``, the raw path's
``raw.persist``,
``tiered.search``, ``tiered.churn``, ``tiered.full_probe``,
``tiered.launches``, ``maintain``, ``serve.coalesce``, ``serve.prefix``,
``serve.load``, ``serve.tiered`` and ``serve.telemetry`` lines, the PQ
path's ``mesh.pq.*`` lines and ``mesh.pq``, ``pq.persist``, ``pq.tiered`` and
``serve.coalesce``, the ``baselines.*`` lines (``sivf``, ``flat``,
``contiguous_ivf``, ``lsh``, ``hnsw``) and ``baselines``, the ``lm``,
``lm.kernels_full_width`` and ``lm.vs_ref`` lines, the same three for
``rwkv`` and ``hybrid`` (and ``rwkv.wkv6_float64`` before
``rwkv.vs_ref``), each followed by its ``*.dense_decode`` line, the
``arch.*`` lines (``arch.minicpm3-4b.dense_decode`` after MiniCPM3's),
``whisper``, ``train.whisper-base``, ``train.llama3-8b``, the six
``model_axis.<arch>.<data>x<model>`` lines and
``model_axis.train.granite-moe-3b-a800m``, the ``{"kernels": [...]}``
summary, the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check makes the exit code 1
and suppresses the last line. Without a GPU it exits 2 and prints no
result. It imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# SIFT1M shape (ann-benchmarks sift-128-euclidean) with Faiss IVF4096,Flat
# and IVF4096,PQ32; two filter attributes as in benchmarks/paper.py
N_BASE, DIM, N_LISTS, K = 1_000_000, 128, 4096, 10
ATTRS = ("tenant", "ts")
N_TENANTS, N_TS = 100, 1000
CFG = dict(dim=DIM, n_lists=N_LISTS, n_slabs=16384, capacity=128,
           n_max=1 << 21, max_chain=32, metric="l2", attributes=ATTRS)
PQ_M, PQ_NBITS = 32, 8
INGEST_BATCH, OVERWRITE_ROWS = 16384, 16384
REMOVE_ROWS, REMOVE_BATCH = 100_000, 65536
N_QUERIES, NPROBE, TRAIN_ROWS = 1024, 32, 65536
N_SEARCH = 6                      # unfiltered search batches per path
CHECK_QUERIES = 64                # full-size queries held against plain
RTOL = 1e-5                       # distance tolerance, card vs CPU state
FP32_LIMIT_SHARE = 0.5            # kernel 1's share of RTOL against float64
FP32_PEAK = 67e12                 # H100 SXM fp32 (non-tensor) FLOP/s
SM_COUNT, BOOST_HZ = 132, 1.98e9  # H100 SXM
LOOKUP_RATE = SM_COUNT * 32 * BOOST_HZ   # 4-byte shared-memory lookups/s
BF16_PEAK = 989e12                # H100 SXM bf16 dense tensor-core FLOP/s
REPRESENTATIVE = "in_10pct"       # filtered selectivity in the kernels line


def filters_of():
    """The three filtered searches of each path, by selectivity."""
    import sivf_torch as s
    return {"eq_1pct": s.Eq("tenant", 7),
            "in_10pct": s.In("tenant", tuple(range(10))),
            "range_50pct": s.Range("ts", 0, 500)}


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


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events),
    after one warm-up run unless ``warm`` is False."""
    import torch
    if warm:
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_median_ms(fn, reps: int) -> float:
    """Median device milliseconds of ``reps`` launches of ``fn()``, each
    between its own pair of CUDA events, after one warm-up launch."""
    import torch
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def cuda_median_ms_cold(fn, reps: int, flush) -> float:
    """As :func:`cuda_median_ms`, with ``flush()`` (outside the events)
    before each launch, so that the launch finds the L2 cache cold."""
    import torch
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def timed(fn):
    """(result, ms between CUDA events around ``fn()``)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    r = fn()
    end.record()
    torch.cuda.synchronize()
    return r, start.elapsed_time(end)


def check_equal(what: str, dk, lk, dp, lp) -> float:
    """A kernel's top-k equals its plain version's on the same inputs:
    distances ``==`` bit for bit and labels ``==``. Returns the largest
    absolute distance difference over finite entries (0.0)."""
    dk, lk, dp, lp = (t.cpu().numpy() for t in (dk, lk, dp, lp))
    check(dk.shape == dp.shape and lk.shape == lp.shape, f"{what}: shape")
    same_d = (dk.view(np.int32) == dp.view(np.int32))
    same = same_d & (lk == lp)
    if not same.all():
        r, j = np.argwhere(~same)[0]
        w = slice(max(j - 8, 0), j + 8)           # the row around the miss
        raise CheckFailed(
            f"{what}: {int((~same).sum())} of {same.size} entries differ; "
            f"first at row {r} pos {j}: kernel {dk[r, j]!r} label "
            f"{lk[r, j]} vs plain {dp[r, j]!r} label {lp[r, j]}; kernel "
            f"row[{w.start}:{w.stop}] {dk[r, w].tolist()} {lk[r, w].tolist()} "
            f"plain {dp[r, w].tolist()} {lp[r, w].tolist()}")
    fin = np.isfinite(dp)
    return float(np.abs(dk[fin] - dp[fin]).max()) if fin.any() else 0.0


def compare_topk(dk, lk, dp, lp) -> tuple[float, int]:
    """Hold a card search against a CPU search of a state built by the same
    ops on the CPU (``norms`` may differ in the last bit: reduction order).

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
            f"{lp[r, j]}")
    fin = np.isfinite(dp)
    err = float(np.abs(dk[fin] - dp[fin]).max()) if fin.any() else 0.0
    near = np.isclose(dp[:, 1:], dp[:, :-1], rtol=RTOL, atol=RTOL)
    return err, labels_outside_ties(lk, lp, near)


def labels_outside_ties(lk, lp, near) -> int:
    """Labels ``lk`` equal ``lp`` position for position, except inside
    tie groups (runs of positions whose ``near [Q, k-1]`` links them to
    the next) where the label sets must agree; a group that reaches the
    k-th position may hold other tied candidates. Returns the groups
    whose labels differ."""
    groups = 0
    for r in np.nonzero((lk != lp).any(axis=1))[0]:
        starts = np.concatenate([[0], np.nonzero(~near[r])[0] + 1])
        ends = np.concatenate([starts[1:], [lk.shape[1]]])
        for a, b in zip(starts, ends):
            if (lk[r, a:b] == lp[r, a:b]).all():
                continue
            groups += 1
            tail = b == lk.shape[1]
            check(tail or sorted(lk[r, a:b]) == sorted(lp[r, a:b]),
                  f"row {r}: labels differ outside a near-tie group")
            check(b - a > 1 or tail,
                  f"row {r}: label differs at an untied position {a}")
        check(len(set(lk[r][lk[r] >= 0])) == int((lk[r] >= 0).sum()),
              f"row {r}: duplicate labels")
    return groups


def compiled(torch, pred):
    """(structure, constants on the card) of a predicate over ATTRS."""
    import sivf_torch
    cf = sivf_torch.compile_filter(pred, ATTRS)
    return cf.structure, torch.tensor(cf.consts, dtype=torch.int32,
                                      device="cuda")


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


def ptxas_usage(log: str) -> list[dict]:
    """Each entry function of an ``nvcc -Xptxas -v`` log: its (mangled)
    name, registers a thread, and spill stores and loads in bytes."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            out.append({"function": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and out:
            out[-1].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def phase_build() -> dict:
    """Build every kernel; count the flash library's tensor-core
    instructions in its SASS (``cuobjdump -sass``: ``HGMMA`` is wgmma) and
    keep its ``-Xptxas -v`` spill lines, one per kernel instance; report
    the recurrence kernels', the two fused searches' and the unfused
    pair's registers and spills per instance (the wkv6 instances for
    dk = 128, prefill and decode, and every instance of the raw scans,
    sivf_fused_search and sivf_scan, must spill nothing)."""
    b = _build()
    secs = b.build_all()
    ptxas = {n: [ln.strip() for ln in b.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
             for n in b.KERNELS}
    rec_usage = {n: ptxas_usage(b.build_log(n))
                 for n in ("wkv6", "mamba_scan")}
    fused_usage = ptxas_usage(b.build_log("sivf_fused_search"))
    pq_usage = ptxas_usage(b.build_log("sivf_pq_fused_search"))
    unfused_usage = {n: ptxas_usage(b.build_log(n))
                     for n in ("sivf_scan", "topk")}
    dk128 = [f for f in rec_usage["wkv6"]
             if "wkv6_kernelILi128E" in f["function"]]
    check(len(dk128) == 2 and all(
        f.get("spill_stores") == 0 and f.get("spill_loads") == 0
        for f in dk128), f"the wkv6 dk=128 instances spill: {dk128}")
    raw_scans = fused_usage + unfused_usage["sivf_scan"]
    check(raw_scans and all(f.get("spill_stores") == 0
                            and f.get("spill_loads") == 0
                            for f in raw_scans),
          f"an instance of sivf_fused_search or sivf_scan spills: "
          f"{raw_scans}")
    cuobjdump = str(Path(b.nvcc()).parent / "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(b.library_path("flash_attention"))],
        capture_output=True, text=True, timeout=120).stdout.splitlines()
    flash = {"hgmma": sum("HGMMA" in ln for ln in sass),
             "hmma": sum("HMMA" in ln for ln in sass),
             "spills": [ln.strip() for ln in
                        b.build_log("flash_attention").splitlines()
                        if "spill" in ln],
             "ptxas_warnings": [ln.strip()[:160] for ln in
                                b.build_log("flash_attention").splitlines()
                                if "Performance" in ln or "ignored" in ln]}
    check(flash["hgmma"] > 0, "libflash_attention has no HGMMA instruction")
    return {"phase": "build", "seconds": secs, "kernels": list(b.KERNELS),
            "arch": b.ARCH, "ptxas": ptxas, "flash_attention_sass": flash,
            "recurrence_registers_and_spills": rec_usage,
            "fused_search_registers_and_spills": fused_usage,
            "pq_fused_search_registers_and_spills": pq_usage,
            "unfused_registers_and_spills": unfused_usage}


def synthetic_pool(torch, rng, n_slabs, c, d, dead_frac, m=0, ksub=256):
    """Random slab planes with dead slots (bit 31 of a word included),
    attributes (tenant in [0, 5), ts in [0, 100)) and, with ``m``, PQ
    codes. Rows 1/0, 1/1 and 2/5 are exact duplicates: forced ties."""
    data = rng.normal(size=(n_slabs, c, d)).astype(np.float32)
    data[1, 1] = data[1, 0]
    data[2, 5] = data[1, 0]
    codes = rng.integers(0, ksub, (n_slabs, c, m)).astype(np.uint8)
    codes[1, 1] = codes[1, 0]
    codes[2, 5] = codes[1, 0]
    ids = rng.permutation(n_slabs * c).astype(np.int32).reshape(n_slabs, c)
    live = rng.random((n_slabs, c)) >= dead_frac
    live[3, :] = False                    # one empty slab
    live[1, :] = True                     # bit 31 of every word set
    live[4, :] = False
    live[4, 27:32] = True                 # 5 live slots: fewer than k
    words = np.packbits(live.reshape(n_slabs, c // 32, 32)[..., ::-1],
                        axis=-1).view(">u4")[..., 0].astype(np.uint32)
    norms = (data.astype(np.float32) ** 2).sum(-1)
    attrs = np.stack([rng.integers(0, 5, (n_slabs, c)),
                      rng.integers(0, 100, (n_slabs, c))], -1)
    dev = "cuda"
    t = {"data": data, "ids": ids, "norms": norms,
         "bitmap": words.view(np.int32), "codes": codes,
         "attrs": attrs.astype(np.int32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in t.items()}


def synthetic_table(rng, n_slabs, q, t):
    """A [q, t] slab table with -1 pads, an empty row (0), tied rows and
    the empty slab (1), and a row with fewer live slots than k (2)."""
    table = np.stack([rng.permutation(n_slabs)[:t] for _ in
                      range(q)]).astype(np.int32)
    table[rng.random((q, t)) < 0.3] = -1
    table[0] = -1
    table[1, :3] = (1, 2, 3)
    table[2] = -1
    table[2, -1] = 4
    return table


def edge_filters():
    """Predicates over the synthetic attributes, with the k each uses."""
    import sivf_torch as s
    return {"eq": (s.Eq("tenant", 2), 10),
            "in": (s.In("tenant", (0, 3)), 10),
            "range": (s.Range("ts", 20, 70), 10),
            "nested_and": (s.And(s.In("tenant", (1, 2, 4)),
                                 s.And(s.Range("ts", 10, 90),
                                       s.Eq("tenant", 1))), 10),
            "none_pass": (s.Eq("tenant", 99), 10),
            "k_over_passing": (s.And(s.Eq("tenant", 1),
                                     s.Range("ts", 0, 10)), 64)}


def fused_edge_table(rng, n_slabs, q, t):
    """``synthetic_table`` plus kernel 1's order cases: row 3 holds slab 2
    at t = 0 and slab 1 at t = 1 (their tied rows: the higher slab id at
    the lower t), row 4 the same slab twice, and column t - 1 one slab
    probed by every query but the empty row 0 and row 2."""
    table = synthetic_table(rng, n_slabs, q, t)
    table[3, :2] = (2, 1)
    table[4, :3] = (5, 7, 5)
    keep = table[[0, 2], -1].copy()
    table[:, -1] = 6
    table[[0, 2], -1] = keep
    return table


def fused_edge_filters():
    """``edge_filters`` plus about 1 % and 50 % of the synthetic ``ts``."""
    import sivf_torch as s
    return {**edge_filters(), "pct1": (s.Range("ts", 0, 1), 10),
            "pct50": (s.Range("ts", 0, 50), 10)}


def fused_edge_checks(torch, rng) -> tuple[list, float]:
    """Kernel 1 vs its plain version (``==`` distances and labels) on the
    ``grouped`` route wherever k < C and on ``per_query`` everywhere: L2
    and IP, C = 32, 128, 1024, D = 128 and 37, k = 10 and 64 (k >= C at
    C = 32); at C = 128 and 1024 also D = 256 (query columns staged twice),
    300 (a partial last stage) and 301 (4-byte loads); ``-1`` pads, an
    all-pad row, a row with fewer live slots than k, exact ties in one
    slab and across slabs with the higher slab id at the lower t, the same
    slab twice in a row, one slab probed by every query, a zero query
    (IP: every distance -0.0); filtered at C = D = 128 by the edge
    predicates and at about 1 % and 50 %."""
    from repro_torch.kernels.sivf_scan import fused
    from repro_torch.kernels.sivf_scan.ref import sivf_fused_search_ref
    cases, max_err = [], 0.0

    def both_routes(name, args, kw):
        nonlocal max_err
        dp, lp = sivf_fused_search_ref(*args, **kw)
        k, c = args[6], args[2].shape[1]
        for route in ("grouped", "per_query") if k < c else ("per_query",):
            dk, lk = fused.search_route(route, *args, **kw)
            torch.cuda.synchronize()
            max_err = max(max_err, check_equal(f"{name}/{route}", dk, lk,
                                               dp, lp))
            check(bool((lk[0] == -1).all()), f"{name}: empty row not all -1")
            cases.append(f"{name}/{route}")

    def case(metric, c, d, k, q, t, rng):
        check(fused.route(q, t, c, k) == ("grouped" if k < c else
                                          "per_query"), "route of the shapes")
        p = synthetic_pool(torch, rng, 24, c, d, dead_frac=0.3)
        table = fused_edge_table(rng, 24, q, t)
        qs = rng.normal(size=(q, d)).astype(np.float32)
        near = p["data"][1, 0].cpu().numpy()
        qs[1] = near + 0.5 * rng.normal(size=d).astype(np.float32)
        qs[3] = near + 0.5 * rng.normal(size=d).astype(np.float32)
        qs[5] = 0.0
        args = (torch.from_numpy(qs).cuda(), torch.from_numpy(table).cuda(),
                p["data"], p["ids"], p["norms"], p["bitmap"], k)
        name = f"{metric}/C={c}/D={d}/k={k}"
        both_routes(name, args, {"metric": metric})
        if c == 128 and d == 128:               # the filtered variant
            for fname, (pred, fk) in fused_edge_filters().items():
                fs, fc = compiled(torch, pred)
                kw = dict(metric=metric, attrs=p["attrs"], fstruct=fs,
                          fconsts=fc)
                both_routes(f"{name}/filter={fname}", args[:-1] + (fk,), kw)

    wide_rng = np.random.default_rng(4321)       # leaves rng's stream as is
    for metric in ("l2", "ip"):
        for c in (32, 128, 1024):
            for d, k, q, t in ((128, 10, 33, 12), (37, 64, 8, 5)):
                case(metric, c, d, k, q, t, rng)
            for d in (256, 300, 301) if c > 32 else ():
                case(metric, c, d, 10, 17, 6, wide_rng)
    return cases, max_err


def phase_kernel_checks(torch) -> dict:
    """Each scan kernel vs its plain version on small synthetic cases
    (``==`` distances and labels), and a small op sequence (reclaim-heavy
    delete included) on the card against the same sequence on the CPU's
    plain versions."""
    from repro_torch.core import pq
    rng = np.random.default_rng(1234)
    out = {"phase": "kernel_checks"}
    cases, max_err = fused_edge_checks(torch, rng)
    out["sivf_fused_search_cases"] = cases
    cases = []
    for metric in ("l2", "ip"):
        for m in (8, 32):
            for nbits in (4, 8):
                for c in (32, 128):
                    ksub = 1 << nbits
                    p = synthetic_pool(torch, rng, 24, c, 4, dead_frac=0.3,
                                       m=m, ksub=ksub)
                    q = 33
                    table = torch.from_numpy(synthetic_table(
                        rng, 24, q, 12)).cuda()
                    cb = torch.from_numpy(rng.normal(
                        size=(m, ksub, 4)).astype(np.float32)).cuda()
                    qs = torch.from_numpy(rng.normal(
                        size=(q, 4 * m)).astype(np.float32)).cuda()
                    adc = pq.adc_tables(cb, qs, metric).contiguous()
                    adc[3, 0] = -0.0          # a -0.0 first term
                    for k in (10, 64):        # 64 > live count of row 2
                        args = (adc, table, p["codes"], p["ids"],
                                p["bitmap"], k)
                        name = f"{metric}/m={m}/nbits={nbits}/C={c}/k={k}"
                        max_err = max(max_err, pq_variants(
                            torch, name, args, {}, cases))
                    if c != 128:              # filtered: every instance
                        continue
                    for fname, (pred, fk) in fused_edge_filters().items():
                        fs, fc = compiled(torch, pred)
                        args = (adc, table, p["codes"], p["ids"],
                                p["bitmap"], fk)
                        kw = dict(attrs=p["attrs"], fstruct=fs, fconsts=fc)
                        fname = f"{metric}/m={m}/nbits={nbits}/C={c}/" \
                                f"filter={fname}"
                        max_err = max(max_err, pq_variants(
                            torch, fname, args, kw, cases))
    max_err = max(max_err, pq_compacted_edge_checks(torch, cases))
    out["sivf_pq_fused_search_cases"] = cases
    out["sivf_scan_cases"], err = scan_edge_checks(torch, rng)
    max_err = max(max_err, err)
    out["topk_cases"], err = topk_edge_checks(torch, rng)
    out["max_abs_err"] = max(max_err, err)
    out["paged_attention_cases"], perr = paged_edge_checks(torch, rng)
    out["flash_attention_cases"], ferr = flash_edge_checks(torch, rng)
    out["attention_max_abs_err"] = {
        dt: max(perr[dt], ferr[dt]) for dt in ("float32", "bfloat16")}
    out["slice_card_vs_cpu"] = slice_small_check(torch, rng)
    return out


def pq_variants(torch, name, args, kw, cases) -> float:
    """Kernel 2 on every route that takes the shapes (``compacted`` where
    :func:`pq_fused.route` picks it; ``per_query``) against its plain
    version, ``==``; a ``-1`` row's labels must stay ``-1``."""
    from repro_torch.kernels.sivf_scan import pq_fused
    from repro_torch.kernels.sivf_scan.ref import sivf_pq_fused_search_ref
    dp, lp = sivf_pq_fused_search_ref(*args, **kw)
    adc, table, k = args[0], args[1], args[5]
    empty = bool((table[0] < 0).all())
    err = 0.0
    routes = ["per_query"]
    if pq_fused.route(*adc.shape[1:], k, table.shape[1]) == "compacted":
        routes.append("compacted")
    for route in routes:
        dk, lk = pq_fused.search_route(route, *args, **kw)
        torch.cuda.synchronize()
        what = f"{name}/{route}"
        err = max(err, check_equal(what, dk, lk, dp, lp))
        check(not empty or bool((lk[0] == -1).all()), f"{what}: empty row")
        cases.append(what)
    return err


def pq_compacted_edge_checks(torch, cases) -> float:
    """Kernel 2's compacted route on the shapes the small cases above
    miss: the PQ path's table shape (T = 1024, about 80 live entries a
    row) at Q = 1 and 16 and at k = 10 and 1024 > C; m = 64 (a table above
    48 KB) and m = 16, each also filtered by every edge predicate; C =
    1024; a row of 1500 columns (compacted 1024 at a time); and ties
    across every window, warp and step boundary (an ADC table of a few
    integer values). Both routes, ``==`` to the plain version. Its own
    random stream."""
    rng = np.random.default_rng(4321)
    err = 0.0

    def pool_table(n_slabs, c, m, q, t, live_cols, dead=0.25):
        p = synthetic_pool(torch, rng, n_slabs, c, 4, dead_frac=dead, m=m,
                           ksub=256)
        table = np.full((q, t), -1, np.int32)
        for i in range(q):
            cols = np.sort(rng.permutation(t)[:live_cols])
            table[i, cols] = rng.integers(0, n_slabs, live_cols)
        return p, torch.from_numpy(table).cuda()

    for q, m, c, t, live, ks in ((1, 32, 128, 1024, 80, (10, 1024)),
                                 (16, 32, 128, 1024, 80, (10,)),
                                 (5, 64, 128, 1024, 40, (10, 64)),
                                 (6, 32, 1024, 64, 12, (10, 64)),
                                 (4, 16, 128, 1500, 300, (10,))):
        p, table = pool_table(64, c, m, q, t, live)
        adc = torch.from_numpy((4 * rng.random((q, m, 256))).astype(
            np.float32)).cuda()
        name = f"shape/Q={q}/m={m}/C={c}/T={t}"
        for k in ks:
            args = (adc, table, p["codes"], p["ids"], p["bitmap"], k)
            err = max(err, pq_variants(torch, f"{name}/k={k}", args, {},
                                       cases))
        if m in (16, 64):                 # the filtered instances there
            for fname, (pred, fk) in fused_edge_filters().items():
                fs, fc = compiled(torch, pred)
                args = (adc, table, p["codes"], p["ids"], p["bitmap"], fk)
                kw = dict(attrs=p["attrs"], fstruct=fs, fconsts=fc)
                err = max(err, pq_variants(
                    torch, f"{name}/filter={fname}", args, kw, cases))
    # ties everywhere: integer ADC values
    p, table = pool_table(48, 128, 32, 8, 256, 40, dead=0.1)
    adc = torch.from_numpy(rng.integers(0, 3, (8, 32, 256)).astype(
        np.float32)).cuda()
    for k in (10, 200):
        args = (adc, table, p["codes"], p["ids"], p["bitmap"], k)
        err = max(err, pq_variants(torch, f"ties/k={k}", args, {}, cases))
    return err


def scan_edge_checks(torch, rng) -> tuple[list, float]:
    """The unfused scan kernel on each of its routes vs its plain version
    (``==``) on the synthetic pools and tables (``-1`` pads, an empty row,
    dead slots, an empty slab, bit 31 set; L2 and IP; C=32, 128 and 1024;
    D=128, 37, 16, 300 and 301, the last two staged 128 columns at a time
    on the grouped route, 301 with 4-byte loads and a tail of one column
    in the sums' lanes; Q*T off the fill tiles' 256), and on an all-pad
    table;
    then ``topk`` of its output vs the fused kernel on the same table
    (``==``), at k=10 and at k=64 beyond the live rows."""
    from repro_torch.kernels.sivf_scan import sivf_scan as scan
    from repro_torch.kernels.sivf_scan.fused import sivf_fused_search_cuda
    from repro_torch.kernels.sivf_scan.ref import sivf_scan_ref
    from repro_torch.kernels.topk.topk import topk_cuda
    cases, max_err = [], 0.0
    for metric in ("l2", "ip"):
        for c in (32, 128, 1024):
            for d, q, t in ((128, 33, 12), (37, 8, 5), (16, 4, 3),
                            (300, 7, 9), (301, 7, 9)):
                p = synthetic_pool(torch, rng, 24, c, d, dead_frac=0.3)
                table = synthetic_table(rng, 24, q, t)
                if t == 3:
                    table[:] = -1                       # an all-pad table
                qs = rng.normal(size=(q, d)).astype(np.float32)
                args = (torch.from_numpy(qs).cuda(),
                        torch.from_numpy(table).cuda(), p["data"], p["ids"],
                        p["norms"], p["bitmap"])
                dp, lp = sivf_scan_ref(*args, metric=metric)
                name = f"{metric}/C={c}/D={d}/T={t}"
                for route in scan.ROUTES:
                    dk, lk = scan.scan_route(route, *args, metric=metric)
                    torch.cuda.synchronize()
                    max_err = max(max_err, check_equal(f"{name}/{route}", dk,
                                                       lk, dp, lp))
                    check(bool(torch.isinf(dk[0]).all()
                               and (lk[0] == -1).all()),
                          f"{name}/{route}: empty row not all +inf / -1")
                    cases.append(f"{name}/{route}")
                for k in (10, 64):
                    fd, fl = sivf_fused_search_cuda(*args, k, metric=metric)
                    td, tl = topk_cuda(dk, lk, k)
                    torch.cuda.synchronize()
                    check_equal(f"{name}/topk(scan) vs fused k={k}", td, tl,
                                fd, fl)
                    cases.append(f"{name}/topk(scan)==fused/k={k}")
    return cases, max_err


def topk_rows(rng, q, n, inf_frac=0.2):
    """Normal distances with ``inf_frac`` of ``+inf``; labels never -1."""
    d = rng.normal(size=(q, n)).astype(np.float32)
    d[rng.random((q, n)) < inf_frac] = np.inf
    return d, rng.integers(0, 1 << 30, (q, n)).astype(np.int32)


def topk_edge_rows(rng, n):
    """Rows of width ``n``: all ``+inf``; three finite entries (fewer than
    k); all equal; ``-0.0`` among ``+0.0`` with ties; ``-inf`` among
    finite and ``+inf`` entries; labels never ``-1``."""
    d = np.full((5, n), np.inf, np.float32)
    d[1, [n - 1, 2, n // 2]] = (0.5, 0.25, 0.5)
    d[2] = 1.0
    d[3] = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), n)
    d[4] = rng.normal(size=n).astype(np.float32)
    d[4, rng.random(n) < 0.3] = np.inf
    d[4, [1, n - 2]] = -np.inf
    return d, rng.integers(0, 1 << 30, (5, n)).astype(np.int32)


def merge_rows(rng, q: int, shards: int, k: int):
    """A mesh search's merge operand ``[q, shards * k]``: each shard's
    sorted ``[q, k]`` partial, concatenated in shard order, with short
    partials padded by ``+inf`` / -1, ``-0.0`` and ``+0.0`` on different
    shards and distances tied across shards."""
    d = np.sort(rng.choice(np.array([-0.0, 0.0, 0.5, 1.0, 2.0], np.float32),
                           (q, shards, k)), axis=2)
    d[:, :, k // 2:] += rng.normal(size=(q, shards, k - k // 2)).astype(
        np.float32) ** 2
    d = np.sort(d, axis=2)
    short = rng.random((q, shards, k)) < 0.25
    d = np.where(np.cumsum(short, axis=2) > 0, np.inf, d).astype(np.float32)
    lab = rng.integers(0, 1 << 30, (q, shards, k)).astype(np.int32)
    lab[np.isinf(d)] = -1
    return d.reshape(q, shards * k), lab.reshape(q, shards * k)


def topk_variants(topk, k: int) -> list[str]:
    """Every route of the top-k kernel that takes this ``k``: ``block``
    always, ``warp`` for ``k <= 32``."""
    return ["block"] + (["warp"] if k <= topk.MAX_WARP_K else [])


def topk_edge_checks(torch, rng) -> tuple[list, float]:
    """The top-k kernel on each of its routes vs its plain version (``==``
    bits and labels): k=1 and k=L, L=1, L not a multiple of the block
    (256) nor of 4 (rows that start off a 16-byte boundary), the edge rows,
    rows whose k smallest all lie in one thread's slice (columns 0 mod 256:
    refills on the block route), ties everywhere, a wide row at the
    search's k, and a mesh search's merge operands (``[Q, S*k]`` at S = 3,
    k = 10: 30 columns; S = 4, k = 1: 4 columns; S = 4, k = 10)."""
    from repro_torch.kernels.topk import topk
    from repro_torch.kernels.topk.ref import topk_ref
    strided = topk_rows(rng, 4, 20000, inf_frac=0.0)
    strided[0][:, ::256] -= 100.0
    ties = (np.full((3, 3001), 2.0, np.float32),
            rng.integers(0, 1 << 30, (3, 3001)).astype(np.int32))
    sets = {"random/L=1000": (topk_rows(rng, 33, 1000), (1, 10, 16, 17, 32,
                                                          33, 1000)),
            "L=1": (topk_rows(rng, 4, 1), (1,)),
            "L=7": (topk_rows(rng, 5, 7), (1, 3, 7)),
            "L=131079": (topk_rows(rng, 8, 131079), (10, 32)),
            "refill/L=5000": (topk_rows(rng, 2, 5000), (5000,)),
            "one_slice/L=20000": (strided, (10, 60, 100)),
            "all_equal/L=3001": (ties, (10, 32, 50, 3001)),
            "edge/L=40": (topk_edge_rows(rng, 40), (1, 10, 32, 40)),
            "edge/L=700": (topk_edge_rows(rng, 700), (10, 32, 300)),
            "mesh_merge/L=30": (merge_rows(rng, 1024, 3, 10), (10,)),
            "mesh_merge/L=4": (merge_rows(rng, 1024, 4, 1), (1,)),
            "mesh_merge/L=40": (merge_rows(rng, 1024, 4, 10), (10,))}
    cases, max_err = [], 0.0
    for name, ((d, lab), ks) in sets.items():
        d, lab = torch.from_numpy(d).cuda(), torch.from_numpy(lab).cuda()
        for k in ks:
            dp, lp = topk_ref(d, lab, k)
            for route in topk_variants(topk, k):
                dk, lk = topk.topk_route(route, d, lab, k)
                torch.cuda.synchronize()
                what = f"{name}/k={k}/{route}"
                max_err = max(max_err, check_equal(f"topk {what}", dk, lk,
                                                   dp, lp))
                cases.append(what)
    return cases, max_err


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


def phase_workload(torch, seed: int) -> tuple[dict, dict]:
    """The traffic both paths replay, the coarse centroids, and the exact
    top-k over the final live set (unfiltered and within each filter)."""
    import sivf_torch
    from repro_torch.core.filters import host_matches
    t0 = time.perf_counter()
    base, queries, rng = make_data(torch, seed, N_BASE)
    arng = np.random.default_rng(seed + 1)
    attrs_h = np.stack([arng.integers(0, N_TENANTS, N_BASE),
                        arng.integers(0, N_TS, N_BASE)], 1).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sample = base[torch.randperm(N_BASE, generator=gen, device="cuda")
                  [:TRAIN_ROWS]]
    train_state = gen.get_state()        # for kmeans_repeat_check
    cents = sivf_torch.train_kmeans(sample, N_LISTS, generator=gen)
    ow_ids = torch.from_numpy(rng.choice(N_BASE, OVERWRITE_ROWS,
                                         replace=False).astype(np.int32))
    ow_vecs = base[ow_ids.cuda().long()] + 0.01
    rm_ids = torch.from_numpy(rng.choice(N_BASE, REMOVE_ROWS,
                                         replace=False).astype(np.int32))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # exact top-k over the live set after the traffic: every path is
    # read against it (current vectors: base with the overwrites applied)
    t0 = time.perf_counter()
    cur = base.clone()
    cur[ow_ids.cuda().long()] = ow_vecs
    removed = torch.zeros(N_BASE, dtype=torch.bool, device="cuda")
    removed[rm_ids.cuda().long()] = True
    live_ids = torch.nonzero(~removed).reshape(-1)
    masks = {"unfiltered": None}
    for name, pred in filters_of().items():
        masks[name] = torch.from_numpy(host_matches(
            pred, ATTRS, attrs_h)).cuda()[live_ids]
    xs = cur[live_ids].double()
    best = {name: [] for name in masks}
    for q0 in range(0, N_QUERIES, 128):
        dd = torch.cdist(queries[q0:q0 + 128].double(), xs)
        for name, mask in masks.items():
            dm = dd if mask is None else dd.masked_fill(~mask, torch.inf)
            v, i = dm.topk(K, largest=False)
            best[name].append(torch.where(torch.isinf(v), -1, live_ids[i]))
    oracle = {name: torch.cat(b) for name, b in best.items()}
    torch.cuda.synchronize()
    wl = dict(base=base, queries=queries, cents=cents, sample=sample,
              attrs=torch.from_numpy(attrs_h).cuda(), attrs_h=attrs_h,
              ow_ids=ow_ids, ow_vecs=ow_vecs, rm_ids=rm_ids, cur=cur,
              removed=removed, oracle=oracle, seed=seed,
              train_state=train_state)
    line = {"phase": "workload", "setup_seconds": setup_s,
            "oracle_seconds": time.perf_counter() - t0, "n_base": N_BASE,
            "train_rows": TRAIN_ROWS, "n_live_after": int(live_ids.numel()),
            "selectivity": {name: float(host_matches(
                pred, ATTRS, attrs_h).mean())
                for name, pred in filters_of().items()}}
    return wl, line


def kmeans_repeat_check(torch, wl: dict) -> dict:
    """The coarse centroids trained a second time on the same sample from
    the same generator state: k-means sums in a fixed order, so the two
    trainings must agree bit for bit (the PQ codebooks are held the same
    way in ``phase_pq_main``). ``train_ms`` times the second training."""
    import sivf_torch
    gen = torch.Generator(device="cuda")
    gen.set_state(wl["train_state"])
    again, train_ms = timed(lambda: sivf_torch.train_kmeans(
        wl["sample"], N_LISTS, generator=gen))
    digests = [digest(wl["cents"]), digest(again)]
    check(digests[0] == digests[1],
          f"coarse k-means does not repeat itself: {digests}")
    return {"phase": "kmeans_repeat", "train_ms": train_ms,
            "rows": TRAIN_ROWS, "n_lists": N_LISTS,
            "centroids_sha256_two_trainings": digests}


def recall(torch, lab, best) -> float:
    """Share of the exact top-k (``best``, -1 padded) found in ``lab``."""
    lab, best = lab.long(), best.long()
    hit = ((lab[:, :, None] == best[:, None, :])
           & (best[:, None, :] >= 0)).any(1).sum()
    return float(hit) / max(int((best >= 0).sum()), 1)


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes: shows
    whether two runs at one seed made the same tensor (trained PQ
    codebooks, say)."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def zero_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.reclaim import reclaim
    from repro_torch.kernels.sivf_scan import fused, pq_fused, sivf_scan
    from repro_torch.kernels.topk import topk
    from repro_torch.kernels.wkv6 import wkv6
    fused.launches = fused.filtered_launches = 0
    fused.launches_grouped = fused.launches_per_query = 0
    sivf_scan.launches_grouped = sivf_scan.launches_per_entry = 0
    topk.launches_warp = topk.launches_block = 0
    pq_fused.launches = pq_fused.filtered_launches = 0
    pq_fused.launches_compacted = pq_fused.launches_per_query = 0
    reclaim.launches = sivf_scan.launches = topk.launches = 0
    paged_attention.launches = flash_attention.launches = 0
    flash_attention.launches_tensor_core = flash_attention.launches_simt = 0
    mamba_scan.launches = wkv6.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels.reclaim import reclaim
    from repro_torch.kernels.sivf_scan import fused, pq_fused, sivf_scan
    from repro_torch.kernels.topk import topk
    return {"sivf_fused_search": fused.launches,
            "sivf_fused_search[filtered]": fused.filtered_launches,
            "sivf_pq_fused_search": pq_fused.launches,
            "sivf_pq_fused_search[filtered]": pq_fused.filtered_launches,
            "reclaim": reclaim.launches, "sivf_scan": sivf_scan.launches,
            "topk": topk.launches}


def every_launch_count() -> dict:
    """Every kernel wrapper's launch count (:func:`read_counts` and the LM
    kernels')."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.wkv6 import wkv6
    return {**read_counts(), "paged_attention": paged_attention.launches,
            "flash_attention": flash_attention.launches,
            "mamba_scan": mamba_scan.launches, "wkv6": wkv6.launches}


def drive(torch, index, wl: dict, path: str, out: dict) -> list[dict]:
    """Ingest, overwrite, remove, unfiltered and filtered searches through
    ``index``; exact reports; labels live and inside each predicate."""
    from repro_torch.core.filters import host_matches
    lines = []
    base, queries, attrs = wl["base"], wl["queries"], wl["attrs"]
    ids = torch.arange(N_BASE, dtype=torch.int32, device="cuda")
    reps, ms = [], 0.0
    for lo in range(0, N_BASE, INGEST_BATCH):
        hi = lo + INGEST_BATCH
        r, dt = timed(lambda: index.add(base[lo:hi], ids[lo:hi],
                                        attrs=attrs[lo:hi]))
        reps.append(r)
        ms += dt
    accepted = sum(r.accepted for r in reps)
    check(accepted == N_BASE and all(r.ok for r in reps),
          f"{path}: ingest accepted {accepted}")
    lines.append({"phase": f"{path}.ingest", "ms": ms, "batches": len(reps),
                  "accepted": accepted, "rows_per_s": N_BASE / ms * 1e3})

    ow = wl["ow_ids"].cuda()
    r, dt = timed(lambda: index.add(wl["ow_vecs"], ow,
                                    attrs=attrs[ow.long()]))
    check(r.ok and r.overwritten == OVERWRITE_ROWS and r.accepted == 0,
          f"{path}: overwrite report {r}")
    lines.append({"phase": f"{path}.overwrite", "ms": dt,
                  "overwritten": r.overwritten, "accepted": r.accepted})

    removed, ms, buckets = 0, 0.0, []
    for lo in range(0, REMOVE_ROWS, REMOVE_BATCH):
        r, dt = timed(lambda: index.remove(
            wl["rm_ids"][lo:lo + REMOVE_BATCH].cuda()))
        check(r.ok, f"{path}: remove report {r}")
        removed += r.accepted
        ms += dt
        buckets.append(r.padded_to)
    check(removed == REMOVE_ROWS, f"{path}: remove accepted {removed}")
    lines.append({"phase": f"{path}.remove", "ms": ms, "accepted": removed,
                  "buckets": buckets, "n_live": index.n_live})

    lat = []
    for _ in range(N_SEARCH):
        res, dt = timed(lambda: index.search(queries, k=K, nprobe=NPROBE))
        lat.append(dt)
    out["result"] = res
    lines.append({"phase": f"{path}.search", "queries": N_QUERIES, "k": K,
                  "nprobe": NPROBE, "searches": N_SEARCH, "ms_each": lat,
                  "ms_median": float(np.median(lat)),
                  "qps": N_QUERIES / float(np.median(lat)) * 1e3})

    filtered = {}
    for name, pred in filters_of().items():
        fres, dt = timed(lambda: index.search(queries, k=K, nprobe=NPROBE,
                                              filter=pred))
        lab = fres.labels
        got = lab[lab >= 0].long()
        check(not bool(wl["removed"][got].any()),
              f"{path}/{name}: a removed id was returned")
        check(bool(host_matches(pred, ATTRS,
                                wl["attrs_h"][got.cpu().numpy()]).all()),
              f"{path}/{name}: a label fails its predicate")
        filtered[name] = {"ms": dt, "results": int(got.numel()),
                          "recall_at_10_vs_oracle": recall(
                              torch, lab, wl["oracle"][name])}
        out.setdefault("filtered", {})[name] = fres
    lines.append({"phase": f"{path}.filtered_search", "queries": N_QUERIES,
                  "k": K, "nprobe": NPROBE, "by_selectivity": filtered})
    return lines


def phase_main(torch, wl: dict, out: dict) -> list[dict]:
    """Drive the raw fp32 sivf_torch.Index(device="cuda") main path."""
    import sivf_torch
    cfg = sivf_torch.SIVFConfig(**CFG)
    index = sivf_torch.Index(cfg, wl["cents"], device="cuda")
    zero_counts()                                # counts of this path
    lines = drive(torch, index, wl, "raw", out)
    launches = read_counts()
    check(launches["sivf_fused_search"] == N_SEARCH,
          f"fused launches {launches['sivf_fused_search']} != {N_SEARCH}")
    check(launches["sivf_fused_search[filtered]"] == len(filters_of()),
          "filtered fused launches "
          f"{launches['sivf_fused_search[filtered]']}")
    check(launches["reclaim"] > 0, "reclaim kernel never launched")
    check(launches["sivf_pq_fused_search"] == 0, "PQ kernel on a raw path")
    from repro_torch.kernels.sivf_scan import fused
    routes = {"grouped": fused.launches_grouped,
              "per_query": fused.launches_per_query}
    check(routes["grouped"] == N_SEARCH + len(filters_of())
          and routes["per_query"] == 0,
          f"fused launches by route {routes}: the path's shapes take grouped")
    out["launches"] = launches
    lines.append({"phase": "raw.launches", **launches,
                  "sivf_fused_search_by_route": routes})
    lines.append(check_results(torch, index, wl, out["result"]))
    out.update(index=index, cfg=cfg)
    return lines


def check_results(torch, index, wl, res) -> dict:
    """Search output: shape, finite, live labels, distances that match the
    stored vectors, and recall@10 against exact search (reported)."""
    d, lab = res.distances, res.labels
    check(tuple(d.shape) == (N_QUERIES, K) and lab.dtype == torch.int32,
          "result shape")
    check(bool(torch.isfinite(d).all()) and bool((lab >= 0).all()),
          "every query should have k finite results")
    check(not bool(wl["removed"][lab.long()].any()),
          "a removed id was returned")
    st = index.state
    slab, slot = st.att_slab[lab.long()].long(), st.att_slot[lab.long()].long()
    x = st.data[slab, slot].double()
    exact = ((x - wl["queries"].double()[:, None]) ** 2).sum(-1)
    check(bool(torch.allclose(d.double(), exact, rtol=1e-4, atol=1e-3)),
          "result distances do not match the stored vectors")
    check(torch.equal(x.float(), wl["cur"][lab.long()]),
          "stored vectors are not the current payloads")
    return {"phase": "raw.results", "finite": True, "labels_live": True,
            "dists_match_stored": True,
            "recall_at_10_vs_exact": recall(torch, lab,
                                            wl["oracle"]["unfiltered"])}


def phase_pq_main(torch, wl: dict, out: dict) -> list[dict]:
    """Drive the PQ sivf_torch.Index(device="cuda"): train, then the same
    traffic as the raw path."""
    import sivf_torch
    from repro_torch.core import pq
    from repro_torch.kernels.sivf_scan.ref import adc_in_order
    cfg = sivf_torch.SIVFConfig(
        **CFG, pq=sivf_torch.PQConfig(m=PQ_M, nbits=PQ_NBITS))
    index = sivf_torch.Index(cfg, wl["cents"], device="cuda")
    zero_counts()                                # counts of this path
    gen = torch.Generator(device="cuda").manual_seed(wl["seed"])
    _, train_ms = timed(lambda: index.train(wl["sample"], generator=gen))
    # a second training from the same seed must repeat the codebooks
    again = pq.train_pq(wl["sample"], PQ_M, PQ_NBITS, generator=torch.Generator(
        device="cuda").manual_seed(wl["seed"]))
    cb_digests = [digest(index.state.pq_codebooks), digest(again)]
    check(cb_digests[0] == cb_digests[1],
          f"PQ k-means does not repeat itself: {cb_digests}")
    lines = [{"phase": "pq.train", "ms": train_ms, "rows": TRAIN_ROWS,
              "m": PQ_M, "nbits": PQ_NBITS,
              "codebooks_sha256_two_trainings": cb_digests,
              "state_bytes": sivf_torch.memory_report(cfg)}]
    lines += drive(torch, index, wl, "pq", out)
    launches = read_counts()
    check(launches["sivf_pq_fused_search"] == N_SEARCH,
          f"PQ launches {launches['sivf_pq_fused_search']} != {N_SEARCH}")
    check(launches["sivf_pq_fused_search[filtered]"] == len(filters_of()),
          "filtered PQ launches "
          f"{launches['sivf_pq_fused_search[filtered]']}")
    check(launches["reclaim"] > 0, "reclaim kernel never launched")
    check(launches["sivf_fused_search"] == 0
          and launches["sivf_fused_search[filtered]"] == 0,
          "raw kernel on the PQ path")
    from repro_torch.kernels.sivf_scan import pq_fused
    routes = {"compacted": pq_fused.launches_compacted,
              "per_query": pq_fused.launches_per_query}
    check(routes["compacted"] == N_SEARCH + len(filters_of())
          and routes["per_query"] == 0,
          f"PQ launches by route {routes}: the path's shapes take compacted")
    out["launches"] = launches
    lines.append({"phase": "pq.launches", **launches,
                  "sivf_pq_fused_search_by_route": routes})
    # results: k finite live labels whose ADC distance, recomputed from
    # the stored codes, is the one returned
    res = out["result"]
    d, lab = res.distances, res.labels
    check(bool(torch.isfinite(d).all()) and bool((lab >= 0).all()),
          "PQ: every query should have k finite results")
    check(not bool(wl["removed"][lab.long()].any()),
          "PQ: a removed id was returned")
    st = index.state
    check(st.data.shape[2] == 0, "PQ state keeps a payload plane")
    codes = st.codes[st.att_slab[lab.long()].long(),
                     st.att_slot[lab.long()].long()]           # [Q, K, m]
    adc = pq.adc_tables(st.pq_codebooks, wl["queries"], cfg.metric)
    again = torch.stack([adc_in_order(adc, codes[:, j:j + 1])[:, 0]
                         for j in range(K)], 1)
    check(bool(torch.allclose(d, again, rtol=1e-5, atol=1e-5)),
          "PQ distances do not match the stored codes")
    lines.append({"phase": "pq.results", "finite": True,
                  "labels_live": True, "dists_match_codes": True,
                  "pq_codebooks_sha256": digest(st.pq_codebooks),
                  "recall_at_10_vs_exact": recall(
                      torch, lab, wl["oracle"]["unfiltered"])})
    out.update(index=index, cfg=cfg)
    return lines


def probe_table(torch, cfg, st, queries):
    from repro_torch.core import index as ix
    from repro_torch.core import quantizer
    lists = quantizer.probe(st.centroids, queries, NPROBE, cfg.metric)
    return lists, ix.gather_tables(cfg, st, lists)        # [1024, 1024]


def scan_counts(torch, cfg, st, table, passing=None) -> dict:
    """What a scan of ``table`` needs: the distinct live probed slabs, the
    live slots of those, the (query, live slot) pairs scored, and with a
    predicate's ``passing`` [S, C] mask, the passing ones of each."""
    from repro_torch.core import bitmap as bm
    entries = table[table >= 0].long()
    distinct = torch.unique(entries)
    live = bm.unpack_batch(st.bitmap[distinct], cfg.capacity)   # [U, C]
    out = {"live_table_entries": int(entries.numel()),
           "distinct_live_slabs": int(distinct.numel()),
           "live_slots_of_distinct_slabs": int(live.sum()),
           "live_slots_scored": int(st.live[entries].sum())}
    if passing is not None:
        ok = passing & bm.unpack_batch(st.bitmap, cfg.capacity)  # [S, C]
        per_slab = ok.sum(1)
        out["passing_slots_of_distinct_slabs"] = int(per_slab[distinct].sum())
        out["passing_slots_scored"] = int(per_slab[entries].sum())
    return out


def passing_plane(torch, st, pred):
    """[S, C] bool: slots whose attributes pass ``pred``, and the number of
    distinct attributes it tests."""
    from repro_torch.core.filters import leaf_program
    from repro_torch.kernels.sivf_scan.ref import predicate_mask
    fs, fc = compiled(torch, pred)
    return predicate_mask(st.attrs, fs, fc), len(set(leaf_program(fs)[1::3]))


def row(name, source, replaces, launches, err, ms, plain_ms, bytes_, ops,
        hbm, peak=FP32_PEAK, library_ms=None) -> dict:
    """A ``kernels`` line entry: the bound is the larger of the bytes over
    the HBM rate and the operations over ``peak`` (fp32 unless given)."""
    tb, to = bytes_ / hbm, ops / peak
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": library_ms}


def fp32_share(torch, st, queries, d, lab) -> float:
    """The share of the 1e-5 distance limit (``RTOL``) that kernel 1's
    float32 L2 distances ``d`` use against the float64 distance of each
    returned label's row, read from the index's planes ``st``: max
    ``|d - exact| / (RTOL + RTOL exact)`` over the labels >= 0."""
    at = lab.clamp(min=0).long()
    x = st.data[st.att_slab[at].long(), st.att_slot[at].long()].double()
    exact = (queries.double()[:, None] - x).square().sum(-1)
    return over_limit(torch, d, exact.masked_fill(lab < 0, float("inf")))


def host_sync_checks(torch, call, sleep_cycles: int = 200_000_000) -> dict:
    """Show that ``call()`` (one wrapper call, warmed first) reads no
    device value on the host: once under
    ``torch.cuda.set_sync_debug_mode("error")`` (torch raises at any
    synchronising call of its own), and once queued behind a device sleep
    of ``sleep_cycles`` clocks, where it must return to the host in under
    half the sleep's time (a wait of any kind, the C side's included,
    would last until the sleep ends)."""
    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(sleep_cycles)
    end.record()
    t0 = time.perf_counter()
    call()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = start.elapsed_time(end)
    check(host_ms < sleep_ms / 2,
          f"the call took {host_ms} ms on the host behind a {sleep_ms} ms "
          "device sleep: it waits for the device")
    return {"sync_debug_mode_error": "passed", "device_sleep_ms": sleep_ms,
            "host_ms_behind_sleep": host_ms}


def call_bytes(torch, call, scratch_bytes: int, out_bytes: int) -> dict:
    """Device bytes one ``call()`` requests from the caching allocator
    above what was allocated before it (its ``requested_bytes`` peak: the
    sizes asked for, before the allocator rounds them), held to the
    wrapper's ``scratch_bytes`` plus its ``out_bytes`` of outputs."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    got = call()
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"] - before
    del got
    check(scratch_bytes <= peak <= scratch_bytes + out_bytes,
          f"one call requested {peak} device bytes; its scratch is "
          f"{scratch_bytes} and its outputs {out_bytes}")
    return {"scratch_bytes": scratch_bytes, "output_bytes": out_bytes,
            "requested_bytes_measured": peak}


def phase_full_size(torch, hbm: float, main: dict) -> tuple[list, list]:
    """Raw kernel vs plain at the main path's shapes, with times and
    bounds, unfiltered and at each selectivity; then the reclaim kernel."""
    from repro_torch.core import index as ix
    from repro_torch.core import quantizer
    from repro_torch.kernels.reclaim import ops as reclaim_ops
    from repro_torch.kernels.reclaim.reclaim import reclaim_cuda
    from repro_torch.kernels.reclaim.ref import reclaim_ref
    from repro_torch.kernels.sivf_scan import fused
    from repro_torch.kernels.sivf_scan.fused import sivf_fused_search_cuda
    from repro_torch.kernels.sivf_scan.ref import sivf_fused_search_ref
    index, cfg = main["index"], main["cfg"]
    queries = main["queries"]
    st = index.state
    lists, table = probe_table(torch, cfg, st, queries)
    args = (queries, table, st.data, st.ids, st.norms, st.bitmap, K)
    sub = (queries[:CHECK_QUERIES], table[:CHECK_QUERIES].contiguous()) \
        + args[2:]
    plan = fused.launch_plan(queries, table, st.data, K)
    dp, lp = sivf_fused_search_ref(*sub)
    err, shares = 0.0, {}
    for route in fused.ROUTES:                   # both routes, held alike
        dk, lk = fused.search_route(route, *sub)
        torch.cuda.synchronize()
        err = max(err, check_equal(f"fused full size/{route}", dk, lk, dp,
                                   lp))
        shares[route] = fp32_share(torch, st, sub[0], dk, lk)
    # the plain version on all queries (timed once), and the wrapper's own
    # route held to it there: the scan's chunks hold up to 16 queries only
    # at the path's batch size
    full = []
    plain_ms = cuda_ms(lambda: full.append(sivf_fused_search_ref(*args)),
                       reps=1, warm=False)
    dk, lk = sivf_fused_search_cuda(*args)
    err = max(err, check_equal("fused full size, all queries", dk, lk,
                               *full.pop()))
    shares["all_queries"] = fp32_share(torch, st, queries, dk, lk)
    del dk, lk
    check(max(shares.values()) <= FP32_LIMIT_SHARE,
          f"fused full size: share of the 1e-5 limit against float64 "
          f"{shares} > {FP32_LIMIT_SHARE}")
    syncs = host_sync_checks(torch, lambda: sivf_fused_search_cuda(*args))
    scratch = call_bytes(torch, lambda: sivf_fused_search_cuda(*args),
                         plan["scratch_bytes"], N_QUERIES * K * 8)
    # times at the main path's shape (Q=1024, T=1024), and the search's
    # other steps on the same inputs
    ms = cuda_median_ms(lambda: sivf_fused_search_cuda(*args), reps=20)
    # also the mean over 10 back-to-back launches, the method of the
    # script's earlier versions, so their readings compare like with like
    ms_b2b = cuda_ms(lambda: sivf_fused_search_cuda(*args), reps=10)
    probe_ms = cuda_ms(lambda: quantizer.probe(st.centroids, queries, NPROBE,
                                               cfg.metric), reps=10)
    gather_ms = cuda_ms(lambda: ix.gather_tables(cfg, st, lists), reps=10)
    # bound: bytes this table needs, each input read once, outputs once.
    # Of a probed slab the function needs its bitmap words, and the row,
    # id and norm of each live slot only; whole-slab and per-entry figures
    # are reported beside it.
    c, d, w = cfg.capacity, cfg.dim, cfg.words
    n = scan_counts(torch, cfg, st, table)
    slab_bytes = c * d * 4 + c * 8 + w * 4
    io = N_QUERIES * d * 4 + table.numel() * 4 + N_QUERIES * K * 8
    bytes_once = n["live_slots_of_distinct_slabs"] * (d * 4 + 8) \
        + n["distinct_live_slabs"] * w * 4 + io
    flops = 2 * n["live_slots_scored"] * d
    src = "src/repro_torch/csrc/sivf_fused_search.cu"
    rep = "src/repro/kernels/sivf_scan/fused.py:158"
    rows = [row("sivf_fused_search", src, rep,
                main["launches"]["sivf_fused_search"], err, ms, plain_ms,
                bytes_once, flops, hbm)]
    rows[0].update(kernel_route=plan["route"], **scratch,
                   registers_and_spills=route_usage("sivf_fused_search",
                                                    "grouped_scan_kernel"))
    lines = [{"phase": "fused_full_size",
              "queries_checked": {"default_route": N_QUERIES,
                                  **{r: CHECK_QUERIES for r in fused.ROUTES}},
              "max_abs_err": err, "fp32_limit_share": shares,
              "launches": main["launches"]["sivf_fused_search"],
              "route": plan["route"], "scratch": scratch,
              "shape": {"Q": N_QUERIES, "T": int(table.shape[1]), "C": c,
                        "D": d, "k": K}, **n, "ms": ms,
              "ms_mean_back_to_back": ms_b2b,
              "plain_ms": plain_ms, "bound_ms": rows[0]["bound_ms"],
              "bound_ms_whole_slab_once": (n["distinct_live_slabs"]
                                           * slab_bytes + io) / hbm * 1e3,
              "bound_ms_whole_slab_each_entry": (
                  n["live_table_entries"] * slab_bytes + io) / hbm * 1e3,
              "pct_of_bound": rows[0]["bound_ms"] / ms * 100,
              "host_syncs": syncs,
              "search_steps_ms": {"probe": probe_ms,
                                  "gather_tables": gather_ms,
                                  "sivf_fused_search": ms}}]

    # the filtered kernel at each selectivity, on the same table
    by_sel = {}
    for name, pred in filters_of().items():
        fs, fc = compiled(torch, pred)
        kw = dict(attrs=st.attrs, fstruct=fs, fconsts=fc)
        dp, lp = sivf_fused_search_ref(*sub, **kw)
        ferr, fshares = 0.0, {}
        for route in fused.ROUTES:
            dk, lk = fused.search_route(route, *sub, **kw)
            torch.cuda.synchronize()
            ferr = max(ferr, check_equal(f"fused[{name}] full size/{route}",
                                         dk, lk, dp, lp))
            fshares[route] = fp32_share(torch, st, sub[0], dk, lk)
        full = []
        fplain_ms = cuda_ms(
            lambda: full.append(sivf_fused_search_ref(*args, **kw)), reps=1,
            warm=False)
        dp, lp = full.pop()
        dk, lk = sivf_fused_search_cuda(*args, **kw)
        ferr = max(ferr, check_equal(f"fused[{name}] full size, all queries",
                                     dk, lk, dp, lp))
        fshares["all_queries"] = fp32_share(torch, st, queries, dk, lk)
        check(max(fshares.values()) <= FP32_LIMIT_SHARE,
              f"fused[{name}] full size: share of the 1e-5 limit against "
              f"float64 {fshares} > {FP32_LIMIT_SHARE}")
        check(torch.equal(lp, main["filtered"][name].labels),
              f"fused[{name}]: Index.search labels differ from the plain "
              "version's")
        del dk, lk, dp, lp
        fms = cuda_median_ms(lambda: sivf_fused_search_cuda(*args, **kw),
                             reps=20)
        passing, n_tested = passing_plane(torch, st, pred)
        fn = scan_counts(torch, cfg, st, table, passing)
        fbytes = n["distinct_live_slabs"] * w * 4 \
            + n["live_slots_of_distinct_slabs"] * 4 * n_tested \
            + fn["passing_slots_of_distinct_slabs"] * (d * 4 + 8) + io
        fflops = 2 * fn["passing_slots_scored"] * d
        entry = row("sivf_fused_search[filtered]", src, rep,
                    main["launches"]["sivf_fused_search[filtered]"], ferr,
                    fms, fplain_ms, fbytes, fflops, hbm)
        if name == REPRESENTATIVE:
            entry.update(kernel_route=plan["route"], **call_bytes(
                torch, lambda: sivf_fused_search_cuda(*args, **kw),
                plan["scratch_bytes"], N_QUERIES * K * 8),
                         registers_and_spills=route_usage(
                             "sivf_fused_search", "grouped_scan_kernel"))
            rows.append(entry)
        by_sel[name] = {"ms": fms, "vs_unfiltered": fms / ms,
                        "max_abs_err": ferr, "fp32_limit_share": fshares,
                        "passing_slots_scored": fn["passing_slots_scored"],
                        "bound_ms": entry["bound_ms"],
                        "bound_by": entry["bound_by"],
                        "plain_ms": entry["plain_ms"]}
    lines.append({"phase": "fused_filtered_full_size",
                  "queries_checked": {"default_route": N_QUERIES,
                                      **{r: CHECK_QUERIES
                                         for r in fused.ROUTES}},
                  "unfiltered_ms": ms, "by_selectivity": by_sel})

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
    rows.append(row("reclaim", "src/repro_torch/csrc/reclaim.cu",
                    "src/repro/core/index.py:361 (fori_loop in "
                    "_delete_impl; no Pallas kernel)",
                    main["launches"]["reclaim"], r_err, r_ms, plain_ms_r,
                    r_bytes, 0, hbm))
    lines.append({"phase": "reclaim_full_size", "delete_ids": REMOVE_BATCH,
                  "slabs_reclaimed": count, "distinct_bytes": r_bytes,
                  "delete_ms": del_ms,
                  "kernel_ms": r_ms, "plain_loop_cpu_ms": plain_ms_r,
                  "planes_equal": True})
    return lines, rows


SWEEP_QUERIES = (16, 64, 256, 1024)     # benchmarks/paper.py fused sweep


def route_usage(name: str, kernel: str) -> list[dict]:
    """Registers and spills of each instance of ``kernel`` in the build
    log of ``csrc/<name>.cu``."""
    return [f for f in ptxas_usage(_build().build_log(name))
            if kernel in f["function"]]


def phase_unfused(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The unfused search path on the raw path's index at full width:
    probe, ``gather_tables``, ``ops.sivf_scan`` (the ``[Q, T*C]`` candidate
    matrix), ``ops.topk``. Driven once with the launch counts zeroed just
    before and read just after, each kernel on its shapes' route; held bit
    for bit against the fused kernel and ``Index.search`` on all queries,
    and each kernel against its plain version on all queries (its other
    routes on the first ``CHECK_QUERIES`` rows for the scan, on all rows for
    the top-k); no host sync in either wrapper; the scan's device bytes
    (its plan's scratch and its outputs); then times, bounds and the
    fused-vs-unfused sweep of time and peak device bytes over the batch
    size, each kernel's route and time at each size."""
    from repro_torch.kernels.sivf_scan import fused
    from repro_torch.kernels.sivf_scan import ops as scan_ops
    from repro_torch.kernels.sivf_scan import sivf_scan as scan
    from repro_torch.kernels.sivf_scan.fused import sivf_fused_search_cuda
    from repro_torch.kernels.sivf_scan.ref import sivf_scan_ref
    from repro_torch.kernels.sivf_scan.sivf_scan import sivf_scan_cuda
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.kernels.topk import topk
    from repro_torch.kernels.topk.ref import topk_ref
    from repro_torch.kernels.topk.topk import topk_cuda
    index, cfg, queries = main["index"], main["cfg"], main["queries"]
    st = index.state
    t_phase = time.perf_counter()
    zero_counts()                                # counts of this path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, table = probe_table(torch, cfg, st, queries)
    dists, labels = scan_ops.sivf_scan(queries, table, st.data, st.ids,
                                       st.norms, st.bitmap, cfg.metric)
    d, lab = topk_ops.topk(dists, labels, K)
    torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    check(launches["sivf_scan"] == 1 and launches["topk"] == 1,
          f"unfused path launches {launches}")
    check(sum(launches.values()) == 2, f"other kernels ran: {launches}")
    qn, t_len = table.shape
    c, dim, w = cfg.capacity, cfg.dim, cfg.words
    n_cols = t_len * c
    check(tuple(dists.shape) == (qn, n_cols) and tuple(d.shape) == (qn, K),
          "unfused shapes")
    scan_plan = scan.launch_plan(queries, table, st.data)
    topk_plan = topk.launch_plan(dists, K)
    routes = {"sivf_scan": {"grouped": scan.launches_grouped,
                            "per_entry": scan.launches_per_entry},
              "topk": {"warp": topk.launches_warp,
                       "block": topk.launches_block}}
    check(routes["sivf_scan"][scan_plan["route"]] == 1
          and routes["topk"][topk_plan["route"]] == 1,
          f"unfused launches by route {routes}: the path's shapes take "
          f"{scan_plan['route']} and {topk_plan['route']}")
    # the three-way identity: pair == fused kernel == Index.search, all
    # queries, distances bit for bit and labels
    args = (queries, table, st.data, st.ids, st.norms, st.bitmap)
    fd, fl = sivf_fused_search_cuda(*args, K)
    torch.cuda.synchronize()
    check_equal("topk(sivf_scan) vs sivf_fused_search, all queries", d, lab,
                fd, fl)
    res = main["result"]
    check_equal("topk(sivf_scan) vs Index.search", d, lab, res.distances,
                res.labels)
    # the scan against its plain version on all queries (the plain output
    # of its timed run), its other route on the check queries
    full = []
    plain_scan = cuda_ms(lambda: full.append(sivf_scan_ref(
        *args, metric=cfg.metric)), reps=1, warm=False)
    dp, lp = full.pop()
    err_scan = check_equal("sivf_scan full size, all queries", dists, labels,
                           dp, lp)
    sub = (queries[:CHECK_QUERIES], table[:CHECK_QUERIES].contiguous()) \
        + args[2:]
    for route in scan.ROUTES:
        if route != scan_plan["route"]:
            dk, lk = scan.scan_route(route, *sub, metric=cfg.metric)
            torch.cuda.synchronize()
            err_scan = max(err_scan, check_equal(
                f"sivf_scan full size/{route}", dk, lk, dp[:CHECK_QUERIES],
                lp[:CHECK_QUERIES]))
            del dk, lk
    del dp, lp
    # the top-k against its plain version on all rows, every route
    tp, tlp = topk_ref(dists, labels, K)
    err_topk = check_equal("topk full size", d, lab, tp, tlp)
    for route in topk_variants(topk, K):
        if route != topk_plan["route"]:
            dk, lk = topk.topk_route(route, dists, labels, K)
            torch.cuda.synchronize()
            err_topk = max(err_topk, check_equal(
                f"topk full size/{route}", dk, lk, tp, tlp))
    lib_d, _ = torch.topk(dists, K, dim=1, largest=False, sorted=True)
    check(torch.equal(lib_d, d), "torch.topk distances differ from topk's")
    del tp, tlp, lib_d
    syncs = {"sivf_scan": host_sync_checks(
                 torch, lambda: sivf_scan_cuda(*args, cfg.metric)),
             "sivf_scan_per_entry": host_sync_checks(
                 torch, lambda: scan.scan_route("per_entry", *sub,
                                                metric=cfg.metric)),
             "topk": host_sync_checks(
                 torch, lambda: topk_cuda(dists, labels, K))}
    scratch = call_bytes(torch, lambda: sivf_scan_cuda(*args, cfg.metric),
                         scan_plan["scratch_bytes"], qn * n_cols * 8)
    # times on the same inputs: median of 20 launches each
    ms_scan = cuda_median_ms(lambda: sivf_scan_cuda(*args, cfg.metric), 20)
    ms_topk = cuda_median_ms(lambda: topk_cuda(dists, labels, K), 20)
    lib_ms = cuda_median_ms(lambda: torch.topk(dists, K, dim=1, largest=False,
                                               sorted=True), 20)
    ms_fused = cuda_median_ms(lambda: sivf_fused_search_cuda(*args, K), 20)
    plain_topk = cuda_median_ms(lambda: topk_ref(dists, labels, K), 5)
    # bounds: each input read once, each output written once. The scan
    # needs the live rows of each distinct probed slab and writes every
    # slot; the top-k reads every distance and only the k chosen labels.
    n = scan_counts(torch, cfg, st, table)
    out_bytes = qn * n_cols * 8
    scan_bytes = out_bytes + n["live_slots_of_distinct_slabs"] * (dim * 4 + 8) \
        + n["distinct_live_slabs"] * w * 4 + qn * dim * 4 + table.numel() * 4
    topk_bytes = qn * n_cols * 4 + qn * K * 4 + qn * K * 8
    rows = [row("sivf_scan", "src/repro_torch/csrc/sivf_scan.cu",
                "src/repro/kernels/sivf_scan/sivf_scan.py:63",
                launches["sivf_scan"], err_scan, ms_scan, plain_scan,
                scan_bytes, 2 * n["live_slots_scored"] * dim, hbm),
            row("topk", "src/repro_torch/csrc/topk.cu",
                "src/repro/kernels/topk/topk.py:38", launches["topk"],
                err_topk, ms_topk, plain_topk, topk_bytes, qn * n_cols, hbm)]
    rows[0].update(kernel_route=scan_plan["route"], **scratch,
                   registers_and_spills=route_usage("sivf_scan",
                                                    "grouped_scan_kernel"))
    rows[1].update(kernel_route=topk_plan["route"], library_ms=lib_ms,
                   registers_and_spills=route_usage("topk",
                                                    "warp_topk_kernel"))
    del dists, labels
    # fused vs unfused over the batch size (benchmarks/paper.py:329-351):
    # time, and peak device bytes allocated above what is resident; each
    # kernel of the pair timed alone on its own inputs too
    sweep = []
    for q in SWEEP_QUERIES:
        a = (queries[:q], table[:q].contiguous()) + args[2:]
        paths = {"unfused": lambda: topk_cuda(*sivf_scan_cuda(
                     *a, cfg.metric), K),
                 "fused": lambda: sivf_fused_search_cuda(*a, K)}
        entry = {"Q": q, "candidate_bytes": q * n_cols * 8,
                 "fused_route": fused.route(q, t_len, c, K),
                 "scan_route": scan.route(q, t_len, c),
                 "topk_route": topk.route(q, n_cols, K)}
        for name, fn in paths.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = fn()
            torch.cuda.synchronize()
            entry[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated() \
                - base
            del got
            entry[f"{name}_ms"] = cuda_median_ms(fn, 10)
        qd, ql = sivf_scan_cuda(*a, cfg.metric)
        entry["sivf_scan_ms"] = cuda_median_ms(
            lambda: sivf_scan_cuda(*a, cfg.metric), 10)
        entry["topk_ms"] = cuda_median_ms(lambda: topk_cuda(qd, ql, K), 10)
        del qd, ql
        if q >= 64:
            check(entry["fused_peak_bytes"] < entry["unfused_peak_bytes"],
                  f"Q={q}: fused allocates no less than unfused {entry}")
        sweep.append(entry)
    line = {"phase": "unfused", "path_ms": path_ms,
            "launches": {"sivf_scan": launches["sivf_scan"],
                         "topk": launches["topk"]},
            "launches_by_route": routes,
            "routes": {"sivf_scan": scan_plan["route"],
                       "topk": topk_plan["route"]},
            "shape": {"Q": qn, "T": t_len, "C": c, "D": dim, "k": K},
            "identity_all_queries": True, "equals_index_search": True,
            "queries_checked_scan": {scan_plan["route"]: qn,
                                     **{r: CHECK_QUERIES for r in scan.ROUTES
                                        if r != scan_plan["route"]}},
            "rows_checked_topk": qn, "scan_scratch": scratch,
            "host_syncs": syncs,
            "registers_and_spills": {"sivf_scan": rows[0][
                "registers_and_spills"], "topk": rows[1][
                "registers_and_spills"]},
            **n, "ms": {"sivf_scan": ms_scan, "topk": ms_topk,
                        "pair": ms_scan + ms_topk, "torch_topk": lib_ms,
                        "sivf_fused_search": ms_fused},
            "plain_ms": {"sivf_scan": plain_scan, "topk": plain_topk},
            "bound_ms": {"sivf_scan": rows[0]["bound_ms"],
                         "topk": rows[1]["bound_ms"],
                         "topk_labels_read_whole": (
                             qn * n_cols * 8 + qn * K * 8) / hbm * 1e3},
            "bound_by": {"sivf_scan": rows[0]["bound_by"],
                         "topk": rows[1]["bound_by"]},
            "pct_of_bound": {"sivf_scan": rows[0]["bound_ms"] / ms_scan * 100,
                             "topk": rows[1]["bound_ms"] / ms_topk * 100},
            "sweep": sweep, "seconds": time.perf_counter() - t_phase}
    return [line], rows


def phase_pq_full_size(torch, hbm: float, main: dict) -> tuple[list, list]:
    """Kernel 2 at the PQ path's shapes on one shared ADC table: the
    default route held ``==`` to the plain version on all queries and to
    ``Index.search``'s labels on every row, unfiltered and at each
    selectivity, and every route on the first ``CHECK_QUERIES``; no host
    sync; one call's device bytes; times and bounds (bytes, and the
    lookups at ``LOOKUP_RATE``)."""
    from repro_torch.core import pq
    from repro_torch.kernels.sivf_scan import pq_fused
    from repro_torch.kernels.sivf_scan.pq_fused import (
        sivf_pq_fused_search_cuda,
    )
    from repro_torch.kernels.sivf_scan.ref import sivf_pq_fused_search_ref
    index, cfg, queries = main["index"], main["cfg"], main["queries"]
    st = index.state
    m, ksub = cfg.pq.m, cfg.pq.ksub
    _, table = probe_table(torch, cfg, st, queries)
    adc = pq.adc_tables(st.pq_codebooks, queries, cfg.metric).contiguous()
    adc_ms = cuda_ms(lambda: pq.adc_tables(st.pq_codebooks, queries,
                                           cfg.metric), reps=10)
    args = (adc, table, st.codes, st.ids, st.bitmap, K)
    sub = (adc[:CHECK_QUERIES], table[:CHECK_QUERIES].contiguous()) \
        + args[2:]
    plan = pq_fused.launch_plan(adc, table, st.codes, K)
    routes = {}

    def held(what, kw, index_labels):
        """The default route on every query (the plain version timed once)
        and each route on the first CHECK_QUERIES, all ``==``; the labels
        of Index.search too. Returns (max error, plain ms)."""
        full = []
        plain_ms = cuda_ms(lambda: full.append(sivf_pq_fused_search_ref(
            *args, **kw)), reps=1, warm=False)
        dp, lp = full.pop()
        dk, lk = sivf_pq_fused_search_cuda(*args, **kw)
        err = check_equal(f"{what}, all queries", dk, lk, dp, lp)
        check(torch.equal(lp, index_labels),
              f"{what}: Index.search labels differ from the plain version's")
        dp, lp = sivf_pq_fused_search_ref(*sub, **kw)
        for route in pq_fused.ROUTES:
            dk, lk = pq_fused.search_route(route, *sub, **kw)
            torch.cuda.synchronize()
            err = max(err, check_equal(f"{what}/{route}", dk, lk, dp, lp))
            routes[route] = routes.get(route, 0) + 1
        return err, plain_ms

    err, plain_ms = held("pq full size", {}, main["result"].labels)
    syncs = host_sync_checks(torch, lambda: sivf_pq_fused_search_cuda(*args))
    request = call_bytes(torch, lambda: sivf_pq_fused_search_cuda(*args), 0,
                         N_QUERIES * K * 8)
    ms = cuda_median_ms(lambda: sivf_pq_fused_search_cuda(*args), reps=20)
    w = cfg.words
    n = scan_counts(torch, cfg, st, table)
    adc_bytes = adc.numel() * 4
    io = adc_bytes + table.numel() * 4 + N_QUERIES * K * 8
    bytes_once = n["distinct_live_slabs"] * w * 4 \
        + n["live_slots_of_distinct_slabs"] * (m + 4) + io
    lookups = n["live_slots_scored"] * m
    src = "src/repro_torch/csrc/sivf_pq_fused_search.cu"
    rep = "src/repro/kernels/sivf_scan/pq_fused.py:94"
    rows = [row("sivf_pq_fused_search", src, rep,
                main["launches"]["sivf_pq_fused_search"], err, ms, plain_ms,
                bytes_once, lookups, hbm, peak=LOOKUP_RATE)]
    rows[0].update(kernel_route=plan["route"], **request)
    lines = [{"phase": "pq_full_size",
              "queries_checked": {"default_route": N_QUERIES,
                                  **{r: CHECK_QUERIES
                                     for r in pq_fused.ROUTES}},
              "max_abs_err": err,
              "launches": main["launches"]["sivf_pq_fused_search"],
              "route": plan["route"], "request": request,
              "smem_bytes": plan["smem_bytes"],
              "shape": {"Q": N_QUERIES, "T": int(table.shape[1]),
                        "C": cfg.capacity, "m": m, "ksub": ksub, "k": K},
              **n, "adc_table_bytes": adc_bytes, "bound_bytes": bytes_once,
              "lookups": lookups, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": rows[0]["bound_ms"],
              "bound_by": rows[0]["bound_by"],
              "bound_ms_bytes": bytes_once / hbm * 1e3,
              "bound_ms_lookups": lookups / LOOKUP_RATE * 1e3,
              "pct_of_bound": rows[0]["bound_ms"] / ms * 100,
              "host_syncs": syncs, "adc_tables_ms": adc_ms}]
    by_sel = {}
    for name, pred in filters_of().items():
        fs, fc = compiled(torch, pred)
        kw = dict(attrs=st.attrs, fstruct=fs, fconsts=fc)
        ferr, fplain_ms = held(f"pq[{name}] full size", kw,
                               main["filtered"][name].labels)
        fms = cuda_median_ms(lambda: sivf_pq_fused_search_cuda(*args, **kw),
                             reps=20)
        passing, n_tested = passing_plane(torch, st, pred)
        fn = scan_counts(torch, cfg, st, table, passing)
        fbytes = n["distinct_live_slabs"] * w * 4 \
            + n["live_slots_of_distinct_slabs"] * 4 * n_tested \
            + fn["passing_slots_of_distinct_slabs"] * (m + 4) + io
        flookups = fn["passing_slots_scored"] * m
        entry = row("sivf_pq_fused_search[filtered]", src, rep,
                    main["launches"]["sivf_pq_fused_search[filtered]"], ferr,
                    fms, fplain_ms, fbytes, flookups, hbm, peak=LOOKUP_RATE)
        if name == REPRESENTATIVE:
            entry.update(kernel_route=plan["route"],
                         **call_bytes(torch, lambda: sivf_pq_fused_search_cuda(
                             *args, **kw), 0, N_QUERIES * K * 8))
            rows.append(entry)
        by_sel[name] = {"ms": fms, "vs_unfiltered": fms / ms,
                        "max_abs_err": ferr,
                        "passing_slots_scored": fn["passing_slots_scored"],
                        "bound_ms": entry["bound_ms"],
                        "bound_by": entry["bound_by"],
                        "bound_ms_bytes": fbytes / hbm * 1e3,
                        "bound_ms_lookups": flookups / LOOKUP_RATE * 1e3,
                        "plain_ms": fplain_ms}
    lines.append({"phase": "pq_filtered_full_size",
                  "queries_checked": lines[0]["queries_checked"],
                  "unfiltered_ms": ms, "by_selectivity": by_sel,
                  "route_checks": routes})
    return lines, rows


# ---------------------------------------------------------------------------
# The index's lifecycle: persistence, the tiered pool, maintenance
# ---------------------------------------------------------------------------

DEVICE_SLABS = 8192                     # half the pool's 16,384 slabs
PERSIST_NPROBES = (8, 16, 32, 64, 128, 256)   # the six search batches
TIERED_Q = 64                           # queries a tiered batch
TIERED_OVERWRITE, TIERED_REMOVE = 16384, 65536
MAINT_SWEEPS = 3


def kernel_counts() -> dict:
    """The scan kernels' launch counters, by route."""
    from repro_torch.kernels.sivf_scan import fused, pq_fused
    return {"fused": fused.launches + fused.filtered_launches,
            "fused_grouped": fused.launches_grouped,
            "fused_per_query": fused.launches_per_query,
            "pq": pq_fused.launches + pq_fused.filtered_launches,
            "pq_compacted": pq_fused.launches_compacted,
            "pq_per_query": pq_fused.launches_per_query}


class Launches:
    """Kernel launches made inside ``with launches.of():`` blocks only, so
    that a tiered index's launches are counted apart from the launches of
    the all-resident index it is compared with (``counts``: the counters
    read, ``kernel_counts`` by default)."""

    def __init__(self, counts=None):
        self.counts = counts or kernel_counts
        self.n = {k: 0 for k in self.counts()}

    @contextlib.contextmanager
    def of(self):
        before = self.counts()
        yield
        after = self.counts()
        for k in self.n:
            self.n[k] += after[k] - before[k]


def same_result(what: str, a, b) -> None:
    """Two SearchResults: labels and distances ``==`` bit for bit."""
    import torch
    check(torch.equal(a.labels, b.labels)
          and torch.equal(a.distances.view(torch.int32),
                          b.distances.view(torch.int32)),
          f"{what}: results differ")


def plane_digests(index) -> dict:
    """SHA-256 (16 hex digits) of each plane as a checkpoint stores it."""
    return state_digests(index.state)


def state_digests(st) -> dict:
    """:func:`plane_digests` of one ``SlabPoolState``."""
    from repro_torch import interop
    planes = interop.state_to_numpy(st)
    return {name: hashlib.sha256(np.ascontiguousarray(a).reshape(-1).view(
        np.uint8)).hexdigest()[:16] for name, a in planes.items()}


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def persist_check(torch, index, queries, path: str) -> tuple[dict, object]:
    """Save ``index`` under ``build/``, load it back on the card: every
    plane ``==`` (digests) and the six search batches ``==``. Returns the
    line and the checkpoint directory (removed by the caller)."""
    import shutil
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix=f"ckpt_{path}_", dir=ROOT / "build"))
    try:
        return _persist_check(torch, index, queries, path, ckpt), ckpt
    except BaseException:
        shutil.rmtree(ckpt, ignore_errors=True)
        raise


def _persist_check(torch, index, queries, path: str, ckpt: Path) -> dict:
    import sivf_torch
    before = [index.search(queries, K, nprobe) for nprobe in PERSIST_NPROBES]
    digests = plane_digests(index)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.save(ckpt)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loaded = sivf_torch.Index.load(ckpt, device="cuda")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    check(loaded.state.ids.device == index.state.ids.device
          and loaded.cfg == index.cfg,
          f"{path}: the loaded index is not the saved one on the card")
    got = plane_digests(loaded)
    bad = [n for n in digests if got[n] != digests[n]]
    check(not bad, f"{path}: planes differ after the load: {bad}")
    for nprobe, want in zip(PERSIST_NPROBES, before):
        same_result(f"{path} persist nprobe={nprobe}", loaded.search(
            queries, K, nprobe), want)
    from repro_torch.core.state import memory_report
    line = {"phase": f"{path}.persist", "bytes_on_disk": dir_bytes(ckpt),
            "device_bytes": memory_report(index.cfg)["device_bytes"],
            "save_ms": save_ms, "load_ms": load_ms, "planes_equal": True,
            "plane_sha256": digests,
            "searches_equal": {"queries": int(queries.shape[0]), "k": K,
                               "nprobe": list(PERSIST_NPROBES)}}
    del loaded
    return line


def phase_persist(torch, hbm: float, main: dict) -> tuple[list, list]:
    """Save the raw index and load it back (``persist_check``)."""
    line, ckpt = persist_check(torch, main["index"], main["queries"], "raw")
    main["ckpt"] = ckpt                 # the tiered and serve phases load it
    return [line], []


class UploadTimes:
    """Wraps ``TieredRuntime._upload``: the slabs of each upload, the
    device time between events around it (its gather into the staging
    buffer on the host, the one copy and the frame writes) and the host
    time of the gather alone (``last_upload["pack_ms"]``)."""

    def __init__(self, torch):
        from repro_torch.core import tiered as trt
        self.torch, self.trt = torch, trt
        self.real = trt.TieredRuntime._upload
        self.calls = []

        def upload(rt, frames, slabs):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            b0 = rt.h2d_bytes
            s.record()
            self.real(rt, frames, slabs)
            e.record()
            self.calls.append({"slabs": [int(x) for x in slabs],
                               "events": (s, e),
                               "bytes": rt.h2d_bytes - b0,
                               "pack_ms": rt.last_upload["pack_ms"]})
        trt.TieredRuntime._upload = upload

    def restore(self):
        self.trt.TieredRuntime._upload = self.real

    def summary(self, since: int = 0) -> dict:
        self.torch.cuda.synchronize()
        calls = self.calls[since:]
        ms = sum(c["events"][0].elapsed_time(c["events"][1]) for c in calls)
        pack = sum(c["pack_ms"] for c in calls)
        nbytes = sum(c["bytes"] for c in calls)
        return {"uploads": len(calls), "bytes": nbytes, "ms": ms,
                "gb_per_s": nbytes / ms / 1e6 if ms else None,
                "host_gather_ms": pack,
                "gb_per_s_without_gather": nbytes / (ms - pack) / 1e6
                if ms > pack else None}


def phase_tiered(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The raw checkpoint loaded with ``device_slabs=DEVICE_SLABS``: Q=64
    batches at nprobe 32, cold then warm, ``==`` the all-resident index;
    churn applied to both; a filtered batch; a full-probe Q=1024 batch."""
    import sivf_torch
    from repro_torch.core.state import memory_report
    index, queries, wl = main["index"], main["queries"], main["wl"]
    t0 = time.perf_counter()
    tindex = sivf_torch.Index.load(main["ckpt"], device="cuda",
                                   device_slabs=DEVICE_SLABS)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    rt = tindex._tiered
    mem = {"all_resident": memory_report(index.cfg),
           "tiered": memory_report(tindex.cfg)}
    check(tindex.state.data.shape[0] == 0 and rt.cache.data.shape[0]
          == DEVICE_SLABS, "tiered: the payload planes are on the card")
    check(mem["tiered"]["device_cache_bytes"] == rt.cache.data.numel() * 4
          + rt.cache.attrs.numel() * 4 + rt.cache.codes.numel(),
          "tiered: memory_report's cache bytes are not the frames'")
    launches = Launches()
    uploads = UploadTimes(torch)
    lines = []
    try:
        batches = []
        for b0 in range(0, N_QUERIES, TIERED_Q):
            qs = queries[b0:b0 + TIERED_Q]
            want = index.search(qs, K, NPROBE)
            n_up = len(uploads.calls)
            with launches.of():
                cold, cold_ms = timed(lambda: tindex.search(qs, K, NPROBE))
            same_result(f"tiered cold batch {b0 // TIERED_Q}", cold, want)
            unique = rt.last_prefetch["unique"]
            check(unique <= DEVICE_SLABS, f"batch probes {unique} slabs")
            up = uploads.summary(n_up)
            copies, ups = rt.h2d_copies, rt.stats()["cache_uploads"]
            warm_ms = []
            for _ in range(3):
                with launches.of():
                    warm, ms = timed(lambda: tindex.search(qs, K, NPROBE))
                same_result(f"tiered warm batch {b0 // TIERED_Q}", warm, want)
                warm_ms.append(ms)
            check(rt.h2d_copies == copies
                  and rt.stats()["cache_uploads"] == ups,
                  "tiered: a warm search copied to the card")
            batches.append({"unique_slabs": unique,
                            "refs": rt.last_prefetch["refs"],
                            "cold_ms": cold_ms, "warm_ms": warm_ms,
                            "uploaded_slabs": sum(
                                len(c["slabs"]) for c in
                                uploads.calls[n_up:]),
                            "upload_bytes": up["bytes"],
                            "upload_ms": up["ms"],
                            "upload_gb_per_s": up["gb_per_s"],
                            "upload_host_gather_ms": up["host_gather_ms"]})
        st = tindex.stats()
        total = uploads.summary()
        lines.append({
            "phase": "tiered.search", "device_slabs": DEVICE_SLABS,
            "load_ms": load_ms, "queries_per_batch": TIERED_Q,
            "nprobe": NPROBE, "batches": len(batches),
            "memory_report": {k: {f: v[f] for f in (
                "host_bytes", "device_bytes", "device_cache_bytes",
                "total_bytes")} for k, v in mem.items()},
            "unique_slabs_max": max(b["unique_slabs"] for b in batches),
            "cold_ms_median": float(np.median([b["cold_ms"]
                                               for b in batches])),
            "warm_ms_median": float(np.median([m for b in batches
                                               for m in b["warm_ms"]])),
            "upload_bytes": total["bytes"], "upload_ms": total["ms"],
            "upload_gb_per_s": total["gb_per_s"],
            "upload_host_gather_ms": total["host_gather_ms"],
            "upload_gb_per_s_without_gather":
                total["gb_per_s_without_gather"],
            "hit_rate": st["hit_rate"], "cache_hits": st["cache_hits"],
            "cache_misses": st["cache_misses"],
            "cache_uploads": st["cache_uploads"],
            "cache_evictions": st["cache_evictions"],
            "resident_slabs": st["resident_slabs"], "per_batch": batches})

        # churn on both: an overwrite and a remove, then the next search
        rng = np.random.default_rng(wl["seed"] + 7)
        live = torch.nonzero(index.state.att_slab >= 0).reshape(-1).cpu()
        pick = rng.choice(live.numel(), TIERED_OVERWRITE + TIERED_REMOVE,
                          replace=False)
        ow = live[pick[:TIERED_OVERWRITE]].to(torch.int32).cuda()
        rm = live[pick[TIERED_OVERWRITE:]].to(torch.int32).cuda()
        ow_vecs = wl["cur"][ow.long()] + 0.02
        ow_attrs = wl["attrs"][ow.long()]
        for x in (index, tindex):
            r = x.add(ow_vecs, ow, attrs=ow_attrs)
            check(r.ok and r.overwritten == TIERED_OVERWRITE,
                  f"tiered churn: overwrite report {r}")
            r = x.remove(rm)
            check(r.ok and r.accepted == TIERED_REMOVE,
                  f"tiered churn: remove report {r}")
        qs = queries[:TIERED_Q]
        rt.drain_plans()
        dirty = set(rt.res.dirty)
        n_up = len(uploads.calls)
        with launches.of():
            res, ms = timed(lambda: tindex.search(qs, K, NPROBE))
        same_result("tiered after churn", res, index.search(qs, K, NPROBE))
        after_churn = dict(rt.last_prefetch)
        slabs = [s for c in uploads.calls[n_up:] for s in c["slabs"]]
        check(set(slabs) <= dirty, "tiered: uploaded a slab that no write "
              "dirtied")
        # a filtered batch at about 10 %
        pred = filters_of()["in_10pct"]
        with launches.of():
            fres, fms = timed(lambda: tindex.search(qs, K, NPROBE,
                                                    filter=pred))
        same_result("tiered filtered", fres, index.search(qs, K, NPROBE,
                                                          filter=pred))
        lines.append({"phase": "tiered.churn",
                      "overwritten": TIERED_OVERWRITE,
                      "removed": TIERED_REMOVE, "dirty_slabs": len(dirty),
                      "search_ms": ms, "uploaded_slabs": len(slabs),
                      "uploaded_all_dirtied": True,
                      "prefetch": after_churn,
                      "filtered_in_10pct_ms": fms,
                      "filtered_results": int((fres.labels >= 0).sum())})

        # every live slab at once: Q=1024 at nprobe = n_lists
        used = tindex.stats()["slabs_used"]
        n0 = len(uploads.calls)
        if used > DEVICE_SLABS:
            err = None
            try:
                tindex.search(queries, K, N_LISTS)
            except ValueError as e:
                err = str(e)
            check(err is not None and "device_slabs" in err,
                  f"a full probe of {used} slabs with {DEVICE_SLABS} frames "
                  f"gave {err!r}, not the device_slabs ValueError")
            case = {"case": "raised", "error": err[:200]}
        else:
            with launches.of():
                full, fms = timed(lambda: tindex.search(queries, K, N_LISTS))
            same_result("tiered full probe", full,
                        index.search(queries, K, N_LISTS))
            case = {"case": "equal", "ms": fms,
                    "uploads": uploads.summary(n0)}
        lines.append({"phase": "tiered.full_probe", "queries": N_QUERIES,
                      "nprobe": N_LISTS, "live_slabs": used,
                      "device_slabs": DEVICE_SLABS, **case})
    finally:
        uploads.restore()
    n = launches.n
    check(n["fused"] > 0 and n["fused_grouped"] == n["fused"]
          and n["fused_per_query"] == 0 and n["pq"] == 0,
          f"tiered launches by route {n}: kernel 1 takes grouped")
    lines.append({"phase": "tiered.launches", **n,
                  "h2d_copies": rt.h2d_copies, "h2d_bytes": rt.h2d_bytes,
                  "d2h_reads": rt.d2h_reads})
    main["tindex"] = tindex
    return lines, []


def live_payloads(torch, index) -> tuple:
    """(ids, payload rows, attribute rows) of every live id, id order, on
    the host: read from the card's planes, or from the host store of a
    tiered index."""
    att_slab = index.state.att_slab.cpu().numpy()
    att_slot = index.state.att_slot.cpu().numpy()
    ids = np.flatnonzero(att_slab >= 0)
    s, o = att_slab[ids], att_slot[ids]
    if index._tiered is not None:
        st = index._tiered.store
        return ids, st.data[s, o], st.attrs[s, o]
    st = index.state
    si = torch.from_numpy(s).cuda().long()
    so = torch.from_numpy(o).cuda().long()
    return ids, st.data[si, so].cpu().numpy(), st.attrs[si, so].cpu().numpy()


def exact_top(torch, index, queries) -> "torch.Tensor":
    """The exact top-K over the index's live set (float64 distances)."""
    ids, rows, _ = live_payloads(torch, index)
    xs = torch.from_numpy(rows).cuda().double()
    live = torch.from_numpy(ids).cuda()
    out = []
    for q0 in range(0, queries.shape[0], 128):
        dd = torch.cdist(queries[q0:q0 + 128].double(), xs)
        out.append(live[dd.topk(K, largest=False).indices])
    return torch.cat(out)


def phase_maintain(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The same maintenance on the all-resident and the tiered index:
    policy sweeps, then an explicit split, merge and recluster; after
    each op the live set, the metadata planes and the searches hold."""
    import sivf_torch
    from repro_torch.core.state import PLANES
    index, tindex, queries = main["index"], main.pop("tindex"), \
        main["queries"]
    ids0, rows0, attrs0 = live_payloads(torch, index)
    best = exact_top(torch, index, queries)
    recall0 = recall(torch, index.search(queries, K, NPROBE).labels, best)
    qs = queries[:TIERED_Q]
    launches = Launches()
    ops_out = []

    def after_op(what: str, reps, treps) -> None:
        check([dataclasses.astuple(r) for r in reps]
              == [dataclasses.astuple(r) for r in treps],
              f"{what}: reports differ {reps} {treps}")
        for x in (index, tindex):
            ids, rows, attrs = live_payloads(torch, x)
            check(np.array_equal(ids, ids0) and np.array_equal(rows, rows0)
                  and np.array_equal(attrs, attrs0),
                  f"{what}: the live set changed")
        bad = [n for n in PLANES if n not in ("data", "codes", "attrs")
               and not torch.equal(getattr(index.state, n),
                                   getattr(tindex.state, n))]
        check(not bad, f"{what}: metadata planes differ {bad}")
        with launches.of():
            tres = tindex.search(qs, K, NPROBE)
        same_result(f"{what}: tiered search", tres,
                    index.search(qs, K, NPROBE))
        ops_out.append({
            "op": what,
            "reports": [{"kind": r.kind, "lists": list(r.lists),
                         "rows": r.rows, "committed": r.committed}
                        for r in reps],
            "ms": index.last_maintain_ms, "tiered_ms":
            tindex.last_maintain_ms,
            "recall_at_10": recall(torch, index.search(
                queries, K, NPROBE).labels, best)})

    for sweep in range(MAINT_SWEEPS):
        reps = index.maintain(max_ops=2)
        after_op(f"sweep {sweep}", reps, tindex.maintain(max_ops=2))
    occ = np.asarray(index.stats()["list_occupancy"])
    order = np.argsort(occ, kind="stable")
    hot, cold = int(order[-1]), int(order[0])
    small = [int(i) for i in order if occ[i] > 0 and i not in (hot, cold)]
    mid = int(order[len(order) // 2])
    explicit = [sivf_torch.split(hot, cold), sivf_torch.merge(*small[:2]),
                sivf_torch.recluster(mid)]
    chosen = {"split": [hot, cold], "merge": small[:2], "recluster": [mid],
              "occupancy": {str(i): int(occ[i])
                            for i in (hot, cold, *small[:2], mid)}}
    for op in explicit:
        reps = index.maintain([op], strict=True)
        after_op(f"{op.kind} {list(op.lists)}", reps,
                 tindex.maintain([op], strict=True))
    n = launches.n
    check(n["fused"] > 0 and n["fused_grouped"] == n["fused"]
          and n["fused_per_query"] == 0,
          f"maintain: tiered launches by route {n}")
    return [{"phase": "maintain", "live_rows": int(ids0.size),
             "explicit_lists": chosen, "recall_at_10_before": recall0,
             "recall_at_10_after": ops_out[-1]["recall_at_10"],
             "ops": ops_out, "tiered_launches": n,
             "epoch": index.epoch, "tiered_epoch": tindex.epoch}], []


def phase_pq_lifecycle(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The PQ index saved and loaded back (``persist_check``), then
    loaded tiered for one Q=64 batch ``==`` the all-resident index on
    kernel 2's compacted route."""
    import sivf_torch
    index, queries = main["index"], main["queries"]
    line, ckpt = persist_check(torch, index, queries, "pq")
    main["ckpt"] = ckpt                 # the serve phase loads it
    tindex = sivf_torch.Index.load(ckpt, device="cuda",
                                   device_slabs=DEVICE_SLABS)
    qs = queries[:TIERED_Q]
    launches = Launches()
    with launches.of():
        res, ms = timed(lambda: tindex.search(qs, K, NPROBE))
    same_result("pq tiered", res, index.search(qs, K, NPROBE))
    n = launches.n
    check(n["pq"] == 1 and n["pq_compacted"] == 1 and n["fused"] == 0,
          f"pq tiered launches by route {n}: kernel 2 takes compacted")
    st = tindex.stats()
    return [line, {"phase": "pq.tiered", "device_slabs": DEVICE_SLABS,
                   "queries": TIERED_Q, "nprobe": NPROBE, "cold_ms": ms,
                   "unique_slabs": tindex._tiered.last_prefetch["unique"],
                   "cache_uploads": st["cache_uploads"],
                   "h2d_bytes": tindex._tiered.h2d_bytes,
                   "device_bytes": st["device_bytes"],
                   "launches": n}], []


# ---------------------------------------------------------------------------
# The serve engine (sivf_torch.ServeEngine) on the raw and PQ checkpoints
# ---------------------------------------------------------------------------

SERVE_TENANT = "t7"                     # its mandatory filter: tenant == 7
SERVE_COALESCE = {"raw": (64, 16, 4), "pq": (32, 16, 2),    # app, t7, Q=16
                  "mesh": (64, 16, 4)}
PREFIX_BATCHES, PREFIX_ROWS = 32, 4096
LOAD_RATES = (1000, 4000, 16000)        # open-loop searches a second
LOAD_HALF_S = 2.0                       # each rate: idle, then active
LOAD_PROFILE_S = 1.0                    # one profiled active second
LOAD_BATCH, LOAD_ROWS_PER_S = 1024, 50_000   # ingest, each way
SERVE_DEVICE_SLABS = 2048
SERVE_TILED_CYCLES = 3
SERVE_STAGES = ("serve.tile", "serve.queue", "serve.mutation_queue",
                "index.search", "mutation.dispatch", "mutation.flush",
                "plan", "prefetch", "scan")
SERVE_LAUNCHES: dict = {}    # kernels 1 / 1f / 2 / 2f: serve launches by route


def serve_counts() -> dict:
    """Kernels 1 and 2's launch counters, filtered apart, by route."""
    from repro_torch.kernels.sivf_scan import fused, pq_fused
    return {"sivf_fused_search": fused.launches,
            "sivf_fused_search[filtered]": fused.filtered_launches,
            "sivf_fused_search.grouped": fused.launches_grouped,
            "sivf_fused_search.per_query": fused.launches_per_query,
            "sivf_pq_fused_search": pq_fused.launches,
            "sivf_pq_fused_search[filtered]": pq_fused.filtered_launches,
            "sivf_pq_fused_search.compacted": pq_fused.launches_compacted,
            "sivf_pq_fused_search.per_query": pq_fused.launches_per_query}


def serve_engine(index, **kw):
    """The smoke's engine over ``index``: k=10, nprobe 32, tiles up to 256
    rows, the ``t7`` tenant pinned to tenant 7, 1,024 searches in flight
    a tenant, the perf_counter clock."""
    import sivf_torch
    kw = {"default_k": K, "default_nprobe": NPROBE, "max_coalesce": 256,
          "tenant_filters": {SERVE_TENANT: sivf_torch.Eq("tenant", 7)},
          "quota": sivf_torch.TenantQuota(max_inflight_searches=1024),
          "clock": time.perf_counter, **kw}
    return sivf_torch.ServeEngine(index, **kw)


def load_served(torch, ckpt, tel=None, **kw):
    """The checkpoint on the card, as the engine needs it."""
    import sivf_torch
    index = sivf_torch.Index.load(ckpt, device="cuda", deferred=True,
                                  strict=False, telemetry=tel, **kw)
    torch.cuda.synchronize()
    return index


def host(t) -> np.ndarray:
    return t.cpu().numpy()


def plain_search(torch, index, qs: np.ndarray, k: int, cf=None):
    """``Index.search`` of ``qs`` by its own steps on the card index's
    planes (the bucket's zero rows, the probe, the slab tables, the PQ
    path's ADC table), with the scan taken by kernel 1's or 2's plain
    version in place of the kernel: (distances, labels) of ``qs``'s rows.
    On a mesh each shard is searched so and the partials, in shard order,
    merged by kernel 4's plain version (``topk_ref``)."""
    from repro_torch.kernels.topk.ref import topk_ref
    q = index._pad_rows(qs, index._bucket(len(qs))).to(index.cfg.dtype)
    if index.backend != "mesh":
        d, lab = plain_shard_search(torch, index, index.state, q, k, cf)
    else:
        parts = [plain_shard_search(torch, index, st, q, k, cf)
                 for st in index.state.shards]
        d, lab = topk_ref(torch.cat([p[0] for p in parts], 1),
                          torch.cat([p[1] for p in parts], 1), k)
    return d[:len(qs)], lab[:len(qs)]


def plain_shard_search(torch, index, st, q, k: int, cf=None):
    """:func:`plain_search`'s steps on one pool ``st`` (padded ``q``)."""
    from repro_torch.core import index as ix
    from repro_torch.core import pq, quantizer
    from repro_torch.kernels.sivf_scan.ref import (
        sivf_fused_search_ref, sivf_pq_fused_search_ref,
    )
    cfg = index.cfg
    lists = quantizer.probe(st.centroids, q, NPROBE, cfg.metric)
    ut = cfg.track_tables if index._use_tables is None \
        else index._use_tables
    table = (ix.gather_tables if ut else ix.walk_chains)(cfg, st, lists)
    filt = {} if cf is None else dict(
        attrs=st.attrs, fstruct=cf.structure,
        fconsts=torch.tensor(cf.consts, dtype=torch.int32, device=q.device))
    if cfg.pq is not None:
        adc = pq.adc_tables(st.pq_codebooks, q, cfg.metric)
        d, lab = sivf_pq_fused_search_ref(adc, table, st.codes, st.ids,
                                          st.bitmap, k, **filt)
    else:
        d, lab = sivf_fused_search_ref(q.to(torch.float32), table, st.data,
                                       st.ids, st.norms, st.bitmap, k,
                                       cfg.metric, **filt)
    return d, lab


def coalesce_check(torch, index, queries, attrs_h, path: str,
                   launches) -> dict:
    """Searches queued while the engine is paused — single queries from
    ``app``, single queries from ``t7``, Q = 16 batches at k = 5 — then
    released at once: the engine coalesces them into one tile per (k,
    filter) group, and each result is ``==`` its rows of one direct
    ``Index.search`` of the tile's queries at the same epoch, which is
    ``==`` the plain version's search of those queries (kernel 1's or
    2's shapes on this path: 64-row buckets, k 10 and 5, a filter)."""
    import sivf_torch
    from repro_torch.core.filters import compile_filter
    n_app, n_t7, n_16 = SERVE_COALESCE[path]
    qh = host(queries)
    groups = {"app": [qh[i:i + 1] for i in range(n_app)],
              "t7": [qh[n_app + i:n_app + i + 1] for i in range(n_t7)],
              "k5": [qh[n_app + n_t7 + 16 * i:n_app + n_t7 + 16 * (i + 1)]
                     for i in range(n_16)]}
    eng = serve_engine(index)
    try:
        eng.pause()
        futs = {"app": [eng.session("app").search(q) for q in groups["app"]],
                "t7": [eng.session(SERVE_TENANT).search(q)
                       for q in groups["t7"]],
                "k5": [eng.session("app").search(q, k=5)
                       for q in groups["k5"]]}
        t0 = time.perf_counter()
        with launches.of():
            eng.resume()
            res = {g: [f.result(120) for f in fs] for g, fs in futs.items()}
        cycle_ms = (time.perf_counter() - t0) * 1e3
        st = eng.stats()
    finally:
        eng.close()
    epoch = index.epoch
    cf = compile_filter(sivf_torch.Eq("tenant", 7), ATTRS)
    per_group, plain_err = {}, 0.0
    for g, rs in res.items():
        k = 5 if g == "k5" else K
        qs = np.concatenate(groups[g])
        gf = cf if g == "t7" else None
        want = index.search(qs, k, NPROBE, filter=gf)
        plain_err = max(plain_err, check_equal(
            f"{path} serve.coalesce {g}: the tile's search vs the plain "
            f"version", want.distances, want.labels,
            *plain_search(torch, index, qs, k, gf)))
        wd, wl_ = host(want.distances), host(want.labels)
        off = 0
        for q, r in zip(groups[g], rs):
            n = q.shape[0]
            check(np.array_equal(r.labels, wl_[off:off + n])
                  and np.array_equal(r.distances.view(np.int32),
                                     wd[off:off + n].view(np.int32)),
                  f"{path} serve.coalesce {g}: a result differs from the "
                  f"direct search of its tile")
            check(r.coalesced == qs.shape[0] and r.epoch == epoch
                  and r.padded_to == want.padded_to and r.k == k,
                  f"{path} serve.coalesce {g}: provenance {r.coalesced} "
                  f"{r.epoch} {r.padded_to}")
            off += n
        if g == "t7":
            lab = wl_[wl_ >= 0]
            check(bool((attrs_h[lab, 0] == 7).all()),
                  f"{path} serve.coalesce: a t7 label is not tenant 7")
        per_group[g] = {"requests": len(rs), "rows": int(qs.shape[0]),
                        "padded_to": rs[0].padded_to,
                        "service_ms": rs[0].service_s * 1e3,
                        "queue_ms_max": max(r.queue_s for r in rs) * 1e3}
    check(st["search_tiles"] == 3 and st["prefetch_errors"] == 0,
          f"{path} serve.coalesce: {st['search_tiles']} tiles, "
          f"{st['prefetch_errors']} prefetch errors")
    return {"phase": "serve.coalesce", "path": path, "epoch": epoch,
            "tiles": st["search_tiles"], "groups": per_group,
            "cycle_ms": cycle_ms, "results_equal_direct_search": True,
            "direct_search_equal_plain": True, "max_abs_err": plain_err}


def phase_serve_coalesce(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The raw checkpoint loaded for the engine; the coalescing check."""
    from repro_torch.obs import Telemetry
    zero_counts()                       # the serve phases' launches
    tel = Telemetry(enabled=True)
    t0 = time.perf_counter()
    index = load_served(torch, main["ckpt"], tel)
    load_ms = (time.perf_counter() - t0) * 1e3
    launches = Launches(serve_counts)
    main["serve"] = {"index": index, "tel": tel, "launches": launches}
    line = coalesce_check(torch, index, main["queries"],
                          main["wl"]["attrs_h"], "raw", launches)
    line["load_ms"] = load_ms
    return [line], []


def phase_serve_prefix(torch, hbm: float, main: dict) -> tuple[list, list]:
    """A writer streams PREFIX_BATCHES batches — each an add of
    PREFIX_ROWS new planted ids and a remove of PREFIX_ROWS old ids —
    while a reader searches planted vectors: a result stamped epoch ``e``
    finds its planted id at rank 0 exactly when the id's add is within
    the first ``e`` mutations, and never returns an id added later or one
    removed within them."""
    import threading
    s = main["serve"]
    index, launches = s["index"], s["launches"]
    wl = main["wl"]
    rng = np.random.default_rng(wl["seed"] + 23)
    n_new = PREFIX_BATCHES * PREFIX_ROWS
    base = host(wl["base"][torch.from_numpy(
        rng.choice(N_BASE, n_new)).cuda()])
    planted = base + rng.normal(scale=0.5, size=base.shape).astype(
        np.float32)
    new_ids = np.arange(N_BASE, N_BASE + n_new, dtype=np.int32)
    new_attrs = np.stack([rng.integers(0, N_TENANTS, n_new),
                          rng.integers(0, N_TS, n_new)], 1).astype(np.int32)
    live0 = host(torch.nonzero(index.state.att_slab >= 0).reshape(-1))
    old_ids = rng.choice(live0, n_new, replace=False).astype(np.int32)
    n_live0 = index.n_live
    # the epoch each id enters / leaves at: add b -> 2b + 1, remove b -> 2b + 2
    e0 = index.epoch
    add_epoch = np.zeros(index.cfg.n_max, np.int64)    # live from the start
    rm_epoch = np.full(index.cfg.n_max, np.iinfo(np.int32).max, np.int64)
    for b in range(PREFIX_BATCHES):
        sl = slice(b * PREFIX_ROWS, (b + 1) * PREFIX_ROWS)
        add_epoch[new_ids[sl]] = e0 + 2 * b + 1
        rm_epoch[old_ids[sl]] = e0 + 2 * b + 2
    eng = serve_engine(index)
    reads, stop = [], threading.Event()
    writer, reader = eng.session("ingest"), eng.session("app")

    def search_planted():
        r = np.random.default_rng(wl["seed"] + 29)
        while not stop.is_set():
            i = int(r.integers(n_new))
            reads.append((i, reader.search(planted[i:i + 1])))
            time.sleep(0.0002)

    t0 = time.perf_counter()
    try:
        with launches.of():
            th = threading.Thread(target=search_planted)
            th.start()
            muts = []
            for b in range(PREFIX_BATCHES):
                sl = slice(b * PREFIX_ROWS, (b + 1) * PREFIX_ROWS)
                muts.append(writer.add(planted[sl], new_ids[sl],
                                       attrs=new_attrs[sl]))
                muts.append(writer.remove(old_ids[sl]))
                time.sleep(0.02)
            stop.set()
            th.join()
            reps = [f.result(120) for f in muts]
            results = [(i, f.result(120)) for i, f in reads]
        wall_ms = (time.perf_counter() - t0) * 1e3
        st = eng.stats()
    finally:
        eng.close()
    check([r.epoch for r in reps] == list(range(e0 + 1, e0 + 2 * PREFIX_BATCHES
                                                + 1)),
          "serve.prefix: the batches did not resolve at consecutive epochs")
    check(all(r.ok and r.report.accepted == PREFIX_ROWS for r in reps),
          "serve.prefix: a batch was not applied whole")
    check(index.n_live == n_live0,
          f"serve.prefix: n_live {index.n_live} != {n_live0}")
    found = absent = 0
    epochs = set()
    for i, r in results:
        e = r.epoch
        epochs.add(e)
        present = int(r.labels[0, 0]) == int(new_ids[i])
        check(present == (add_epoch[new_ids[i]] <= e),
              f"serve.prefix: planted id {new_ids[i]} present={present} "
              f"at epoch {e}")
        found += present
        absent += not present
        lab = r.labels[0][r.labels[0] >= 0].astype(np.int64)
        check(bool((add_epoch[lab] <= e).all()
                   and (rm_epoch[lab] > e).all()),
              f"serve.prefix: epoch {e} returned an id outside its prefix")
    check(found > 0 and absent > 0, "serve.prefix: the oracle saw one side")
    return [{"phase": "serve.prefix", "batches": PREFIX_BATCHES,
             "rows_each_way": PREFIX_ROWS,
             "mutation_epochs": [e0 + 1, e0 + 2 * PREFIX_BATCHES],
             "searches": len(results), "found": found, "absent": absent,
             "distinct_epochs_read": len(epochs), "n_live": index.n_live,
             "wall_ms": wall_ms, "flushes": st["flushes"],
             "tiles": st["search_tiles"], "oracle_held": True}], []


def idle_share(torch, during) -> dict:
    """The device's busy and idle shares while ``during()`` runs
    (``torch.profiler``: the union of the device's kernel and copy
    intervals over the wall time). ``during`` must leave no other thread
    issuing work on the card when it returns: the profiler starts and
    stops with the card quiet (a stop while another thread launched work
    has crashed the process)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        during()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"device_events": len(spans),
            "busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3,
            "idle_share": (1 - busy / wall_us) if spans else None}


def open_loop(eng, rate: float, seconds: float, qh, ingest=None) -> dict:
    """Single-query searches at ``rate`` a second for ``seconds``, each
    submitted at its scheduled time whatever the earlier ones' fate (open
    loop), and, with ``ingest``, paced add and remove batches beside them.
    Latency runs from the scheduled arrival to the results on the host:
    (submit - schedule) + queue_s + service_s. The achieved rates count
    what resolved over the time from the first scheduled arrival to the
    last result's (a search's, or a mutation's acknowledgement), so a
    generator or an engine that falls behind shows below the offered
    rate."""
    import threading

    from repro_torch.serve.quota import Backpressure
    sess = eng.session("app")
    subs, rejected = [], [0]
    n = int(rate * seconds)
    t_start = time.perf_counter() + 0.005

    def searches():
        for i in range(n):
            ts = t_start + i / rate
            wait = ts - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            tc = time.perf_counter()
            try:
                subs.append((ts, tc, sess.search(qh[i % len(qh)])))
            except Backpressure:
                rejected[0] += 1

    muts = []

    def mutations():
        add, remove, every = ingest
        w = eng.session("ingest")
        for j in range(int(seconds * LOAD_ROWS_PER_S / LOAD_BATCH)):
            wait = t_start + j * every - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            vecs, ids, attrs = add(j)
            muts.append((time.perf_counter(),
                         w.add(vecs, ids, attrs=attrs)))
            muts.append((time.perf_counter(), w.remove(remove(j))))

    threads = [threading.Thread(target=searches)]
    if ingest is not None:
        threads.append(threading.Thread(target=mutations))
    st0 = eng.stats()
    n_sizes = len(eng._coalesce_sizes)
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results = [(ts, tc, f.result(120)) for ts, tc, f in subs]
    reps = [(tc, f.result(120)) for tc, f in muts]
    st1 = eng.stats()
    lat = [tc - ts + r.queue_s + r.service_s for ts, tc, r in results]
    search_end = max((ts + x for (ts, _, _), x in zip(results, lat)),
                     default=t_start)
    mut_end = max((tc + r.queue_s for tc, r in reps), default=t_start)
    from repro_torch.obs import latency_summary_ms, percentiles
    sizes = eng._coalesce_sizes[n_sizes:]
    qd = percentiles([r.queue_s for _, _, r in results], (50.0, 99.0))
    sv = percentiles([r.service_s for _, _, r in results], (50.0, 99.0))
    late = percentiles([tc - ts for ts, tc, _ in results], (50.0, 99.0))
    return {"rate": rate, "searches": len(results),
            "rejected": rejected[0],
            "offered_qps": rate,
            "qps": len(results) / (search_end - t_start)
            if results else 0.0,
            "last_result_after_s": search_end - t_start,
            **latency_summary_ms(lat, round_to=6),
            "queue_ms_p50_p99": [qd[50.0] * 1e3, qd[99.0] * 1e3],
            "service_ms_p50_p99": [sv[50.0] * 1e3, sv[99.0] * 1e3],
            "submit_late_ms_p50_p99": [late[50.0] * 1e3, late[99.0] * 1e3],
            "tiles": len(sizes),
            "tile_rows_median": float(np.median(sizes)) if sizes else 0.0,
            "tile_rows_max": max(sizes, default=0),
            "flushes": st1["flushes"] - st0["flushes"],
            "mutation_batches": len(reps),
            "mutation_rows_per_s": sum(r.report.requested for _, r in reps)
            / (mut_end - t_start) if reps else 0.0,
            "mutations_ok": all(r.ok for _, r in reps)}


def phase_serve_load(torch, hbm: float, main: dict) -> tuple[list, list]:
    """Open-loop single-query searches at LOAD_RATES, each rate for
    LOAD_HALF_S idle and LOAD_HALF_S with the ``ingest`` tenant streaming
    LOAD_BATCH-row add and remove batches at LOAD_ROWS_PER_S rows a
    second each way (the live set stays put), then one profiled active
    second; the middle rate once more with the telemetry off. A reading:
    the reference's bound p99(active) <= 5 x p99(idle) is reported, not
    enforced."""
    import threading
    s = main["serve"]
    index, tel, launches = s["index"], s["tel"], s["launches"]
    wl = main["wl"]
    rng = np.random.default_rng(wl["seed"] + 31)
    qh = host(main["queries"])
    n_b = int((LOAD_HALF_S + LOAD_PROFILE_S) * LOAD_ROWS_PER_S / LOAD_BATCH)
    pool = host(wl["base"][torch.from_numpy(
        rng.choice(N_BASE, n_b * LOAD_BATCH)).cuda()]) + rng.normal(
        scale=0.5, size=(n_b * LOAD_BATCH, DIM)).astype(np.float32)
    pool_attrs = np.stack([rng.integers(0, N_TENANTS, len(pool)),
                           rng.integers(0, N_TS, len(pool))],
                          1).astype(np.int32)
    live = host(torch.nonzero(index.state.att_slab >= 0).reshape(-1))
    live = rng.permutation(live).astype(np.int32)
    victims = iter(live[:len(live) // LOAD_BATCH * LOAD_BATCH].reshape(
        -1, LOAD_BATCH))
    next_id = [N_BASE + PREFIX_BATCHES * PREFIX_ROWS]
    lock = threading.Lock()

    def add(j):
        with lock:
            ids = np.arange(next_id[0], next_id[0] + LOAD_BATCH,
                            dtype=np.int32)
            next_id[0] += LOAD_BATCH
        sl = slice((j % n_b) * LOAD_BATCH, (j % n_b + 1) * LOAD_BATCH)
        return pool[sl], ids, pool_attrs[sl]

    def remove(j):
        with lock:
            return next(victims)

    ingest = (add, remove, LOAD_BATCH / LOAD_ROWS_PER_S)
    from repro_torch.serve.quota import TenantQuota
    wide = TenantQuota(max_inflight_searches=1 << 20)
    eng = serve_engine(index, quotas={"app": wide}, max_queue=1 << 20)
    runs = []
    n_live0 = index.n_live
    idle_share(torch, lambda: time.sleep(0.01))   # a slow first start
    try:
        with launches.of():
            eng.session("app").search(qh[:1]).result(120)   # warm
            for rate, enabled in [(r, True) for r in LOAD_RATES] + [
                    (LOAD_RATES[len(LOAD_RATES) // 2], False)]:
                tel.enabled = enabled
                idle = open_loop(eng, rate, LOAD_HALF_S, qh)
                active = open_loop(eng, rate, LOAD_HALF_S, qh, ingest)
                prof = {}
                if enabled:     # profiled from the run's first submission
                    # to its last result: the card is quiet at both ends
                    share = idle_share(torch, lambda: prof.update(
                        open_loop(eng, rate, LOAD_PROFILE_S, qh, ingest)))
                    prof = {"idle_share": share["idle_share"],
                            "busy_ms": share["busy_ms"],
                            "wall_ms": share["wall_ms"],
                            "device_events": share["device_events"],
                            "p99_ms": prof["p99_ms"]}
                runs.append({"rate": rate, "telemetry": enabled,
                             "idle": idle, "active": active,
                             "profiled_active_second": prof or None,
                             "p99_active_le_5x_idle":
                                 active["p99_ms"] <= 5 * idle["p99_ms"]})
        st = eng.stats()
    finally:
        tel.enabled = True
        eng.close()
    check(all(r["active"]["mutations_ok"] for r in runs),
          "serve.load: a mutation batch failed")
    check(index.n_live == n_live0,
          f"serve.load: the live set moved {n_live0} -> {index.n_live}")
    check(st["prefetch_errors"] == 0, "serve.load: prefetch errors")
    mid = [r for r in runs if r["rate"] == LOAD_RATES[len(LOAD_RATES) // 2]]
    overhead = {half: {f"{p}_ms": [m[half][f"{p}_ms"] for m in mid]
                       for p in ("p50", "p99")} for half in ("idle", "active")}
    return [{"phase": "serve.load", "rates": list(LOAD_RATES),
             "half_s": LOAD_HALF_S, "ingest_rows_per_s_each_way":
             LOAD_ROWS_PER_S, "ingest_batch": LOAD_BATCH,
             "n_live": index.n_live, "runs": runs,
             "telemetry_on_off_at_middle_rate": overhead,
             "rejections": st["rejections"]}], []


def copy_overlaps_scan(torch, fn) -> dict:
    """``fn()`` under ``torch.profiler``: the host-to-device copies, the
    scan kernels (kernel 1's and 2's), and the device time where a copy
    and a scan ran at once."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    copies = [(e.time_range.start, e.time_range.end) for e in dev
              if "HtoD" in e.name or "Memcpy H" in e.name]
    scans = [(e.time_range.start, e.time_range.end) for e in dev
             if "scan_kernel" in e.name or "fused_search_kernel" in e.name
             or "merge_kernel" in e.name]
    both = sum(max(0.0, min(b, d) - max(a, c))
               for a, b in copies for c, d in scans)
    return out, {"copies": len(copies),
                 "copy_ms": sum(b - a for a, b in copies) / 1e3,
                 "scan_kernels": len(scans),
                 "scan_ms": sum(b - a for a, b in scans) / 1e3,
                 "overlap_ms": both / 1e3, "overlapped": both > 0}


def tiered_requests(qh, cycle: int) -> list:
    """Eight tiles' worth of requests, one tile per (k, filter) group: 16
    requests of four queries each, a different 64 queries per group."""
    import sivf_torch
    preds = [None, sivf_torch.In("tenant", tuple(range(10))), None,
             sivf_torch.Range("ts", 0, 500), None, sivf_torch.Eq("tenant", 7),
             None, sivf_torch.In("tenant", tuple(range(10)))]
    ks = (10, 10, 5, 5, 20, 20, 1, 1)
    out = []
    for g, (k, pred) in enumerate(zip(ks, preds)):
        q0 = (64 * (g + 8 * cycle)) % len(qh)
        for i in range(16):
            out.append((qh[q0 + 4 * i:q0 + 4 * (i + 1)], k, pred))
    return out


def phase_serve_tiered(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The raw checkpoint loaded tiered with SERVE_DEVICE_SLABS frames
    (about 1.5 tiles' slabs) and all-resident, an engine over each; the
    same paused cycles of eight tiles, an overwrite and a remove through
    both: every result ``==``, evictions between tiles. In the first
    cycle each all-resident tile is also held ``==`` the plain version's
    search of its queries (kernels 1 and 1f at k 1, 5, 10 and 20 under
    In / Range / Eq)."""
    from repro_torch.core.filters import compile_filter
    s = main["serve"]
    tel, launches = s["tel"], s["launches"]
    wl = main["wl"]
    qh = host(main["queries"])
    tindex = load_served(torch, main["ckpt"], tel,
                         device_slabs=SERVE_DEVICE_SLABS)
    findex = load_served(torch, main["ckpt"])
    rt = tindex._tiered
    engines = (serve_engine(findex), serve_engine(tindex))
    rng = np.random.default_rng(wl["seed"] + 37)
    live = host(torch.nonzero(findex.state.att_slab >= 0).reshape(-1))
    pick = rng.choice(live, 2 * 4096, replace=False).astype(np.int32)
    ow_ids, rm_ids = pick[:4096], pick[4096:]
    ow_vecs = host(wl["cur"][torch.from_numpy(ow_ids).cuda().long()]) + 0.02
    ow_attrs = wl["attrs_h"][ow_ids]
    cycles, plain = [], {"tiles": 0, "max_abs_err": 0.0}
    try:
        for c in range(SERVE_TILED_CYCLES):
            reqs = tiered_requests(qh, c)
            got = []
            for eng in engines:
                tiered = eng.index is tindex
                ev0, up0, b0 = (rt.evictions.total, rt.h2d_copies,
                                rt.h2d_bytes)
                eng.pause()
                futs = [eng.session("app").search(q, k=k, filter=pred)
                        for q, k, pred in reqs]
                muts = []
                if c == 1:              # an overwrite and a remove
                    w = eng.session("ingest")
                    muts = [w.add(ow_vecs, ow_ids, attrs=ow_attrs),
                            w.remove(rm_ids)]

                def run():
                    eng.resume()
                    return ([f.result(120) for f in futs],
                            [f.result(120) for f in muts])

                t0 = time.perf_counter()
                if tiered:
                    with launches.of():
                        if c == 2:
                            (res, reps), overlap = copy_overlaps_scan(
                                torch, run)
                        else:
                            res, reps = run()
                    cyc = {"cycle": c,
                           "ms": (time.perf_counter() - t0) * 1e3,
                           "evictions": rt.evictions.total - ev0,
                           "uploads": rt.h2d_copies - up0,
                           "upload_bytes": rt.h2d_bytes - b0}
                    if c == 2:
                        cyc["copy_vs_scan"] = overlap
                else:
                    res, reps = run()
                    cyc_full_ms = (time.perf_counter() - t0) * 1e3
                got.append((res, reps))
            (fres, freps), (tres, treps) = got
            for a, b in zip(fres, tres):
                check(np.array_equal(a.labels, b.labels)
                      and np.array_equal(a.distances.view(np.int32),
                                         b.distances.view(np.int32))
                      and (a.epoch, a.coalesced, a.padded_to)
                      == (b.epoch, b.coalesced, b.padded_to),
                      f"serve.tiered cycle {c}: results differ")
            for a, b in zip(freps, treps):
                check(a.ok and b.ok and dataclasses.astuple(a.report)
                      == dataclasses.astuple(b.report),
                      f"serve.tiered cycle {c}: mutation reports differ")
            if c == 0:                  # each tile against the plain version
                for g in range(0, len(reqs), 16):
                    _, k, pred = reqs[g]
                    cf = None if pred is None else compile_filter(pred, ATTRS)
                    tile = fres[g:g + 16]
                    dp, lp = plain_search(torch, findex, np.concatenate(
                        [q for q, _, _ in reqs[g:g + 16]]), k, cf)
                    plain["max_abs_err"] = max(plain["max_abs_err"],
                                               check_equal(
                        f"serve.tiered tile k={k} filter={pred}: the "
                        f"served results vs the plain version",
                        torch.from_numpy(np.concatenate(
                            [r.distances for r in tile])),
                        torch.from_numpy(np.concatenate(
                            [r.labels for r in tile])), dp, lp))
                    plain["tiles"] += 1
            check(cyc["evictions"] > 0,
                  f"serve.tiered cycle {c}: no eviction between tiles")
            cyc["all_resident_ms"] = cyc_full_ms
            cycles.append(cyc)
        st = engines[1].stats()
    finally:
        for eng in engines:
            eng.close()
    check(st["prefetch_errors"] == 0,
          f"serve.tiered: {st['prefetch_errors']} swallowed prefetch errors")
    s["tindex"] = tindex
    del findex
    return [{"phase": "serve.tiered", "device_slabs": SERVE_DEVICE_SLABS,
             "tiles_per_cycle": 8, "rows_per_tile": 64, "nprobe": NPROBE,
             "cycles": cycles, "results_equal_all_resident": True,
             "cycle0_tiles_equal_plain": plain["tiles"],
             "max_abs_err": plain["max_abs_err"],
             "prefetch_errors": st["prefetch_errors"],
             "cache": {k: tindex.stats()[k] for k in (
                 "cache_hits", "cache_misses", "cache_uploads",
                 "cache_evictions", "hit_rate")}}], []


def phase_serve_telemetry(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The serve phases' registry: stage percentiles, the Prometheus text
    held against the snapshot series by series, the cache-event counters
    against the tiered index's stats(); then the serve launches of kernel
    1 by route."""
    from repro_torch.obs import parse_prometheus
    s = main.pop("serve")
    tel, tindex = s["tel"], s["tindex"]
    snap = tel.snapshot()
    text = tel.render_prometheus()
    series = parse_prometheus(text)
    stages = {x["labels"]["stage"]: x for x in
              snap["metrics"]["sivf_stage_seconds"]["series"]}
    missing = [n for n in SERVE_STAGES if n not in stages]
    check(not missing, f"serve.telemetry: no spans of {missing}")
    n_series = 0
    for name, fam in snap["metrics"].items():
        for x in fam["series"]:
            lab = ",".join(f'{k}="{v}"' for k, v in x["labels"].items())
            lab = "{" + lab + "}" if lab else ""
            if fam["kind"] == "histogram":
                want = {f"{name}_count{lab}": x["count"],
                        f"{name}_sum{lab}": x["sum"]}
            elif fam["kind"] == "counter":
                want = {f"{name}{lab}": x["total"],
                        f"{name}_window{lab}": x["window"]}
            else:
                want = {f"{name}{lab}": x["value"]}
            for key, v in want.items():
                check(key in series and series[key] == v,
                      f"serve.telemetry: {key} {series.get(key)} != {v}")
                n_series += 1
    ev = {x["labels"]["event"]: x["total"] for x in
          snap["metrics"]["sivf_tiered_cache_events_total"]["series"]}
    st = tindex.stats()
    for event, key in (("hit", "cache_hits"), ("miss", "cache_misses"),
                       ("upload", "cache_uploads"),
                       ("eviction", "cache_evictions")):
        check(ev.get(event) == st[key],
              f"serve.telemetry: {event} counter {ev.get(event)} != "
              f"stats {st[key]}")
    n = s["launches"].n
    n1, n1f = n["sivf_fused_search"], n["sivf_fused_search[filtered]"]
    check(n1 > 0 and n1f > 0 and n["sivf_fused_search.grouped"] == n1 + n1f
          and n["sivf_fused_search.per_query"] == 0
          and n["sivf_pq_fused_search"] + n["sivf_pq_fused_search[filtered]"]
          == 0, f"serve launches by route {n}: kernel 1 takes grouped")
    SERVE_LAUNCHES["sivf_fused_search"] = {"grouped": n1, "per_query": 0}
    SERVE_LAUNCHES["sivf_fused_search[filtered]"] = {"grouped": n1f,
                                                     "per_query": 0}
    ms = {name: {"count": stages[name]["count"],
                 "p50_ms_est": stages[name]["p50_est"] * 1e3,
                 "p99_ms_est": stages[name]["p99_est"] * 1e3,
                 "mean_ms": stages[name]["sum"] / stages[name]["count"] * 1e3}
          for name in SERVE_STAGES}
    return [{"phase": "serve.telemetry", "stages": ms,
             "prometheus_series_equal_snapshot": n_series,
             "cache_events": ev, "cache_events_equal_stats": True,
             "slow_queries": len(snap["slow_queries"]),
             "serve_launches": n, "counts_since_zero": read_counts()}], []


def phase_pq_serve(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The PQ checkpoint loaded for the engine: a short coalescing burst
    whose tiles take kernel 2 (unfiltered and filtered) on ``compacted``."""
    zero_counts()
    index = load_served(torch, main["ckpt"])
    launches = Launches(serve_counts)
    line = coalesce_check(torch, index, main["queries"],
                          main["wl"]["attrs_h"], "pq", launches)
    n = launches.n
    n2, n2f = n["sivf_pq_fused_search"], n["sivf_pq_fused_search[filtered]"]
    check(n2 > 0 and n2f > 0 and n["sivf_pq_fused_search.compacted"]
          == n2 + n2f and n["sivf_pq_fused_search.per_query"] == 0
          and n["sivf_fused_search"] + n["sivf_fused_search[filtered]"] == 0,
          f"pq serve launches by route {n}: kernel 2 takes compacted")
    SERVE_LAUNCHES["sivf_pq_fused_search"] = {"compacted": n2,
                                              "per_query": 0}
    SERVE_LAUNCHES["sivf_pq_fused_search[filtered]"] = {"compacted": n2f,
                                                        "per_query": 0}
    line["launches"] = n
    return [line], []


# ---------------------------------------------------------------------------
# The sharded index (core/distributed.py) on virtual shards of one card
# ---------------------------------------------------------------------------

MESH_SHARDS = 4                  # sivf_torch.ShardMesh.virtual(4, "cuda")
MESH_CHAIN = (2, 3, 1)           # Index.reshard steps after the save
MESH_LAUNCHES: dict = {}         # kernels 1 / 1f / 2 / 2f / 4: mesh paths
SYNC_ROWS = 64                   # rows re-added when host syncs are counted


def vmesh(n: int):
    """``n`` virtual shards on the card (``"single"`` for one)."""
    import sivf_torch
    return sivf_torch.ShardMesh.virtual(n, "cuda") if n > 1 else "single"


def mesh_digests(index) -> list:
    """:func:`state_digests` of each shard of ``index`` (one entry for a
    single index)."""
    shards = index.state.shards if index.backend == "mesh" \
        else [index.state]
    return [state_digests(sh) for sh in shards]


def tie_equal(what: str, a, b) -> dict:
    """Two searches of one live set on different layouts (shard counts):
    distances ``==`` bit for bit; labels ``==`` except inside groups of
    equal distances, which hold the same labels (a group that reaches the
    k-th position may hold other tied candidates). Returns the rows whose
    labels differ and the rows whose k-th distance ties the one before."""
    dk, lk = host(a.distances), host(a.labels)
    dp, lp = host(b.distances), host(b.labels)
    check(dk.shape == dp.shape and np.array_equal(dk.view(np.int32),
                                                  dp.view(np.int32)),
          f"{what}: distances differ")
    rows = np.nonzero((lk != lp).any(axis=1))[0]
    for r in rows:
        row = dp[r]
        starts = np.concatenate([[0], np.nonzero(row[1:] != row[:-1])[0]
                                 + 1])
        ends = np.concatenate([starts[1:], [len(row)]])
        for s, e in zip(starts, ends):
            if (lk[r, s:e] == lp[r, s:e]).all():
                continue
            tail = e == len(row)
            check(e - s > 1 and (tail or sorted(lk[r, s:e])
                                 == sorted(lp[r, s:e])),
                  f"{what}: row {r} labels differ outside a tie group")
    return {"rows_labels_differ": int(rows.size),
            "rows_kth_distance_tied": int((dp[:, -1] == dp[:, -2]).sum())}


def count_host_syncs(torch, call) -> dict:
    """Synchronising CUDA calls ``call()`` makes (torch's sync debug mode
    ``"warn"`` warns once at each): their count and their call sites
    (``file:line``, with the count at each)."""
    import collections
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in seen
        if "synchroniz" in str(w.message))
    return {"count": sum(sites.values()), "sites": dict(sites)}


def mesh_launch_checks(path: str, n_kernel: dict, kernel: str,
                       route: str) -> dict:
    """A mesh path's launches: its scan kernel once a shard a batch (all on
    ``route``), kernel 4 (``topk``, route ``warp``) once a batch as the
    cross-shard merge. Records them for the ``kernels`` line."""
    from repro_torch.kernels.topk import topk
    launches = read_counts()
    n_f = len(filters_of())
    n_b = N_SEARCH + n_f
    want = {kernel: MESH_SHARDS * N_SEARCH,
            f"{kernel}[filtered]": MESH_SHARDS * n_f, "topk": n_b}
    got = {k: launches[k] for k in want}
    check(got == want, f"{path}: launches {got}, want {want}")
    check(n_kernel.get(route) == MESH_SHARDS * n_b
          and sum(n_kernel.values()) == MESH_SHARDS * n_b,
          f"{path}: {kernel} launches by route {n_kernel}")
    merge = {"warp": topk.launches_warp, "block": topk.launches_block}
    check(merge == {"warp": n_b, "block": 0},
          f"{path}: merge launches by route {merge}")
    check(launches["reclaim"] > 0, f"{path}: reclaim never launched")
    other = {"sivf_fused_search": "sivf_pq_fused_search",
             "sivf_pq_fused_search": "sivf_fused_search"}[kernel]
    check(launches[other] + launches[f"{other}[filtered]"] == 0,
          f"{path}: {other} ran")
    for name, n in ((kernel, MESH_SHARDS * N_SEARCH),
                    (f"{kernel}[filtered]", MESH_SHARDS * n_f)):
        MESH_LAUNCHES[name] = {route: n}
    prev = MESH_LAUNCHES.get("topk", {"warp": 0, "block": 0})
    MESH_LAUNCHES["topk"] = {r: prev[r] + merge[r] for r in merge}
    return {"launches": launches, "scan_by_route": n_kernel,
            "merge_by_route": merge,
            "per_batch": {kernel: MESH_SHARDS, "topk": 1}}


def mesh_vs_single(mesh_out: dict, single_out: dict, path: str) -> dict:
    """The mesh path's last unfiltered search and its filtered ones
    against the single path's (:func:`tie_equal`)."""
    out = {"unfiltered": tie_equal(f"{path} vs single", mesh_out["result"],
                                   single_out["result"])}
    for name in filters_of():
        out[name] = tie_equal(f"{path}/{name} vs single",
                              mesh_out["filtered"][name],
                              single_out["filtered"][name])
    return out


def tables_equal(what: str, a: dict, b: dict) -> None:
    bad = [k for k in a if a[k].shape != b[k].shape
           or not np.array_equal(a[k], b[k])]
    check(not bad, f"{what}: live-row tables differ in {bad}")


def phase_mesh_main(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The raw path's traffic through ``Index(backend=ShardMesh.virtual(4,
    "cuda"))`` (four virtual shards on the one card): the live-row table
    ``==`` the single index's; searches ``==`` the single path's
    (distances bit for bit, labels but inside ties) and, unfiltered and at
    10 %, ``==`` the plain mesh version on the same card planes (per-shard
    plain search, then ``topk_ref``); recall@10 equal to the single
    path's; launches per batch with their routes; host syncs of an add,
    a remove and a search against the single index's."""
    import sivf_torch
    from repro_torch.core import distributed as dist
    from repro_torch.core.filters import compile_filter
    from repro_torch.kernels.sivf_scan import fused
    wl, single, cfg = main["wl"], main["index"], main["cfg"]
    index = sivf_torch.Index(cfg, wl["cents"], backend=vmesh(MESH_SHARDS))
    out = {}
    zero_counts()                                # counts of this path
    lines = drive(torch, index, wl, "mesh", out)
    launch = mesh_launch_checks("mesh", {
        "grouped": fused.launches_grouped,
        "per_query": fused.launches_per_query}, "sivf_fused_search",
        "grouped")
    t0 = time.perf_counter()
    table = dist.flatten_live_rows(cfg, index.state)
    flatten_ms = (time.perf_counter() - t0) * 1e3
    tables_equal("mesh vs single", table,
                 dist.flatten_live_rows(cfg, single.state))
    vs_single = mesh_vs_single(out, main, "mesh")
    qh = host(wl["queries"])
    cf = compile_filter(filters_of()[REPRESENTATIVE], ATTRS)
    plain_err = 0.0
    for name, f in (("unfiltered", None), (REPRESENTATIVE, cf)):
        res = out["result"] if f is None else out["filtered"][name]
        plain_err = max(plain_err, check_equal(
            f"mesh {name} vs the plain mesh version", res.distances,
            res.labels, *plain_search(torch, index, qh, K, f)))
    rec = {name: recall(torch, r.labels, wl["oracle"]["unfiltered"])
           for name, r in (("mesh", out["result"]),
                           ("single", main["result"]))}
    check(rec["mesh"] == rec["single"], f"mesh recall {rec}")
    # host syncs: the same calls on both handles (a re-add of live rows
    # with their current vectors and attributes changes no live row)
    live = torch.nonzero(~wl["removed"]).reshape(-1)[:SYNC_ROWS]
    vec, at = wl["cur"][live], wl["attrs"][live]
    live = live.to(torch.int32)
    absent = torch.arange(N_BASE, N_BASE + SYNC_ROWS, dtype=torch.int32,
                          device="cuda")
    syncs = {}
    for name, ix_ in (("single", single), ("mesh", index)):
        syncs[name] = {
            "add": count_host_syncs(torch, lambda: ix_.add(vec, live,
                                                           attrs=at)),
            "remove_absent": count_host_syncs(torch,
                                              lambda: ix_.remove(absent)),
            "search": count_host_syncs(torch, lambda: ix_.search(
                wl["queries"], K, NPROBE))}
    for op in ("add", "remove_absent"):
        check(syncs["mesh"][op]["count"] == syncs["single"][op]["count"],
              f"a mesh {op} syncs more often than a single one: {syncs}")
    tables_equal("mesh vs single after the counted calls", table,
                 dist.flatten_live_rows(cfg, index.state))
    by = {ln["phase"]: ln for ln in lines}
    main["mesh"] = index
    lines.append({
        "phase": "mesh.main", "shards": MESH_SHARDS,
        "virtual_shards_on_one_card": True,
        "per_shard_live": index.stats()["per_shard_live"],
        "table_rows": int(table["ids"].size), "table_equal_single": True,
        "flatten_ms": flatten_ms,
        "ingest_rows_per_s": by["mesh.ingest"]["rows_per_s"],
        "remove_ms_per_bucket": by["mesh.remove"]["ms"]
        / len(by["mesh.remove"]["buckets"]),
        "search_ms_median": by["mesh.search"]["ms_median"],
        "vs_single": vs_single, "plain_mesh_version_equal": True,
        "plain_queries": N_QUERIES, "max_abs_err": plain_err,
        "recall_at_10": rec, "host_syncs": syncs, **launch})
    return lines, []


def phase_mesh_lifecycle(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The 4-shard handle saved, loaded onto 4 shards (planes ``==``), the
    live handle resharded 4 -> 2 -> 3 -> 1 (tables and searches ``==``)
    with the checkpoint loaded onto 2 and onto ``"single"`` beside the
    live steps (planes ``==``); back on 4 shards, a split and a merge
    beside the single twin (tables and every shard's centroids ``==``);
    a forced abort on one shard of a small config."""
    import sivf_torch
    from repro_torch.core import distributed as dist
    from repro_torch.core import maintenance as mt
    index, cfg, queries = main["mesh"], main["cfg"], main["queries"]
    want = index.search(queries, K, NPROBE)
    table = dist.flatten_live_rows(cfg, index.state)
    digests = mesh_digests(index)
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="ckpt_mesh_", dir=ROOT / "build"))
    main["mesh_ckpt"] = ckpt
    _, save_ms = timed(lambda: index.save(ckpt))
    served, load4_ms = timed(lambda: sivf_torch.Index.load(
        ckpt, backend=vmesh(MESH_SHARDS), deferred=True, strict=False))
    check(mesh_digests(served) == digests, "mesh load onto 4: planes differ")
    same_result("mesh load onto 4", served.search(queries, K, NPROBE), want)
    main["mesh_served"] = served
    steps, twin = [], None
    for n in MESH_CHAIN:
        _, ms = timed(lambda: index.reshard(vmesh(n)))
        check(index.n_shards == n, f"reshard to {n}")
        tables_equal(f"reshard to {n}", dist.flatten_live_rows(
            cfg, index.state), table)
        res = index.search(queries, K, NPROBE)
        step = {"shards": n, "reshard_ms": ms,
                **tie_equal(f"reshard to {n}", res, want)}
        if n in (2, 1):
            loaded, lms = timed(lambda: sivf_torch.Index.load(
                ckpt, backend=vmesh(n), device="cuda"))
            check(mesh_digests(loaded) == mesh_digests(index),
                  f"checkpoint onto {n}: planes differ from the reshard's")
            same_result(f"checkpoint onto {n}", loaded.search(
                queries, K, NPROBE), res)
            step.update(load_ms=lms, load_planes_equal_reshard=True)
            if n == 1:
                twin = loaded
            del loaded
        steps.append(step)
    _, back_ms = timed(lambda: index.reshard(vmesh(MESH_SHARDS)))
    # a split and a merge on the mesh and on the single twin
    occ = np.asarray(index.stats()["list_occupancy"])
    order = np.argsort(occ, kind="stable")
    hot, cold = int(order[-1]), int(order[0])
    small = [int(i) for i in order if occ[i] > 0 and i not in (hot, cold)]
    ops = [sivf_torch.split(hot, cold), sivf_torch.merge(*small[:2])]
    maint = []
    for op in ops:
        (rm,), ms = timed(lambda: index.maintain([op], strict=True))
        (rs,) = twin.maintain([op], strict=True)
        check(dataclasses.astuple(rm) == dataclasses.astuple(rs),
              f"mesh {op.kind}: reports differ {rm} {rs}")
        tables_equal(f"mesh {op.kind} vs single", dist.flatten_live_rows(
            cfg, index.state), dist.flatten_live_rows(cfg, twin.state))
        for s in range(MESH_SHARDS):
            check(torch.equal(index.state[s].centroids,
                              twin.state.centroids),
                  f"mesh {op.kind}: shard {s}'s centroids differ")
        maint.append({"op": op.kind, "lists": list(op.lists),
                      "rows": rm.rows, "ms": ms,
                      "gather_plan_commit_ms": index.last_maintain_ms})
    del twin
    return [{"phase": "mesh.lifecycle", "shards": MESH_SHARDS,
             "virtual_shards_on_one_card": True,
             "bytes_on_disk": dir_bytes(ckpt), "save_ms": save_ms,
             "load_onto_4_ms": load4_ms, "load_planes_equal": True,
             "chain": steps, "reshard_back_to_4_ms": back_ms,
             "maintenance": maint, "centroids_equal_every_shard": True,
             "abort": mesh_abort_check(torch)}], []


def mesh_abort_check(torch) -> dict:
    """A small config on 2 virtual shards where shard 0 holds most of two
    lists: ``merge`` overflows its chain bound only. No shard commits,
    every shard's planes stay as they were, ``shard_errors`` names shard
    0, and ``Index.maintain`` reports the abort."""
    import sivf_torch
    from repro_torch.core import maintenance as mt
    cfg = sivf_torch.SIVFConfig(dim=16, n_lists=4, n_slabs=12, capacity=32,
                                n_max=2048, max_chain=2)
    rng = np.random.default_rng(7)
    cents = (rng.normal(size=(4, 16)) * 4).astype(np.float32)
    index = sivf_torch.Index(cfg, cents, backend=vmesh(2), min_bucket=64)
    lists = np.repeat([0, 1, 2, 3], [50, 50, 10, 10])
    ids = np.where(lists < 2, 2 * np.arange(120), 2 * np.arange(120) + 1)
    vecs = (cents[lists] + 0.1 * rng.normal(size=(120, 16))).astype(
        np.float32)
    check(index.add(vecs, ids).ok, "abort config: add")
    before = mesh_digests(index)
    gathered = mt.gather_live(cfg, index.state, mt.shard_views(
        cfg, index.state), (0, 1))
    new_cents, rl = mt.plan_op(cfg, mt.merge(0, 1), gathered,
                               index.state[0].centroids.cpu().numpy())
    batch = mt.pad_batch(cfg, gathered, rl, mt.maint_batch_size(cfg, 2))
    st, aux = mt._commit_op_mesh(cfg, index._mesh, "data", index.state,
                                 new_cents, batch)
    errs = aux["shard_errors"].tolist()
    check(errs[0] & mt.ABORT_BITS and errs[1] == 0
          and int(aux["committed"]) == 0,
          f"abort: shard errors {errs}, committed {int(aux['committed'])}")
    check([state_digests(sh) for sh in st.shards] == before,
          "abort: a shard's planes changed")
    (rep,) = index.maintain([mt.merge(0, 1)], strict=False)
    check(not rep.committed and rep.errors & mt.ABORT_BITS,
          f"abort: report {rep}")
    return {"shard_errors": errs, "planes_unchanged": True,
            "report_committed": rep.committed}


MESH_TIERED_BATCHES = 4              # Q = 64 batches, cold then warm


def phase_mesh_tiered(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The mesh checkpoint loaded tiered onto 4 virtual shards
    (``device_slabs=8192`` frames a shard, the payloads in pinned host
    memory, one host store a shard): Q = 64 batches at nprobe 32, cold
    then warm, ``==`` the all-resident 4-shard handle loaded from the same
    checkpoint; a warm batch copies nothing to the card; every kernel-1
    launch on ``grouped``, four a batch."""
    import sivf_torch
    want_ix, queries = main["mesh_served"], main["queries"]
    index, load_ms = timed(lambda: sivf_torch.Index.load(
        main["mesh_ckpt"], backend=vmesh(MESH_SHARDS),
        device_slabs=DEVICE_SLABS))
    launches = Launches()
    batches = []
    for rnd in ("cold", "warm"):
        for b in range(MESH_TIERED_BATCHES):
            qs = queries[b * TIERED_Q:(b + 1) * TIERED_Q]
            copies = index._tiered.h2d_copies
            with launches.of():
                res, ms = timed(lambda: index.search(qs, K, NPROBE))
            same_result(f"mesh.tiered {rnd} batch {b}", res,
                        want_ix.search(qs, K, NPROBE))
            uploads = index._tiered.h2d_copies - copies
            check(rnd == "cold" or uploads == 0,
                  f"mesh.tiered: a warm batch copied {uploads} times")
            batches.append({"round": rnd, "ms": ms, "copies": uploads,
                            **index._tiered.last_prefetch})
    n = launches.n
    nb = 2 * MESH_TIERED_BATCHES
    check(n["fused"] == MESH_SHARDS * nb and n["fused_grouped"] == n["fused"],
          f"mesh.tiered launches by route {n}")
    st = index.stats()
    return [{"phase": "mesh.tiered", "shards": MESH_SHARDS,
             "virtual_shards_on_one_card": True,
             "device_slabs_per_shard": DEVICE_SLABS, "load_ms": load_ms,
             "queries": TIERED_Q, "nprobe": NPROBE, "batches": batches,
             "equal_all_resident": True,
             "per_shard_resident": st["per_shard_resident"],
             "hit_rate": st["hit_rate"], "h2d_bytes": index._tiered.h2d_bytes,
             "device_bytes": st["device_bytes"], "host_bytes":
             st["host_bytes"], "launches": n}], []


def phase_mesh_serve(torch, hbm: float, main: dict) -> tuple[list, list]:
    """A ``ServeEngine`` over the deferred 4-shard handle loaded from the
    mesh checkpoint: the coalescing check (each tile's results ``==`` its
    rows of a direct search, which is ``==`` the plain mesh version)."""
    index = main.pop("mesh_served")
    launches = Launches(serve_counts)
    try:
        line = coalesce_check(torch, index, main["queries"],
                              main["wl"]["attrs_h"], "mesh", launches)
    finally:
        shutil.rmtree(main.pop("mesh_ckpt"), ignore_errors=True)
        main.pop("mesh", None)
    line.update(phase="mesh.serve", shards=MESH_SHARDS,
                virtual_shards_on_one_card=True, launches=launches.n)
    return [line], []


def phase_mesh_pq(torch, hbm: float, main: dict) -> tuple[list, list]:
    """The PQ path's config on four virtual shards: ``train`` replicates
    codebooks ``==`` the single index's to every shard; the same traffic;
    the live-row table ``==`` the single index's; searches ``==`` the
    single path's (distances bit for bit, labels but inside ties)."""
    import sivf_torch
    from repro_torch.core import distributed as dist
    from repro_torch.kernels.sivf_scan import pq_fused
    wl, single, cfg = main["wl"], main["index"], main["cfg"]
    index = sivf_torch.Index(cfg, wl["cents"], backend=vmesh(MESH_SHARDS))
    gen = torch.Generator(device="cuda").manual_seed(wl["seed"])
    _, train_ms = timed(lambda: index.train(wl["sample"], generator=gen))
    want = digest(single.state.pq_codebooks)
    cb = [digest(sh.pq_codebooks) for sh in index.state.shards]
    check(cb == [want] * MESH_SHARDS, f"mesh.pq codebooks {cb} != {want}")
    out = {}
    zero_counts()                                # counts of this path
    lines = drive(torch, index, wl, "mesh.pq", out)
    launch = mesh_launch_checks("mesh.pq", {
        "compacted": pq_fused.launches_compacted,
        "per_query": pq_fused.launches_per_query}, "sivf_pq_fused_search",
        "compacted")
    tables_equal("mesh.pq vs single", dist.flatten_live_rows(
        cfg, index.state), dist.flatten_live_rows(cfg, single.state))
    vs_single = mesh_vs_single(out, main, "mesh.pq")
    rec = {name: recall(torch, r.labels, wl["oracle"]["unfiltered"])
           for name, r in (("mesh", out["result"]),
                           ("single", main["result"]))}
    lines.append({"phase": "mesh.pq", "shards": MESH_SHARDS,
                  "virtual_shards_on_one_card": True, "train_ms": train_ms,
                  "codebooks_sha256_every_shard": cb,
                  "table_equal_single": True, "vs_single": vs_single,
                  "recall_at_10": rec, **launch})
    return lines, []


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


# ---------------------------------------------------------------------------
# The LM serving path: paged decode (TPU kernel 5) and flash prefill
# (TPU kernel 6)
# ---------------------------------------------------------------------------

ATTN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py
PAGED_SRC = "src/repro_torch/csrc/paged_attention.cu"
PAGED_REP = "src/repro/kernels/paged_attention/paged_attention.py:66"
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REP = "src/repro/kernels/flash_attention/flash_attention.py:68"
# Llama-3-8B at full width (32 layers, bf16) behind PagedLMEngine: a
# 16,384-slot page pool (2 GiB of K+V), eight sequence slots
LM_ARCH = "llama3-8b"
LM_ENGINE = dict(page_size=16, n_pages=1024, max_seqs=8,
                 max_pages_per_seq=256)
LM_PROMPTS = (2048, 1000, 517, 129)    # admitted into slots 0..3
LM_READMIT = 300                       # into slot 3 once it is evicted
LM_STEPS = (64, 16)                    # decode steps before / after
LM_KEEP = 1024                         # slide(0, keep_last=LM_KEEP)
LM_LOGIT_RTOL = 0.1                    # engine vs attn_impl="ref" (PERF.md)
LM_TRAFFIC = dict(prompts=LM_PROMPTS, readmit=LM_READMIT, steps=LM_STEPS)


FULL_WIDTH_RTOL = 2.0 ** -7    # one bf16 step of the value compared ...
FULL_WIDTH_ATOL = 2.0 ** -7    # ... plus one of RMS(plain), its typical size


def attn_err(what: str, got, want, dtype: str, full_width: bool = False
             ) -> float:
    """Largest |kernel - plain| (float32), held to the dtype's tolerance
    as ``allclose(rtol=atol=tol)``; at ``full_width`` (bf16 on the path's
    own inputs) to ``|d| <= 2^-7 |plain| + 2^-7 RMS(plain)``, scaled to
    the values compared: a kernel that rounds the same float32 value
    differently passes it and one that drops a slot of a window does
    not."""
    import torch
    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    if full_width:
        rms = float(want.square().mean().sqrt()) if want.numel() else 0.0
        atol, rtol = FULL_WIDTH_ATOL * rms, FULL_WIDTH_RTOL
    else:
        atol = rtol = ATTN_TOL[dtype]
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()):
        i = tuple(int(x) for x in torch.nonzero(bad)[0])
        raise CheckFailed(f"{what}: {int(bad.sum())} of {bad.numel()} "
                          f"entries beyond {atol} + {rtol}·|plain|; first "
                          f"at {i}: kernel {float(got[i])!r} vs plain "
                          f"{float(want[i])!r}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def planted_control(what: str, got, wrong) -> dict:
    """Hold the kernel's output ``got`` through the full-width
    :func:`attn_err` against ``wrong``, the plain version of a planted
    fault; the check must refuse it. Returns how far the fault moved the
    output and how much of it the check saw."""
    try:
        attn_err(what, got, wrong, "bfloat16", full_width=True)
    except CheckFailed as e:
        d = (got.float() - wrong.float()).abs()
        tol = ATTN_TOL["bfloat16"]
        return {"refused": True, "max_abs_shift": float(d.max()),
                "rms_plain": float(wrong.float().square().mean().sqrt()),
                "entries": d.numel(),
                "entries_beyond_allclose_2e-2": int(
                    (d > tol + tol * wrong.float().abs()).sum()),
                "message": str(e)}
    raise CheckFailed(f"{what}: the full-width check passed a planted "
                      "fault")


def paged_inputs(torch, rng, b, page, maxp, hq, hkv, dk, dv, dtype,
                 dev="cuda"):
    """Random q and pages, and a block table whose rows fold in the edge
    cases: an all-pad row (row 0 when B > 1), a one-token window, a
    length exactly at a page end with ``starts`` mid-page, a ``-1`` pad
    inside the window, a plain random window."""
    n_pages = b * maxp + 3
    q = rng.normal(size=(b, hq, dk)).astype(np.float32)
    kp = rng.normal(size=(n_pages, page, hkv, dk)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, hkv, dv)).astype(np.float32)
    tables = np.full((b, maxp), -1, np.int32)
    lengths = np.zeros(b, np.int32)
    starts = np.zeros(b, np.int32)
    perm = rng.permutation(n_pages)
    for i in range(b):
        n = int(rng.integers(1, maxp + 1))
        tables[i, :n] = perm[i * maxp:i * maxp + n]
        lengths[i] = int(rng.integers(1, n * page + 1))
        starts[i] = int(rng.integers(0, lengths[i]))
        kind = i % 5 if b > 1 else 2
        if kind == 0:
            tables[i] = -1
        elif kind == 1:
            starts[i] = lengths[i] - 1
        elif kind == 2:
            lengths[i], starts[i] = n * page, page // 2 + 1
        elif kind == 3 and n > 1:
            tables[i, n // 2] = -1
            starts[i] = 0
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(dev) if a.dtype == np.int32 else
            torch.from_numpy(a).to(dev, dt)
            for a in (q, kp, vp, tables, lengths, starts)]


SPLIT_WINDOWS = ((100, 600), (256, 512), (0, None))   # (start, length)
# MiniCPM3's, Moonlight's and LLaVA's kernel shapes, held with a planted control:
# paged (B, page, maxp, Hq, Hkv, dk, dv) of LLaVA (g 7) and Moonlight
# (g 1) at dh 128; flash (B, Hq, Hkv, dh, dv or None) of MiniCPM3's MLA
# prefill (dh 96, V zero-padded from 64) and LLaVA's (g 7)
ARCH_PAGED_SHAPES = ((8, 16, 9, 56, 8, 128, 128), (8, 16, 9, 16, 16, 128, 128))
ARCH_FLASH_SHAPES = ((1, 40, 40, 96, 64), (1, 56, 8, 128, None))


def paged_edge_checks(torch, rng) -> tuple[list, dict]:
    """The paged decode kernel vs its plain version: page 8/16/32, g = 1,
    2, 3, 4 and 5, four over ten KV heads, dk = dv and dk != dv, ``-1`` pads, an all-pad row (output 0),
    ``starts`` mid-page, a length at a page end, one live token, B = 1 and
    B = 8, rows of a width that is no whole 16-byte vector (plain loads);
    and against the split over the window (equal shares of whole 32-slot
    chunks, ``n_split`` a sequence): tables of ``maxp * page`` slots that
    the shares do not divide, with a window crossing several shares, one
    of 256 slots and a whole table, at Llama's and at MLA's shape (dk
    288, dv 256, g 40, one KV head); float32 and bfloat16. The
    architectures' decode shapes (``ARCH_PAGED_SHAPES``: LLaVA's g 7 and
    Moonlight's g 1 at dh 128) also hold a planted control, each window
    one slot short, that the full-width check must refuse."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        launch_plan,
        paged_attention_cuda,
    )
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    cases, errs = [], {"float32": 0.0, "bfloat16": 0.0}
    shapes = [(8, 16, 6, 32, 8, 128, 128), (8, 8, 9, 16, 8, 64, 64),
              (8, 32, 4, 8, 8, 128, 64), (1, 16, 5, 4, 4, 128, 128),
              (1, 32, 3, 32, 8, 64, 96), (8, 16, 4, 2, 1, 16, 40),
              (2, 8, 9, 4, 4, 36, 20),
              # the registered GQA shapes: g = 3 at dh 64 (Granite), g = 5
              # (Qwen3), four query heads on each of ten KV heads (Phi-3)
              (8, 16, 6, 24, 8, 64, 64), (8, 16, 6, 40, 8, 128, 128),
              (8, 16, 6, 40, 10, 128, 128)] + list(ARCH_PAGED_SHAPES)
    split_shapes = [(4, 16, 41, 32, 8, 128, 128), (4, 16, 37, 40, 1, 288, 256)]
    for split_set, (b, page, maxp, hq, hkv, dk, dv) in (
            [(False, sh) for sh in shapes] + [(True, sh) for sh in split_shapes]):
        for dtype in ("float32", "bfloat16"):
            args = paged_inputs(torch, rng, b, page, maxp, hq, hkv, dk, dv,
                                dtype)
            name = (f"B={b}/page={page}/maxp={maxp}/g={hq // hkv}/dk={dk}/"
                    f"dv={dv}/{dtype}")
            plan = launch_plan(*args[:4])
            if split_set:
                n = maxp * page
                check(n % (32 * plan["n_split"]) and plan["n_split"] > 8,
                      f"{name}: not a split set")
                tables, lengths, starts = args[3:]
                for i, (st, ln) in zip(range(1, b), SPLIT_WINDOWS):
                    tables[i] = torch.arange(i * maxp, (i + 1) * maxp)
                    starts[i], lengths[i] = st, n if ln is None else ln
                name += f"/windows {SPLIT_WINDOWS}"
            got = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            want = paged_attention_ref(*args)
            errs[dtype] = max(errs[dtype], attn_err(name, got, want, dtype))
            if b > 1:
                check(bool((got[0] == 0).all()), f"{name}: all-pad row not 0")
            if (b, page, maxp, hq, hkv, dk, dv) in ARCH_PAGED_SHAPES:
                planted_control(f"{name}, window short by one slot",
                                *control_pair("paged_attention", got,
                                              paged_attention_ref, args, {}))
                name += " (control refused)"
            cases.append(f"{name} ({plan['n_split']} splits, "
                         f"{plan['stages']} stages, vec={plan['vec']})")
    return cases, errs


def flash_edge_checks(torch, rng) -> tuple[list, dict]:
    """The flash kernels vs their plain version: causal and not, Sq = Sk
    and Sq < Sk, S = 1, 17, 129 and 1000 (ragged tiles), g = 1 and 4, dh
    128 and 64, float32 and bfloat16; the registered GQA shapes in bf16
    (g = 3 at dh 64, g = 5, four over five KV heads); then each route by name: bf16 at dh
    64, 128, 256 and 80 (tensor cores; 80 reads zeros past dh) and dh 40
    (SIMT), at S = 1, 127, 129 and 1000 against tiles of 128; last the
    architectures' prefill shapes in bf16, causal (MiniCPM3's MLA: dh 96
    at g 1 with V's columns 64.. zero, whose output columns must come out
    0; LLaVA's g 7 at dh 128), each also with a planted control, each
    row without its own key, that the full-width check must refuse."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import mha_ref
    cases, errs = [], {"float32": 0.0, "bfloat16": 0.0}

    def one(b, hq, hkv, sq, sk, dh, causal, dtype, want_route=None,
            dv=None, control=False):
        dt = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(rng.normal(size=(
            b, h, s, dh)).astype(np.float32)).to("cuda", dt)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
        if dv is not None:                # V zero-padded from dv to dh
            v[..., dv:] = 0
        which = fk.route(dt, dh)
        check(want_route in (None, which), f"dh={dh} {dtype}: route {which}")
        before = getattr(fk, f"launches_{which}")
        got = fk.flash_attention_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        check(getattr(fk, f"launches_{which}") == before + 1,
              f"dh={dh} {dtype}: the {which} count did not move")
        want = mha_ref(q, k, v, causal)
        name = (f"Sq={sq}/Sk={sk}/causal={causal}/g={hq // hkv}/dh={dh}/"
                f"{dtype}/{which}")
        errs[dtype] = max(errs[dtype], attn_err(name, got, want, dtype))
        if dv is not None:
            check(bool((got[..., dv:] == 0).all()),
                  f"{name}: output columns past dv={dv} not 0")
            name += f"/V padded from {dv}"
        if control:
            planted_control(f"{name}, rows without their own key",
                            *control_pair("flash_attention", got, mha_ref,
                                          (q, k, v), {"causal": causal}))
            name += " (control refused)"
        cases.append(name)

    lengths = [(1, 1), (17, 17), (129, 129), (1000, 1000), (1, 1000),
               (17, 129), (129, 1000)]
    for sq, sk in lengths:
        for causal in (True, False):
            for b, hq, hkv, dh in ((1, 8, 2, 128), (2, 2, 2, 64)):
                for dtype in ("float32", "bfloat16"):
                    one(b, hq, hkv, sq, sk, dh, causal, dtype)
            for b, hq, hkv, dh in ((1, 6, 2, 64), (1, 10, 2, 128),
                                   (1, 20, 5, 128)):
                one(b, hq, hkv, sq, sk, dh, causal, "bfloat16")
    for sq, sk in ((1, 1), (127, 127), (129, 129), (1000, 1000), (127, 1000)):
        for causal in (True, False):
            for dh, which in ((64, "tensor_core"), (128, "tensor_core"),
                              (256, "tensor_core"), (80, "tensor_core"),
                              (40, "simt")):
                one(1, 8, 2, sq, sk, dh, causal, "bfloat16", which)
    for s in (1, 129, 1000):
        for b, hq, hkv, dh, dv in ARCH_FLASH_SHAPES:
            one(b, hq, hkv, s, s, dh, True, "bfloat16", "tensor_core", dv=dv,
                control=s > 1)
    return cases, errs


class Capture:
    """While entered, record the arguments of the engine's calls of
    ``mod.<name>`` at the given call indices (layers), cloned, log
    ``key(*args, **kwargs)`` of every call where a ``key`` is given, and
    pass every call through unchanged."""

    def __init__(self, mod, name: str, calls, key=None):
        self.mod, self.name, self.calls = mod, name, set(calls)
        self.orig, self.n, self.args = getattr(mod, name), 0, {}
        self.key, self.log = key, []

    def __enter__(self):
        def hook(*args, **kwargs):
            if self.key is not None:
                self.log.append(self.key(*args, **kwargs))
            if self.n in self.calls:
                self.args[self.n] = (
                    [a.clone() if hasattr(a, "clone") else a for a in args],
                    dict(kwargs))
            self.n += 1
            return self.orig(*args, **kwargs)
        setattr(self.mod, self.name, hook)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def control_pair(name: str, out, plain, args, kw, short: int = 1) -> tuple:
    """The kernel's output and the plain version of the same call with
    each window short by its newest ``short`` keys: for the paged kernel
    ``lengths - short`` (at 1, the token the step just wrote), for the
    causal flash kernel each row's own position (rows 1.. of the output
    against keys 0..S-2 for queries 1..S-1), for the non-causal one the
    last ``short`` keys. Over Whisper's 1,500-frame windows one key of
    1,500 moves the output by about the check's own limit, so its cross
    and encoder calls cut the last 32-slot chunk (paged) or 64-key tile
    (flash), the kernels' units of work."""
    if name == "paged_attention":
        q, kp, vp, tables, lengths, starts = args
        return out, plain(q, kp, vp, tables, lengths - short, starts, **kw)
    q, k, v = args
    if not kw.get("causal", True):
        cut = min(short, k.shape[2] - 1)
        return out, plain(q, k[:, :, :-cut], v[:, :, :-cut], **kw)
    return out[:, :, 1:], plain(q[:, :, 1:], k[:, :, :-1], v[:, :, :-1],
                                **kw)


def engine_pool_bytes(eng) -> int:
    """Bytes of an LM engine's K and V page pools (MLA's differ)."""
    return sum(p.numel() * p.element_size() for p in (eng.k_pool, eng.v_pool))


def lm_traffic(seed: int, vocab: int, traffic: dict = LM_TRAFFIC
               ) -> tuple[list, np.ndarray]:
    """Prompts (the admits, then any re-admit) and the teacher-forced
    token of every slot at every decode step, from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    readmit = () if traffic["readmit"] is None else (traffic["readmit"],)
    prompts = [rng.integers(1, vocab, n).astype(np.int32)
               for n in traffic["prompts"] + readmit]
    forced = rng.integers(1, vocab, (sum(traffic["steps"]),
                                     LM_ENGINE["max_seqs"])
                          ).astype(np.int32)
    return prompts, forced


def lm_operations(prompts, forced_t, traffic: dict = LM_TRAFFIC,
                  prefix=None) -> list:
    """The LM traffic as ``(name, call)`` pairs, ``call(engine)`` running
    the operation: admit the prompts into slots 0, 1, ... (slot 0's with
    the ``prefix`` embeddings where there are any), decode
    ``steps[0]`` lockstep steps; where the traffic has a re-admit, then
    slide slot 0's window to ``LM_KEEP``, evict slot 3, admit the last
    prompt into slot 3 (onto the freed pages) and decode ``steps[1]``
    more. Every step's input tokens are the forced ones."""
    def admit(seq, toks):
        if seq == 0 and prefix is not None:
            return "admit0", lambda eng: eng.admit(0, toks,
                                                   prefix_embeds=prefix)
        return f"admit{seq}", lambda eng: eng.admit(seq, toks)

    def step(i):
        def go(eng):
            eng.last_tokens = forced_t[i][:, None].clone()
            return eng.step()
        return f"step{i}", go

    n, steps = len(traffic["prompts"]), traffic["steps"]
    ops = ([admit(seq, toks) for seq, toks in enumerate(prompts[:n])]
           + [step(i) for i in range(steps[0])])
    if traffic["readmit"] is None:
        return ops
    return (ops + [("slide", lambda eng: eng.slide(0, LM_KEEP)),
                   ("evict", lambda eng: eng.evict(3)), admit(3, prompts[n])]
            + [step(i) for i in range(steps[0], sum(steps))])


def serve_lm(torch, eng, prompts, forced, captures=None,
             dev="cuda", traffic: dict = LM_TRAFFIC, prefix=None) -> dict:
    """Drive ``eng`` through the LM traffic (:func:`lm_operations`, slot
    0's admit with ``prefix``).
    ``captures`` maps an operation (``"admit0"``, ``"step64"``) to the
    :class:`Capture` that records its kernels' inputs.
    Returns timings, the page state after each operation, each step's
    logits and active mask, and the free-stack top around the slide and
    the eviction."""
    from repro_torch.interop import page_state_to_numpy
    captures = captures or {}
    out = {"admit": [], "step_ms": [], "pages": [], "logits": [],
           "active": []}
    for op, call in lm_operations(prompts, torch.from_numpy(forced).to(dev),
                                  traffic, prefix):
        before = int(eng.pages.free_top)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with captures.get(op) or contextlib.nullcontext():
            r = call(eng)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out["pages"].append((op, page_state_to_numpy(eng.pages)))
        if op.startswith("admit"):
            seq = int(op[len("admit"):])
            n = int(eng.pages.lengths[seq])
            check(r, f"admit of {n} tokens into slot {seq} refused")
            out["admit"].append({"slot": seq, "tokens": n, "ms": ms,
                                 "tokens_per_s": n / ms * 1e3})
        elif op.startswith("step"):
            out["step_ms"].append(ms)
            out["logits"].append(eng.logits[:, 0].clone())
            out["active"].append(eng.pages.active.clone())
        else:
            out[op] = {"ms": ms, "free_top_before": before,
                       "free_top_after": int(eng.pages.free_top)}
    return out


def logits_vs(torch, got: dict, ref: dict) -> dict:
    """Hold two runs of one traffic to each other: the same operations,
    page state ``==`` after each, the same active slots and finite logits
    at each step; returns max and mean |d| / max |ref| of the active
    slots' logits and the top-1 agreement."""
    check([op for op, _ in got["pages"]] == [op for op, _ in ref["pages"]],
          "the two runs took different operations")
    for (op, a), (_, b) in zip(got["pages"], ref["pages"]):
        for plane in a:
            check(np.array_equal(a[plane], b[plane]),
                  f"page state after {op}: plane {plane} differs")
    worst, mean_rel, top1, n_rows, equal = 0.0, [], 0, 0, True
    for i, (lk, lr, ak, ar) in enumerate(zip(got["logits"], ref["logits"],
                                             got["active"], ref["active"])):
        check(torch.equal(ak, ar), f"step {i}: active slots differ")
        equal &= torch.equal(lk, lr)
        lk, lr = lk[ak].float(), lr[ar].float()
        check(bool(torch.isfinite(lk).all() and torch.isfinite(lr).all()),
              f"step {i}: non-finite logits")
        worst = max(worst, float((lk - lr).abs().max() / lr.abs().max()))
        mean_rel.append(float((lk - lr).abs().mean() / lr.abs().mean()))
        top1 += int((lk.argmax(-1) == lr.argmax(-1)).sum())
        n_rows += lk.shape[0]
    return {"max_rel_logit_err": worst,
            "mean_rel_logit_err": float(np.mean(mean_rel)),
            "top1_agreement": top1 / max(n_rows, 1), "rows_compared": n_rows,
            "logits_equal": bool(equal)}


def device_profile(torch, fn, reps: int = 1) -> dict:
    """Device time of ``reps`` calls of ``fn`` by kernel name
    (``torch.profiler``): the device-busy milliseconds per call and the
    five kernels that take most of it. ``None`` where the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0) or 0

    # the kernels themselves (device events), not the host ops that
    # launched them, whose device time would count each kernel twice
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in events) / 1e3
    return {"calls": reps,
            "device_ms_per_call": total / reps if total else None,
            "top": [{"name": e.key[:80], "ms_per_call":
                     dev_us(e) / 1e3 / reps, "launches": e.count}
                    for e in events[:5] if dev_us(e)]}


def p_bf16_verdicts(F, args, want, mha_p_bf16_ref, causal=True) -> dict:
    """What the full-width check says of P carried to ``P V`` in bf16 on
    the flash kernel's captured inputs: SDPA (one bf16 term) and the
    plain emulation with one and with two terms (the kernel's hi + lo);
    "passes", or the check's message."""
    q, k, v = args
    outs = {"sdpa": F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True),
            "emulation_one_term": mha_p_bf16_ref(q, k, v, causal, terms=1),
            "emulation_two_terms": mha_p_bf16_ref(q, k, v, causal,
                                                  terms=2)}
    verdicts = {}
    for what, out in outs.items():
        try:
            attn_err(what, out, want, "bfloat16", full_width=True)
            verdicts[what] = "passes"
        except CheckFailed as e:
            verdicts[what] = str(e)[:300]
    return verdicts


def paged_work(q, k_pages, v_pages, tables, lengths, starts) -> tuple:
    """(bytes, flops, live slots) one paged call must move and do on these
    inputs: ``ops.work`` (the kernel's ``meta`` route's formula) over the
    slots this call's windows hold (a slot whose table entry is -1 is no
    work)."""
    from repro_torch.kernels.paged_attention.ops import work
    page = k_pages.shape[1]
    tab = tables.cpu().numpy()
    ln, st = lengths.cpu().numpy(), starts.cpu().numpy()
    slot = np.arange(tab.shape[1] * page)
    live = int(((slot[None] < ln[:, None]) & (slot[None] >= st[:, None])
                & np.repeat(tab >= 0, page, axis=1)).sum())
    return (*work(q, k_pages, v_pages, tables, live), live)


def flash_work(q, k, causal=True, dv=None) -> tuple:
    """(bytes, flops) of one flash call: ``ops.work``, the formula of the
    kernel's ``meta`` route."""
    from repro_torch.kernels.flash_attention.ops import work
    return work(q, k, causal, dv)


def peak_of(torch, dtype) -> float:
    """The card's peak FLOP/s for operands of ``dtype``: bf16 and fp16 on
    the tensor cores, float32 outside them."""
    return BF16_PEAK if dtype in (torch.bfloat16, torch.float16) \
        else FP32_PEAK


def full_width_checks(torch, caps: dict, layers, short=None) -> dict:
    """Each attention kernel against its plain version on the inputs a
    path gave it: ``caps`` maps ``"flash_attention"`` and
    ``"paged_attention"`` to the :class:`Capture` of the engine's calls
    at ``layers``. Holds each call to the full-width :func:`attn_err`,
    requires the short-window :func:`planted_control` to be refused
    (``short`` maps a layer to the keys :func:`control_pair` cuts, 1 by
    default), and for flash reads what the check says of P carried in
    bf16."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import (
        mha_p_bf16_ref,
        mha_ref,
    )
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    fns = {"flash_attention": (fk.flash_attention_cuda, mha_ref),
           "paged_attention": (pk.paged_attention_cuda, paged_attention_ref)}
    full = {}
    for name, cap in caps.items():
        kern, plain = fns[name]
        check(set(cap.args) == set(layers), f"{name}: captured layers "
              f"{sorted(cap.args)}")
        errs, rms, controls, p_bf16 = {}, {}, {}, {}
        for li, (args, kw) in cap.args.items():
            k_out = kern(*args, **kw)
            torch.cuda.synchronize()
            want = plain(*args, **kw)
            errs[li] = attn_err(f"{name} layer {li} at full width", k_out,
                                want, "bfloat16", full_width=True)
            rms[li] = float(want.float().square().mean().sqrt())
            controls[li] = planted_control(
                f"{name} layer {li}, window short by one slot",
                *control_pair(name, k_out, plain, args, kw,
                              (short or {}).get(li, 1)))
            if name == "flash_attention":
                p_bf16[li] = p_bf16_verdicts(F, args, want, mha_p_bf16_ref,
                                             kw.get("causal", True))
        full[name] = {"max_abs_err_by_layer": errs,
                      "rms_plain_by_layer": rms,
                      "limit": f"{FULL_WIDTH_RTOL}*|plain| + "
                               f"{FULL_WIDTH_ATOL}*RMS(plain)",
                      "control_short_window_by_layer": controls,
                      **({"full_width_check_of_p_in_bf16_by_layer": p_bf16}
                         if p_bf16 else {}),
                      "shapes": [list(a.shape) for a in
                                 cap.args[layers[0]][0]
                                 if hasattr(a, "shape")]}
    return full


def phase_lm(torch, seed: int, hbm: float, dev="cuda") -> tuple[list, list]:
    """Serve Llama-3-8B at full width through PagedLMEngine on the card,
    hold both attention kernels against their plain versions on the
    path's own inputs (layers 0 and 31 of the 2048-token admit and of the
    first step after the re-admit), rerun the traffic with
    ``attn_impl="ref"`` and hold the engines to each other."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        mha_p_bf16_ref,
        mha_ref,
    )
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models.model import init_params
    from repro_torch.serve.paged_lm import PagedLMEngine
    from repro_torch.sharding.rules import unpadded_plan
    cfg = get_arch(LM_ARCH)
    plan = unpadded_plan(cfg)
    last = cfg.n_layers - 1
    prompts, forced = lm_traffic(seed, cfg.vocab_size)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (params, init_ms) = timed(lambda: init_params(cfg, plan, seed=seed,
                                                  device=dev))
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    # a first pass on a throwaway engine: first use of each kernel and
    # GEMM shape (CUDA's lazy module loading, cuBLAS set-up) is timed
    # apart; the profiler then reads two decode steps at its end and one
    # admit of the 129-token prompt into a free slot
    warm = PagedLMEngine(cfg, plan, params, device=dev, **LM_ENGINE)
    cold = serve_lm(torch, warm, prompts, forced, dev=dev)
    profile = {"decode_step": device_profile(torch, warm.step, reps=2),
               "admit_129": device_profile(
                   torch, lambda: warm.admit(len(LM_PROMPTS), prompts[3]))}
    del warm
    eng = PagedLMEngine(cfg, plan, params, device=dev, **LM_ENGINE)
    pool_bytes = engine_pool_bytes(eng)
    readmit_step = f"step{LM_STEPS[0]}"
    caps = {"admit0": Capture(fops, "flash_attention", (0, last)),
            readmit_step: Capture(pops, "paged_attention", (0, last))}
    zero_counts()                                # counts of this path
    t0 = time.perf_counter()
    got = serve_lm(torch, eng, prompts, forced, caps, dev)
    path_s = time.perf_counter() - t0
    launches = {"paged_attention": pk.launches,
                "flash_attention": fk.launches,
                "flash_attention[tensor_core]": fk.launches_tensor_core,
                "flash_attention[simt]": fk.launches_simt}
    n_admits = len(LM_PROMPTS) + 1
    n_steps = sum(LM_STEPS)
    check(launches["flash_attention"] == cfg.n_layers * n_admits,
          f"flash launches {launches['flash_attention']} != "
          f"{cfg.n_layers} x {n_admits} admits")
    check(fk.launches_tensor_core == launches["flash_attention"],
          f"flash launches {launches}: not all on the tensor-core route")
    check(launches["paged_attention"] == cfg.n_layers * n_steps,
          f"paged launches {launches['paged_attention']} != "
          f"{cfg.n_layers} x {n_steps} steps")
    peak = torch.cuda.max_memory_allocated() - base
    steps = np.array(got["step_ms"])
    after = steps[LM_STEPS[0]:]
    active = [int(a.sum()) for a in got["active"]]
    lm_line = {
        "phase": "lm", "arch": cfg.name, "n_layers": cfg.n_layers,
        "dtype": cfg.dtype, "params": cfg.param_count(),
        "param_bytes": param_bytes, "pool_bytes": pool_bytes,
        "engine": LM_ENGINE, "init_params_ms": init_ms,
        "admit": got["admit"],
        "decode_steps": n_steps, "step_ms": got["step_ms"],
        "step_ms_median": float(np.median(steps)),
        "step_ms_median_before_slide": float(np.median(
            steps[:LM_STEPS[0]])),
        "step_ms_median_after_readmit": float(np.median(after)),
        "decode_tokens_per_s_median": float(np.median(
            np.array(active) / steps * 1e3)),
        "first_pass": {"admit_ms": [a["ms"] for a in cold["admit"]],
                       "step_ms_first": cold["step_ms"][0],
                       "step_ms_median": float(np.median(cold["step_ms"]))},
        "profile": profile,
        "slide": got["slide"], "evict": got["evict"],
        "peak_device_bytes": peak, "launches": launches,
        "path_seconds": path_s}

    # each kernel vs its plain version on the path's own inputs
    full = full_width_checks(torch, {"flash_attention": caps["admit0"],
                                     "paged_attention": caps[readmit_step]},
                             (0, last))
    fa, fkw = caps["admit0"].args[0]
    pa, pkw = caps[readmit_step].args[0]
    # the path finds a layer's pages (and mostly its q, k, v) out of the
    # 50 MB L2: each timed launch follows a 256 MB write
    scratch = torch.empty(1 << 26, dtype=torch.float32, device=dev)
    flush = scratch.zero_
    f_ms = cuda_median_ms_cold(
        lambda: fk.flash_attention_cuda(*fa, **fkw), 20, flush)
    f_warm = cuda_median_ms(lambda: fk.flash_attention_cuda(*fa, **fkw), 20)
    f_plain = cuda_ms(lambda: mha_ref(*fa, **fkw), reps=3)
    q, k, v = fa

    def sdpa():                 # the library yardstick: rounds P to bf16
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    f_lib = cuda_median_ms(sdpa, 20)
    f_lib_cold = cuda_median_ms_cold(sdpa, 20, flush)
    lib_err = float((sdpa().float() - mha_ref(q, k, v).float()).abs().max())
    f_bytes, f_flops = flash_work(q, k)
    p_ms = cuda_median_ms_cold(
        lambda: pk.paged_attention_cuda(*pa, **pkw), 20, flush)
    p_warm = cuda_median_ms(lambda: pk.paged_attention_cuda(*pa, **pkw), 20)
    p_plan = pk.launch_plan(*pa[:4])
    del scratch
    p_plain = cuda_ms(lambda: paged_attention_ref(*pa, **pkw), reps=3)
    p_bytes, p_flops, live = paged_work(*pa)
    rows = [row("paged_attention", PAGED_SRC, PAGED_REP,
                launches["paged_attention"],
                max(full["paged_attention"]["max_abs_err_by_layer"].values()),
                p_ms, p_plain, p_bytes, p_flops, hbm,
                peak=peak_of(torch, pa[0].dtype)),
            row("flash_attention", FLASH_SRC, FLASH_REP,
                launches["flash_attention"],
                max(full["flash_attention"]["max_abs_err_by_layer"].values()),
                f_ms, f_plain, f_bytes, f_flops, hbm,
                peak=peak_of(torch, q.dtype),
                library_ms=f_lib)]
    full["paged_attention"].update(
        ms=p_ms, ms_l2_warm=p_warm, plain_ms=p_plain, live_slots=live, bytes=p_bytes,
        split=p_plan["split"], n_split=p_plan["n_split"],
        stages=p_plan["stages"], vec=p_plan["vec"],
        scratch_bytes=p_plan["scratch_bytes"], flops=p_flops,
        bound_ms=rows[0]["bound_ms"],
        bound_by=rows[0]["bound_by"],
        pct_of_bound=rows[0]["bound_ms"] / p_ms * 100,
        per_step_ms=p_ms * cfg.n_layers)
    full["flash_attention"].update(
        ms=f_ms, ms_l2_warm=f_warm, plain_ms=f_plain, flops=f_flops, bytes=f_bytes,
        bound_ms=rows[1]["bound_ms"], bound_by=rows[1]["bound_by"],
        bound_ms_fp32_cuda_cores=max(f_flops / FP32_PEAK,
                                     f_bytes / hbm) * 1e3,
        pct_of_bound=rows[1]["bound_ms"] / f_ms * 100,
        achieved_tflops=f_flops / f_ms / 1e9,
        route=fk.route(q.dtype, q.shape[-1]),
        sdpa_bf16_ms=f_lib, sdpa_bf16_ms_l2_cold=f_lib_cold,
        ms_over_sdpa_l2_warm=f_warm / f_lib,
        ms_over_sdpa_l2_cold=f_ms / f_lib_cold,
        sdpa_max_abs_err_vs_plain=lib_err,
        max_abs_err_vs_p_bf16_emulation=float(
            (fk.flash_attention_cuda(q, k, v).float()
             - mha_p_bf16_ref(q, k, v).float()).abs().max()),
        per_admit_ms=f_ms * cfg.n_layers)
    for name, wall in (("decode_step", float(np.median(after))),
                       ("admit_129", got["admit"][3]["ms"])):
        busy = profile[name]["device_ms_per_call"]
        if busy is not None:            # against the unprofiled run's time
            profile[name]["idle_share"] = 1 - busy / wall
    del caps, fa, pa, q, k, v
    full_line = {"phase": "lm.kernels_full_width", **full}

    # the same traffic through the plain versions; the engines agree
    logits_k, active_k = got["logits"], got["active"]
    pages_k = got["pages"]
    del eng, got
    torch.cuda.empty_cache()
    ref_eng = PagedLMEngine(cfg, plan, params, device=dev,
                            attn_impl="ref", **LM_ENGINE)
    t0 = time.perf_counter()
    ref = serve_lm(torch, ref_eng, prompts, forced, dev=dev)
    ref_s = time.perf_counter() - t0
    got_k = {"pages": pages_k, "logits": logits_k, "active": active_k}
    agree = logits_vs(torch, got_k, ref)
    agree.pop("logits_equal")
    check(agree["max_rel_logit_err"] <= LM_LOGIT_RTOL,
          f"decode logits: max |kernel - ref| is "
          f"{agree['max_rel_logit_err']} of max |ref|, above {LM_LOGIT_RTOL}")
    vs_ref = {"phase": "lm.vs_ref", "ref_path_seconds": ref_s,
              "ref_step_ms_median": float(np.median(ref["step_ms"])),
              "ref_admit_ms": [a["ms"] for a in ref["admit"]],
              "page_states_equal": True, "operations": len(pages_k),
              "logits_finite": True, **agree, "logit_rtol": LM_LOGIT_RTOL}
    del ref_eng, ref, logits_k, got_k
    torch.cuda.empty_cache()
    dense = dense_vs_paged(torch, "lm", cfg, plan, params, seed,
                           LM_LOGIT_RTOL, dev)
    del params
    torch.cuda.empty_cache()
    return [lm_line, full_line, vs_ref, dense], rows


# ---------------------------------------------------------------------------
# The RWKV6 and hybrid serving paths: the WKV6 recurrence (TPU kernel 8)
# and the selective scan (TPU kernel 7)
# ---------------------------------------------------------------------------

WKV6_SRC = "src/repro_torch/csrc/wkv6.cu"
WKV6_REP = "src/repro/kernels/wkv6/wkv6.py:44"
SCAN_SRC = "src/repro_torch/csrc/mamba_scan.cu"
SCAN_REP = "src/repro/kernels/mamba_scan/mamba_scan.py:44"
# both phases serve the lm phase's traffic behind the same engine shape
RNN_PHASES = {
    "rwkv": dict(arch="rwkv6-3b", kernel="wkv6", kind="rwkv", cut=None),
    # Jamba-v0.1-52B is 103.1 GB in bf16: one 8-layer period (attention at
    # position 4, MoE at 1, 3, 5, 7, Mamba elsewhere; 26.6 GB) at full width
    "hybrid": dict(arch="jamba-v0.1-52b", kernel="mamba_scan", kind="mamba",
                   cut=8),
}
# float32 kernel vs float32 plain version: |d| <= REC_RTOL |plain| +
# REC_ATOL RMS(plain), the RMS over each sequence slot's own outputs and
# the sums taken in another order; a recurrence that loses or misapplies
# its state moves the output by its own scale
REC_RTOL = REC_ATOL = 1e-4
# engine vs attn_impl="ref" in float32: max |d| / max |ref| of the logits
# and of every recurrent state of the active slots. Random weights at full
# width amplify a rounding flip by orders of magnitude over the layers, so
# the engines are held to each other in float32, where the kernels' other
# summation order is all that differs. An idle slot decodes its forced
# token every step from whatever state it has (overwritten by its next
# admit): it is reported beside a control engine that moves the plain
# recurrence's output by one float32 rounding step (CONTROL_REL), and the
# kernel check holds it to its own limit on the path's inputs
RNN_F32_RTOL = 1e-3
CONTROL_REL = 2.0 ** -23
# the three float32 engines in lockstep take the first half of each prompt
# and decode 32 steps before the slide, not LM_TRAFFIC's 64 (cut: the two
# plain engines' admits, a Python loop a token, took most of the phase);
# the kernel engine's own run keeps the whole traffic
RNN_VS_REF_TRAFFIC = dict(prompts=tuple(n // 2 for n in LM_PROMPTS),
                          readmit=LM_READMIT // 2, steps=(32, LM_STEPS[1]))
SFU_RATE = SM_COUNT * 16 * BOOST_HZ   # ex2 results/s (16 a clock per SM)


def rec_limit(w):
    """The limit on |kernel - plain| for a plain output ``w`` [B, ...]:
    ``REC_RTOL |w| + REC_ATOL RMS``, the RMS taken over each batch row (a
    sequence slot on the path), so that a fault confined to a slot of
    small values shows."""
    rms = w.square().flatten(1).mean(1).sqrt()
    return REC_ATOL * rms.view(-1, *[1] * (w.dim() - 1)) \
        + REC_RTOL * w.abs()


def rec_err(what: str, got, want) -> float:
    """Largest |kernel - plain| over the outputs ``got`` and ``want``
    (tuples of float32 tensors), each entry held to :func:`rec_limit`."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape, f"{what}[{i}]: shape {tuple(g.shape)} vs "
              f"{tuple(w.shape)}")
        check(bool(g.isfinite().all()), f"{what}[{i}]: non-finite output")
        d = (g - w).abs()
        lim = rec_limit(w)
        bad = d > lim
        if bool(bad.any()):
            j = tuple(int(x) for x in bad.nonzero()[0])
            raise CheckFailed(
                f"{what}[{i}]: {int(bad.sum())} of {bad.numel()} entries "
                f"beyond {REC_ATOL}·RMS(slot) + {REC_RTOL}·|plain|; first "
                f"at {j}: kernel {float(g[j])!r} vs plain {float(w[j])!r}, "
                f"limit {float(lim[j])!r}")
        worst = max(worst, float(d.max()))
    return worst


def rec_control(what: str, got, wrong) -> dict:
    """Hold the kernel's outputs ``got`` through :func:`rec_err` against
    ``wrong``, the plain version of a planted fault; the check must refuse
    it. Returns how far the fault moved the output."""
    try:
        rec_err(what, got, wrong)
    except CheckFailed as e:
        d = (got[0] - wrong[0]).abs()
        return {"refused": True, "max_abs_shift": float(d.max()),
                "rms_plain": float(wrong[0].square().mean().sqrt()),
                "entries_beyond": int((d > rec_limit(wrong[0])).sum()),
                "entries": d.numel(), "message": str(e)[:300]}
    raise CheckFailed(f"{what}: the full-width check passed a planted fault")


def wkv6_inputs(torch, rng, b, t, h, dk, dv, w_kind, dev="cuda"):
    """Random r, k, v, u, a non-zero s0, and the decay w: near 0
    (1e-3..1e-2), near 1 (1 - 1e-4..1e-3) or the model's own form
    exp(-exp(x))."""
    f = np.float32
    r, k, w_raw = (rng.normal(size=(b, t, h, dk)).astype(f) for _ in "rkw")
    v = rng.normal(size=(b, t, h, dv)).astype(f)
    if w_kind == "near0":
        w = rng.uniform(1e-3, 1e-2, size=r.shape).astype(f)
    elif w_kind == "near1":
        w = (1 - rng.uniform(1e-4, 1e-3, size=r.shape)).astype(f)
    else:
        w = np.exp(-np.exp(w_raw - 0.6)).astype(f)
    u = (0.1 * rng.normal(size=(h, dk))).astype(f)
    s0 = rng.normal(size=(b, h, dk, dv)).astype(f)
    return [torch.from_numpy(a).to(dev) for a in (r, k, v, w, u, s0)]


def wkv6_edge_checks(torch, rng, dev="cuda") -> tuple[list, float]:
    """The WKV6 kernel vs its plain version: T = 1, 2, 7, 31, 32, 33, 64
    and 517 (about the kernel's 32-step chunk) with B = 3 (1 at T = 517)
    and the decode shape B = 8, T = 1, a non-zero initial state; dk = dv
    = 16 and 64, dk = 128 (its own chunk) with dv = 32, and dv = 40 (a
    partial 32-column group); w near 0, near 1 and of the model's form."""
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.kernels.wkv6.wkv6 import wkv6_cuda
    cases, err = [], 0.0
    shapes = [(16, 16), (64, 64), (128, 32), (64, 40)]
    runs = [(3, t) for t in (1, 2, 7, 31, 32, 33, 64)] + [(1, 517), (8, 1)]
    for dk, dv in shapes:
        for b, t in runs:
            for w_kind in ("near0", "near1", "model"):
                args = wkv6_inputs(torch, rng, b, t, 3, dk, dv, w_kind, dev)
                got = wkv6_cuda(*args)
                torch.cuda.synchronize()
                name = f"B={b}/T={t}/dk={dk}/dv={dv}/w={w_kind}"
                err = max(err, rec_err(name, got, wkv6_ref(*args)))
                cases.append(name)
    return cases, err


def mamba_inputs(torch, rng, b, t, di, n, dev="cuda"):
    """Random u, b, c, d, a non-zero h0, delta = softplus(N(-1, 1)) and
    a = -exp(log U(0.5, 16)) (decays in (0, 1), as the model's)."""
    f = np.float32
    u = rng.normal(size=(b, t, di)).astype(f)
    delta = np.log1p(np.exp(rng.normal(-1, 1, size=(b, t, di)))).astype(f)
    a = -rng.uniform(0.5, 16, size=(di, n)).astype(f)
    bb, cc = (rng.normal(size=(b, t, n)).astype(f) for _ in "bc")
    d = rng.normal(size=di).astype(f)
    h0 = rng.normal(size=(b, di, n)).astype(f)
    return [torch.from_numpy(x).to(dev) for x in (u, delta, a, bb, cc, d,
                                                   h0)]


def mamba_edge_checks(torch, rng, dev="cuda") -> tuple[list, float]:
    """The selective-scan kernel vs its plain version: T = 1, 2, 7, 31,
    32, 33, 64 and 517 (about the kernel's 32-step chunk) with B = 2 (1 at
    T = 517) and the decode shape B = 8, T = 1, a non-zero initial state;
    (di, n) = (40, 4), (100, 16), (200, 16), (72, 64), (76, 64), (100, 12)
    and (36, 3): one to 16 lanes a channel, some lanes partly past n, and
    di off the block's channel group (128 / lanes) and off 32 and 128."""
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_cuda
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    cases, err = [], 0.0
    runs = [(2, t) for t in (1, 2, 7, 31, 32, 33, 64)] + [(1, 517), (8, 1)]
    for b, t in runs:
        for di, n in ((40, 4), (100, 16), (200, 16), (72, 64), (76, 64),
                      (100, 12), (36, 3)):
            args = mamba_inputs(torch, rng, b, t, di, n, dev)
            got = mamba_scan_cuda(*args)
            torch.cuda.synchronize()
            name = f"B={b}/T={t}/di={di}/n={n}"
            err = max(err, rec_err(name, got, mamba_scan_ref(*args)))
            cases.append(name)
    return cases, err


WKV6_F64_FACTOR = 8     # kernel within 8x the plain version's error: rounding


def wkv6_f64(r, k, v, w, u, s0):
    """``wkv6_ref``'s recurrence evaluated in float64 (``wkv6_ref`` takes
    float32 only): ``(y, s_T)``."""
    import torch
    r, k, v, w, u, s = (x.double() for x in (r, k, v, w, u, s0))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append((r[:, t, :, :, None] * (s + u[None, :, :, None] * kv)
                   ).sum(2))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, 1), s


def wkv6_float64(torch, name: str, caps: dict, active: list, kern, plain
                 ) -> dict:
    """The kernel and its plain version against a float64 evaluation of
    the same recurrence on the captured inputs of step 0 (slots 4..7
    idle, from a zero state) and of the first step after the re-admit
    (idle slots carrying the state of their forced tokens), first and
    last layer: the largest |result - float64| of y and of the state over
    the active and over the idle slots, with the largest |float64| value
    there beside it. The idle slots' divergence between engines is
    rounding if the kernel's error there is within ``WKV6_F64_FACTOR`` of
    the plain version's."""
    out = {"phase": f"{name}.wkv6_float64", "factor": WKV6_F64_FACTOR}
    ratios = []
    for op, i in (("step0", 0), (f"step{LM_STEPS[0]}", LM_STEPS[0])):
        live = active[i].to(caps[op].args[0][0][0].device)
        out[op] = {"active_slots": [int(x) for x in live.nonzero()]}
        for li, (args, _) in caps[op].args.items():
            exact = wkv6_f64(*args)
            res = {"kernel": kern(*args), "plain": plain(*args)}
            torch.cuda.synchronize()
            entry = {}
            for part, j in (("y", 0), ("state", 1)):
                for where, mask in (("active", live), ("idle", ~live)):
                    if not bool(mask.any()):
                        continue
                    ref = exact[j][mask]
                    top = float(ref.abs().max())
                    errs = {who: float((r[j][mask].double() - ref).abs()
                                       .max()) for who, r in res.items()}
                    # the plain error, floored at one float32 rounding of
                    # the largest value, so that an exact plain result
                    # does not make any error look large
                    floor = max(errs["plain"], 2.0 ** -24 * top, 1e-300)
                    entry[f"{part}_{where}"] = {
                        **errs, "max_abs_float64": top,
                        "kernel_over_plain": errs["kernel"] / floor}
                    if where == "idle":
                        ratios.append(entry[f"{part}_{where}"]
                                      ["kernel_over_plain"])
            out[op][li] = entry
    out["verdict"] = ("rounding" if max(ratios) <= WKV6_F64_FACTOR
                      else "beyond rounding: csrc/wkv6.cu")
    out["worst_idle_kernel_over_plain"] = max(ratios)
    return out


def wkv6_work(r, k, v, w, u, s0) -> tuple:
    """(bytes, flops, 0) of one WKV6 call: ``ops.work``, the formula of the
    kernel's ``meta`` route."""
    from repro_torch.kernels.wkv6.ops import work
    return work(r, k, v, w, u, s0)


def mamba_work(u, delta, a, b, c, d, h0) -> tuple:
    """(bytes, flops, exps) of one selective-scan call: ``ops.work``, the
    formula of the kernel's ``meta`` route."""
    from repro_torch.kernels.mamba_scan.ops import work
    return work(u, delta, a, b, c, d, h0)


def rec_row(name, source, replaces, launches, err, ms, plain_ms, work,
            hbm) -> dict:
    """A ``kernels`` line entry: the bound is the largest of the bytes
    over the HBM rate, the flops over the fp32 peak and the exps over the
    SFU rate."""
    bytes_, flops, exps = work
    if exps / SFU_RATE > flops / FP32_PEAK:
        return row(name, source, replaces, launches, err, ms, plain_ms,
                   bytes_, exps, hbm, peak=SFU_RATE)
    return row(name, source, replaces, launches, err, ms, plain_ms, bytes_,
               flops, hbm)


class Router:
    """While entered, wrap ``mlp.moe_route``: engine 0's calls record
    their top-k experts; every other engine's calls record what they would
    choose and then take engine 0's choice, their own probabilities
    renormalised over it, so that the engines differ only by the kernels'
    arithmetic and the share of routing decisions that rounding flips is
    measured without its cascade.

    A call takes engine 0's choice of the same call (its index since
    ``begin``). Where ``begin`` is given ``pos``, the position of the
    call's first token in one sequence, each token instead takes engine
    0's choice at its position in the same MoE layer, and a pair that
    engine 0's expert capacity (``mlp.capacity`` of its call's token
    count) dropped gets weight 0: a prefill of many tokens, which may drop
    pairs, then pins the one-token steps that decode the same positions,
    which never drop one; ``decisions`` and ``flipped`` count those
    steps' choices and the ones their own routing would have changed."""

    def __init__(self, mlp_mod, engines: int = 2):
        self.mod, self.orig = mlp_mod, mlp_mod.moe_route
        self.engine, self.pos, self.calls = 0, None, [
            [] for _ in range(engines)]
        self.pins, self.dropped, self.decisions, self.flipped = {}, 0, 0, 0

    def begin(self, engine: int, pos: int | None = None) -> None:
        self.engine, self.pos = engine, pos
        self.calls[engine].clear()

    def kept(self, cfg, tope):
        """Which of ``tope``'s [N, K] pairs ``apply_moe`` keeps: ranked in
        token order within each expert, below the capacity."""
        import torch
        n, k = tope.shape
        ek = tope.reshape(n * k)
        order = torch.sort(ek, stable=True).indices
        se = ek[order]
        rank = torch.arange(n * k, device=ek.device) - torch.searchsorted(
            se, se, side="left")
        keep = torch.zeros(n * k, dtype=torch.bool, device=ek.device)
        keep[order] = rank < self.mod.capacity(cfg, n)
        return keep.reshape(n, k)

    def __enter__(self):
        import torch

        def hook(p, cfg, plan, xf):
            probs, topw, tope = self.orig(p, cfg, plan, xf)
            mine = self.calls[self.engine]
            mine.append(tope)
            layer, n = len(mine) - 1, tope.shape[0]
            if self.engine == 0:
                if self.pos is not None:
                    keep = self.kept(cfg, tope)
                    self.dropped += int((~keep).sum())
                    for i in range(n):
                        self.pins[self.pos + i, layer] = (tope[i], keep[i])
                return probs, topw, tope
            keep = None
            if self.pos is None:
                forced = self.calls[0][layer]
            else:
                forced, keep = (torch.stack(t) for t in zip(*(
                    self.pins[self.pos + i, layer] for i in range(n))))
                self.decisions += n
                self.flipped += int((tope.sort(-1).values != forced.sort(
                    -1).values).any(-1).sum())
            w = probs.gather(1, forced)
            w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
            return probs, w if keep is None else w * keep.to(w.dtype), forced
        self.mod.moe_route = hook
        return self

    def __exit__(self, *exc):
        self.mod.moe_route = self.orig

    def differing(self, rows, engines) -> tuple[int, int]:
        """(decisions whose expert set differs, decisions) between the two
        ``engines``' own choices over the last operation's calls; ``rows``
        restricts each call to those tokens."""
        diff = total = 0
        for a, b in zip(*(self.calls[e] for e in engines)):
            a, b = a.sort(-1).values, b.sort(-1).values
            if rows is not None:
                a, b = a[rows], b[rows]
            diff += int((a != b).any(-1).sum())
            total += a.shape[0]
        return diff, total


def serve_lockstep(torch, engines, prompts, forced, on_op, begin,
                   dev="cuda", traffic: dict = LM_TRAFFIC) -> dict:
    """Drive ``engines`` through ``traffic`` (:func:`lm_operations`)
    together, one operation on each in turn, calling ``begin(i)`` before
    engine i's share and ``on_op(op)`` after each operation. Returns each
    engine's ``(op, ms)`` list."""
    ms = {i: [] for i in range(len(engines))}
    for op, call in lm_operations(prompts, torch.from_numpy(forced).to(dev),
                                  traffic):
        for i, eng in enumerate(engines):
            begin(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = call(eng)
            torch.cuda.synchronize()
            ms[i].append((op, (time.perf_counter() - t0) * 1e3))
            check(ok is not False, f"{op} refused on engine {i}")
        on_op(op)
    return ms


def rnn_config(spec: dict):
    """The phase's model: the published config, cut in depth where
    ``spec["cut"]`` says so."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch(spec["arch"])
    return cfg if spec["cut"] is None else dataclasses.replace(
        cfg, n_layers=spec["cut"])


def phase_rnn(torch, name: str, seed: int, hbm: float, dev="cuda"
              ) -> tuple[list, list]:
    """Serve ``RNN_PHASES[name]`` at full width through PagedLMEngine on
    the card: the recurrence kernel's edge sets, the traffic (a throwaway
    first pass, then the measured one with every launch count zeroed), the
    kernel against its plain version on the path's own inputs (first and
    last layer of the 2048-token admit, of the first step and of the first
    step after the re-admit), each slot to its own limit, with a planted
    control (the last of those steps from a zeroed state, the reference's
    own kernel path), and the traffic once more in float32 beside an
    ``attn_impl="ref"`` engine, held to it after every operation, and a
    rounding-level control engine (reported)."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.mamba_scan import mamba_scan as sk
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6 import wkv6 as wk
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.models import model as M
    from repro_torch.models.model import init_params
    from repro_torch.serve.paged_lm import PagedLMEngine
    from repro_torch.sharding.rules import unpadded_plan
    spec = RNN_PHASES[name]
    kname, kind = spec["kernel"], spec["kind"]
    if kname == "wkv6":
        ops_mod, kmod, kern, plain = wops, wk, wk.wkv6_cuda, wkv6_ref
        src, rep, edge, work = WKV6_SRC, WKV6_REP, wkv6_edge_checks, \
            wkv6_work
    else:
        ops_mod, kmod, kern, plain = sops, sk, sk.mamba_scan_cuda, \
            mamba_scan_ref
        src, rep, edge, work = SCAN_SRC, SCAN_REP, mamba_edge_checks, \
            mamba_work
    t_phase = time.perf_counter()
    cases, edge_err = edge(torch, np.random.default_rng(seed + 15), dev)

    cfg = rnn_config(spec)
    plan = unpadded_plan(cfg)
    kinds = M.layer_kinds(cfg)
    n_kind = kinds.count(kind)
    last = n_kind - 1
    prompts, forced = lm_traffic(seed, cfg.vocab_size)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, init_ms = timed(lambda: init_params(cfg, plan, seed=seed,
                                                device=dev))
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    warm = PagedLMEngine(cfg, plan, params, device=dev, **LM_ENGINE)
    cold = serve_lm(torch, warm, prompts, forced, dev=dev)
    profile = {"decode_step": device_profile(torch, warm.step, reps=2),
               "admit_129": device_profile(
                   torch, lambda: warm.admit(len(LM_PROMPTS), prompts[3]))}
    del warm
    eng = PagedLMEngine(cfg, plan, params, device=dev, **LM_ENGINE)
    readmit_step = f"step{LM_STEPS[0]}"
    caps = {op: Capture(ops_mod, kname, (0, last))
            for op in ("admit0", "step0", readmit_step)}
    zero_counts()                                # counts of this path
    t0 = time.perf_counter()
    got = serve_lm(torch, eng, prompts, forced, caps, dev)
    path_s = time.perf_counter() - t0
    n_ops = len(LM_PROMPTS) + 1 + sum(LM_STEPS)
    launches = {kname: kmod.launches}
    check(kmod.launches == n_kind * n_ops, f"{kname} launches "
          f"{kmod.launches} != {n_kind} layers x {n_ops} admits and steps")
    if "attn" in kinds:
        n_attn = kinds.count("attn")
        launches.update(flash_attention=fk.launches,
                        paged_attention=pk.launches)
        check(fk.launches == n_attn * (len(LM_PROMPTS) + 1) and
              pk.launches == n_attn * sum(LM_STEPS),
              f"attention launches {launches} on {n_attn} layers")
    peak = torch.cuda.max_memory_allocated() - base
    steps = np.array(got["step_ms"])
    after = steps[LM_STEPS[0]:]
    active = [int(a.sum()) for a in got["active"]]
    line = {
        "phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
        "layer_kinds": {k: kinds.count(k) for k in M.KINDS},
        "moe_layers": sum(cfg.is_moe_layer(li % cfg.layer_period)
                          for li in range(cfg.n_layers)),
        "reduced": None if spec["cut"] is None else {
            "n_layers": f"{cfg.n_layers} of "
                        f"{rnn_config(dict(spec, cut=None)).n_layers}: "
                        "one period; the published model is "
                        f"{rnn_config(dict(spec, cut=None)).param_count()} "
                        "parameters, over 80 GB in bf16"},
        "dtype": cfg.dtype, "params": cfg.param_count(),
        "param_bytes": param_bytes, "engine": LM_ENGINE,
        "init_params_ms": init_ms, "edge_cases": cases,
        "edge_max_abs_err": edge_err, "admit": got["admit"],
        "decode_steps": sum(LM_STEPS), "step_ms": got["step_ms"],
        "step_ms_median": float(np.median(steps)),
        "step_ms_median_before_slide": float(np.median(
            steps[:LM_STEPS[0]])),
        "step_ms_median_after_readmit": float(np.median(after)),
        "decode_tokens_per_s_median": float(np.median(
            np.array(active) / steps * 1e3)),
        "first_pass": {"admit_ms": [a["ms"] for a in cold["admit"]],
                       "step_ms_first": cold["step_ms"][0],
                       "step_ms_median": float(np.median(cold["step_ms"]))},
        "profile": profile, "slide": got["slide"], "evict": got["evict"],
        "peak_device_bytes": peak, "launches": launches,
        "path_seconds": path_s}
    for what, wall in (("decode_step", float(np.median(after))),
                       ("admit_129", got["admit"][3]["ms"])):
        busy = profile[what]["device_ms_per_call"]
        if busy is not None:            # against the unprofiled run's time
            profile[what]["idle_share"] = 1 - busy / wall

    # the kernel vs its plain version on the path's own inputs; the
    # control: the decode step from a zeroed state
    full = {"limit": f"{REC_RTOL}*|plain| + {REC_ATOL}*RMS(plain) over "
                     "each slot"}
    for op, cap in caps.items():
        check(set(cap.args) == {0, last}, f"{name} {op}: captured layers "
              f"{sorted(cap.args)}")
        entry = {"shapes": [list(a.shape) for a in cap.args[0][0]],
                 "max_abs_err_by_layer": {}, "rms_plain_by_layer": {}}
        for li, (args, _) in cap.args.items():
            k_out = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            entry["max_abs_err_by_layer"][li] = rec_err(
                f"{kname} {op} layer {li} at full width", k_out, want)
            entry["rms_plain_by_layer"][li] = float(
                want[0].square().mean().sqrt())
            if op == readmit_step:
                zeroed = args[:-1] + [torch.zeros_like(args[-1])]
                entry.setdefault("control_zero_state_by_layer", {})[li] = \
                    rec_control(f"{kname} {op} layer {li} from a zeroed "
                                "state", k_out, plain(*zeroed))
        full[op] = entry
    fa = caps["admit0"].args[0][0]
    da = caps[readmit_step].args[0][0]
    scratch = torch.empty(1 << 26, dtype=torch.float32, device=dev)
    flush = scratch.zero_
    timing = {}
    for op, args in (("admit0", fa), (readmit_step, da)):
        timing[op] = {
            "ms": cuda_median_ms_cold(lambda: kern(*args), 20, flush),
            "ms_l2_warm": cuda_median_ms(lambda: kern(*args), 20),
            "plain_ms": cuda_ms(lambda: plain(*args), reps=2)}
        b_, f_, e_ = work(*args)
        bound = max(b_ / hbm, f_ / FP32_PEAK, e_ / SFU_RATE) * 1e3
        timing[op].update(bytes=b_, flops=f_, exps=e_, bound_ms=bound,
                          pct_of_bound=bound / timing[op]["ms"] * 100)
    del scratch
    full["timing"] = timing
    f64_line = wkv6_float64(torch, name, caps, got["active"], kern, plain) \
        if kname == "wkv6" else None
    err = max(max(full[op]["max_abs_err_by_layer"].values())
              for op in caps)
    rows = [rec_row(kname, src, rep, launches[kname], err,
                    timing["admit0"]["ms"], timing["admit0"]["plain_ms"],
                    work(*fa), hbm)]
    full_line = {"phase": f"{name}.kernels_full_width", **full}
    del caps, fa, da, eng, got, params
    torch.cuda.empty_cache()
    vs_ref, dense = engines_vs_ref(torch, name, cfg, plan, prompts, forced,
                                   seed, dev)
    line["phase_seconds"] = time.perf_counter() - t_phase
    return [ln for ln in (line, full_line, f64_line, vs_ref, dense)
            if ln], rows


def engines_vs_ref(torch, name: str, cfg, plan, prompts, forced, seed: int,
                   dev="cuda") -> tuple[dict, dict]:
    """``RNN_VS_REF_TRAFFIC`` in float32 on a kernel engine, an
    ``attn_impl="ref"`` engine and a control (the ref engine with its plain
    recurrence's output moved by ``CONTROL_REL N(0, 1)`` relative, a
    rounding-level change) side by side. After every operation the page
    states must be equal and the kernel engine's logits and recurrent
    states of the active slots within ``RNN_F32_RTOL`` of the ref engine's;
    the control's, and the idle slots' of both, are reported. For an MoE
    model the other engines take the kernel engine's experts (:class:`Router`)
    and the share of their own choices that differ is counted. Then, on
    the same float32 weights, :func:`dense_vs_paged` within
    ``RNN_F32_RTOL``. Returns the two lines."""
    import dataclasses

    from repro_torch.interop import page_state_to_numpy
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.models.model import init_params
    from repro_torch.serve.paged_lm import PagedLMEngine
    kind = RNN_PHASES[name]["kind"]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, plan, seed=seed, device=dev)
    trio = [PagedLMEngine(cfg32, plan, params, device=dev, attn_impl=impl,
                          **LM_ENGINE) for impl in ("kernel", "ref", "ref")]
    rec_mod, rec_attr = (rwkv_mod, "wkv6_ref") if kind == "rwkv" else \
        (mamba_mod, "mamba_scan_ref")
    rec_plain = getattr(rec_mod, rec_attr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def moved(*args):
        y, st = rec_plain(*args)
        noise = torch.randn(y.shape, generator=gen, device=y.device)
        return y * (1 + CONTROL_REL * noise), st

    router = Router(mlp_mod, len(trio)) if cfg.moe else None

    def begin(i):
        if router is not None:
            router.begin(i)
        setattr(rec_mod, rec_attr, moved if i == 2 else rec_plain)

    worst = {f"{who}_{where}": {} for who in ("kernel", "control")
             for where in ("active", "idle")}
    seen = {"ops": 0, "rows": 0, "top1": 0, "route_kernel": 0,
            "route_control": 0, "route_total": 0}
    mean_rel = []

    def views(e, op):                   # name -> [slot, ...]
        out = {f"{kd}[{j}]": pool.transpose(0, 1)
               for kd, pools in e.state.items()
               for j, pool in enumerate(pools)}
        if op.startswith("step"):
            out["logits"] = e.logits[:, 0]
        return out

    def on_op(op):
        planes = [page_state_to_numpy(e.pages) for e in trio]
        for plane in planes[0]:
            check(all(np.array_equal(planes[0][plane], p[plane])
                      for p in planes[1:]),
                  f"{name} vs ref: page state after {op}: plane {plane} "
                  "differs")
        live = trio[0].pages.active
        check(torch.equal(live, trio[1].pages.active),
              f"{op}: active slots differ")
        idle = ~live
        ref = views(trio[1], op)
        for who, eng in (("kernel", trio[0]), ("control", trio[2])):
            got = views(eng, op)
            for key, r in ref.items():
                g = got[key]
                check(bool(g.isfinite().all() and r.isfinite().all()),
                      f"{op}: non-finite {key}")
                rel = float((g[live] - r[live]).abs().max()
                            / r[live].abs().max().clamp(min=1e-30))
                act = worst[f"{who}_active"]
                act[key] = max(act.get(key, 0.0), rel)
                if who == "kernel":
                    check(rel <= RNN_F32_RTOL, f"{name} vs ref after {op}: "
                          f"{key} of the active slots differs by {rel} of "
                          f"max |ref|, above {RNN_F32_RTOL}")
                if bool(idle.any()):     # against max |ref| over all slots
                    rel = float((g[idle] - r[idle]).abs().max()
                                / r.abs().max().clamp(min=1e-30))
                    off = worst[f"{who}_idle"]
                    off[key] = max(off.get(key, 0.0), rel)
        rows = None
        if op.startswith("step"):
            lk, lr = trio[0].logits[:, 0][live], ref["logits"][live]
            mean_rel.append(float((lk - lr).abs().mean()
                                  / lr.abs().mean()))
            seen["top1"] += int((lk.argmax(-1) == lr.argmax(-1)).sum())
            seen["rows"] += lk.shape[0]
            rows = live
        if router is not None:
            for who, pair in (("kernel", (0, 1)), ("control", (1, 2))):
                d, n = router.differing(rows, pair)
                seen[f"route_{who}"] += d
            seen["route_total"] += n
        seen["ops"] += 1

    t0 = time.perf_counter()
    try:
        with router or contextlib.nullcontext():
            ms = serve_lockstep(torch, trio, [
                p[:n] for p, n in zip(prompts, RNN_VS_REF_TRAFFIC["prompts"]
                                      + (RNN_VS_REF_TRAFFIC["readmit"],))],
                forced, on_op, begin, dev, RNN_VS_REF_TRAFFIC)
    finally:
        setattr(rec_mod, rec_attr, rec_plain)
    vs_ref = {"phase": f"{name}.vs_ref", "dtype": "float32",
              "lockstep_traffic": RNN_VS_REF_TRAFFIC,
              "lockstep_seconds": time.perf_counter() - t0,
              "kernel_step_ms_median": float(np.median(
                  [m for op, m in ms[0] if op.startswith("step")])),
              "ref_step_ms_median": float(np.median(
                  [m for op, m in ms[1] if op.startswith("step")])),
              "ref_admit_ms": [m for op, m in ms[1]
                               if op.startswith("admit")],
              "page_states_equal": True, "operations": seen["ops"],
              "logits_finite": True,
              "max_rel_logit_err": worst["kernel_active"]["logits"],
              "mean_rel_logit_err": float(np.mean(mean_rel)),
              "max_rel_state_err": {k: v for k, v in
                                    worst["kernel_active"].items()
                                    if k != "logits"},
              "rtol": RNN_F32_RTOL,
              "top1_agreement": seen["top1"] / seen["rows"],
              "rows_compared": seen["rows"],
              "control": f"the ref engine, its recurrence's output x (1 + "
                         f"{CONTROL_REL} N(0, 1)); idle slots against max "
                         "|ref| over every slot",
              "max_rel_err_vs_ref": worst}
    if router is not None:
        vs_ref.update(routing="the ref and control engines take the kernel "
                      "engine's experts; their own choices are counted",
                      routing_decisions=seen["route_total"],
                      routing_decisions_differing=seen["route_kernel"],
                      routing_share_differing=seen["route_kernel"]
                      / max(seen["route_total"], 1),
                      routing_share_differing_control_vs_ref=seen[
                          "route_control"] / max(seen["route_total"], 1))
    del trio
    torch.cuda.empty_cache()
    dense = dense_vs_paged(torch, name, cfg32, plan, params, seed,
                           RNN_F32_RTOL, dev)
    del params
    torch.cuda.empty_cache()
    return vs_ref, dense


# ---------------------------------------------------------------------------
# The decoder-only architectures registered beside Llama: flash and paged
# attention (TPU kernels 6 and 5) at their shapes (MiniCPM3's MLA on
# latent pages among them), the MoE combine in a fixed order (Granite;
# Moonlight's with its shared experts), LLaVA's image-patch prefix
# ---------------------------------------------------------------------------

ARCH_PHASES = ("qwen3-14b", "phi3-medium-14b", "granite-moe-3b-a800m",
               "minicpm3-4b", "moonshot-v1-16b-a3b", "llava-next-34b")
ARCH_TRAFFIC = dict(prompts=(2048, 517), readmit=None, steps=(16,))
ARCH_LAUNCHES: dict = {}       # kernels 5 / 6: each architecture's launches
DENSE_ARCHS = ("minicpm3-4b",)  # MLA's dense decode beside its engine


def phase_arch(torch, name: str, seed: int, dev="cuda") -> list:
    """Serve one architecture at full width in bf16 (random weights from
    ``seed``) through PagedLMEngine on ``ARCH_TRAFFIC``: a counted run on
    the kernels, whose flash calls of the first admit and paged calls of
    the last step (first and last layer) are held to their plain versions
    by :func:`full_width_checks`; the same traffic through
    ``attn_impl="ref"`` (the plain attention versions, taking the first
    run's experts where the model has MoE layers) held to it within
    ``LM_LOGIT_RTOL``; then the kernel run again, whose logits must be
    ``==`` the first. The repeat's times are the warm ones. A vision-stub
    model's first admit carries its ``n_prefix_embeds`` image-patch
    embeddings, ``N(0, 1)`` from ``seed``. Last, each kernel's layer-0
    call of the first run is timed with the L2 flushed (``kernel_times``:
    beside its bound, its plain version and, for flash, SDPA)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.models import attention as attn
    from repro_torch.models import mlp
    from repro_torch.models.model import init_params
    from repro_torch.serve.paged_lm import PagedLMEngine
    from repro_torch.sharding.rules import unpadded_plan
    cfg = get_arch(name)
    plan = unpadded_plan(cfg)
    prompts, forced = lm_traffic(seed, cfg.vocab_size, ARCH_TRAFFIC)
    prefix = None
    if cfg.frontend == "vision_stub":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        prefix = torch.randn((cfg.n_prefix_embeds, cfg.d_model),
                             generator=gen, device=dev).to(
                                 getattr(torch, cfg.dtype))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, init_ms = timed(lambda: init_params(cfg, plan, seed=seed,
                                                device=dev))
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())

    n_admits, n_steps = len(ARCH_TRAFFIC["prompts"]), sum(
        ARCH_TRAFFIC["steps"])
    layers = (0, cfg.n_layers - 1)
    caps = {"flash_attention": Capture(fops, "flash_attention", layers),
            "paged_attention": Capture(pops, "paged_attention", layers)}

    def run(captures=None, **kw):
        eng = PagedLMEngine(cfg, plan, params, device=dev, **LM_ENGINE, **kw)
        out = serve_lm(torch, eng, prompts, forced, captures, dev=dev,
                       traffic=ARCH_TRAFFIC, prefix=prefix)
        out["pool_bytes"] = engine_pool_bytes(eng)
        return out

    t0 = time.perf_counter()
    with Router(mlp) as router:
        router.begin(0)
        zero_counts()                                # counts of this path
        got = run({"admit0": caps["flash_attention"],
                   f"step{n_steps - 1}": caps["paged_attention"]})
        launches = {"flash_attention": fk.launches,
                    "flash_attention[tensor_core]": fk.launches_tensor_core,
                    "flash_attention[simt]": fk.launches_simt,
                    "paged_attention": pk.launches}
        peak = torch.cuda.max_memory_allocated() - base
        full = full_width_checks(torch, caps, layers)
        times = arch_kernel_times(
            torch, caps, dev,
            dv=cfg.v_head_dim if cfg.attention == "mla" else None)
        del caps
        router.begin(1)
        ref = run(attn_impl="ref")
        flips, decisions = router.differing(None, (0, 1))
    path_s = time.perf_counter() - t0
    check(launches["flash_attention"] == cfg.n_layers * n_admits,
          f"{name}: flash launches {launches['flash_attention']} != "
          f"{cfg.n_layers} x {n_admits} admits")
    check(launches["flash_attention[tensor_core]"]
          == launches["flash_attention"],
          f"{name}: flash launches {launches}: not all on tensor_core")
    check(launches["paged_attention"] == cfg.n_layers * n_steps,
          f"{name}: paged launches {launches['paged_attention']} != "
          f"{cfg.n_layers} x {n_steps} steps")
    ARCH_LAUNCHES[name] = launches
    vs_ref = logits_vs(torch, got, ref)
    check(vs_ref["max_rel_logit_err"] <= LM_LOGIT_RTOL,
          f"{name}: decode logits: max |kernel - ref| is "
          f"{vs_ref['max_rel_logit_err']} of max |ref|, above "
          f"{LM_LOGIT_RTOL}")
    del ref
    again = run()
    repeat = logits_vs(torch, got, again)
    check(repeat["logits_equal"], f"{name}: a second run from the same "
          f"seed and inputs gave other logits: {repeat}")
    steps = np.array(again["step_ms"])
    active = [int(a.sum()) for a in again["active"]]
    line = {
        "phase": f"arch.{name}", "arch": name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "head_dim": cfg.head_dim, "qk_norm": cfg.qk_norm,
        "moe": [cfg.n_experts, cfg.moe_top_k] if cfg.moe else None,
        "mla": {"q_lora": cfg.q_lora_rank, "kv_lora": cfg.kv_lora_rank,
                "qk_nope": cfg.qk_nope_dim, "qk_rope": cfg.qk_rope_dim,
                "v_head": cfg.v_head_dim,
                "page_dk_dv": list(attn.mla_page_dims(cfg)[1:]),
                "scale": cfg.qk_head_dim ** -0.5}
        if cfg.attention == "mla" else None,
        "shared_experts": cfg.n_shared_experts if cfg.moe else None,
        "prefix_embeds": None if prefix is None else list(prefix.shape),
        "reduced": None,
        "dtype": cfg.dtype, "params": cfg.param_count(),
        "param_bytes": param_bytes, "pool_bytes": got["pool_bytes"],
        "engine": LM_ENGINE, "traffic": ARCH_TRAFFIC,
        "init_params_ms": init_ms,
        "admit": again["admit"], "admit_first_run": got["admit"],
        "step_ms": again["step_ms"],
        "step_ms_median": float(np.median(steps)),
        "step_ms_median_first_run": float(np.median(got["step_ms"])),
        "decode_tokens_per_s_median": float(np.median(
            np.array(active) / steps * 1e3)),
        "peak_device_bytes": peak, "launches": launches,
        "kernels_full_width": full, "kernel_times": times,
        "vs_ref": {**vs_ref, "logit_rtol": LM_LOGIT_RTOL,
                   "page_states_equal": True,
                   "moe_decisions_ref_would_change": flips,
                   "moe_decisions": decisions},
        "repeat": repeat,
        "path_seconds": path_s}
    del got, again
    torch.cuda.empty_cache()
    lines = [line]
    if name in DENSE_ARCHS:
        lines.append(dense_vs_paged(torch, f"arch.{name}", cfg, plan, params,
                                    seed, LM_LOGIT_RTOL, dev))
    del params, prefix
    torch.cuda.empty_cache()
    return lines


def kernel_time(torch, name: str, args, kw, flush, hbm: float, dv=None
                ) -> dict:
    """Kernel 5 or 6 on one captured call: the median of 20 launches each
    after ``flush`` (a 256 MB write: the L2 flushed, as the kernels line
    times them) and warm, the plain version's time, the bound
    (:func:`row`'s: bytes over the memory rate or flops over the
    operands' :func:`peak_of`, whichever is longer) on these inputs, and
    for flash SDPA on the same q, k, v, scale and mask. ``dv`` is the V
    width the architecture needs where flash is given V zero-padded
    (MLA)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    kern, plain = (pk.paged_attention_cuda, paged_attention_ref) \
        if name == "paged_attention" else (fk.flash_attention_cuda, mha_ref)
    peak = peak_of(torch, args[0].dtype)
    causal = kw.get("causal", True)
    if name == "paged_attention":
        bytes_, flops, _ = paged_work(*args)
    else:
        bytes_, flops = flash_work(args[0], args[1], causal, dv=dv)
    ms = cuda_median_ms_cold(lambda: kern(*args, **kw), 20, flush)
    r = row(name, "", "", 0, 0.0, ms, cuda_ms(lambda: plain(*args, **kw),
                                              reps=3),
            bytes_, flops, hbm, peak=peak)
    out = {"shapes": [list(a.shape) for a in args if hasattr(a, "shape")],
           "scale": kw.get("scale"), "ms": ms,
           "ms_l2_warm": cuda_median_ms(lambda: kern(*args, **kw), 20),
           "plain_ms": r["plain_ms"], "bytes": bytes_, "flops": flops,
           "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
           "pct_of_bound": r["bound_ms"] / ms * 100,
           "achieved_tflops": flops / ms / 1e9}
    if name == "flash_attention":
        q, k, v = args
        out["causal"] = causal
        out["sdpa_bf16_ms"] = cuda_median_ms_cold(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True,
                scale=kw.get("scale")), 20, flush)
        out["route"] = fk.route(q.dtype, q.shape[-1])
    return out


def arch_kernel_times(torch, caps: dict, dev="cuda", dv=None) -> dict:
    """:func:`kernel_time` of kernels 5 and 6 on their captured layer-0
    calls."""
    hbm = hbm_bytes_per_s(torch.cuda.get_device_name(0))
    scratch = torch.empty(1 << 26, dtype=torch.float32, device=dev)
    out = {name: kernel_time(torch, name, *caps[name].args[0],
                             scratch.zero_, hbm, dv=dv)
           for name in ("paged_attention", "flash_attention")}
    del scratch
    return out


# ---------------------------------------------------------------------------
# Dense-cache decode beside the paged engine (kernel 5, and kernels 8 and 7
# at T = 1), Whisper (kernel 6 in its encoder, decoder and cross-attention
# prefill, kernel 5 over its self and cross caches at decode), and the
# trainer (no kernel: autograd over the plain paths)
# ---------------------------------------------------------------------------

DENSE_TRAFFIC = dict(prompt=32, steps=16)    # one sequence: prompt, then fed
DENSE_LAUNCHES: dict = {}      # kernels 5, 7, 8: each phase's dense decode


def dense_calls(kinds: list, positions) -> dict:
    """Kernel 5's calls in a dense decode of one sequence (layer
    ``kinds``) that :func:`dense_vs_paged` holds to the plain version, by
    call index: the first and last attention layer at each of
    ``positions`` (one call per attention layer and position)."""
    n_attn = kinds.count("attn")
    return {pos * n_attn + j: f"pos {pos} attn layer {j}"
            for pos in positions for j in sorted({0, n_attn - 1})}


def dense_vs_paged(torch, name: str, cfg, plan, params, seed: int,
                   rtol: float, dev="cuda") -> dict:
    """One sequence of ``DENSE_TRAFFIC`` through ``PagedLMEngine`` (admit
    the prompt, then the fed tokens step by step) and through
    ``init_decode_cache`` + ``decode_step`` from position 0, on the same
    parameters; an MoE model's dense decode takes the engine's experts
    (:class:`Router` by position). Counts the dense run's launches (kernel
    5 on each attention layer, kernels 8 and 7 at T = 1 on each recurrent
    one, every position; kernel 6 none), holds kernel 5 to its plain
    version on the dense run's own inputs (:func:`full_width_checks` at
    :func:`dense_calls`: the first and last attention layer at the first
    position, the first fed one and the last, each with its one-slot-short
    control), and holds the dense logits of the fed positions within
    ``rtol`` of max |paged logit|, with a control (each dense step against
    the engine's next one) the check must refuse."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.mamba_scan import mamba_scan as sk
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.kernels.wkv6 import wkv6 as wk
    from repro_torch.models import mlp
    from repro_torch.models import model as M
    from repro_torch.serve.paged_lm import PagedLMEngine
    n, steps = DENSE_TRAFFIC["prompt"], DENSE_TRAFFIC["steps"]
    toks = np.random.default_rng(seed + 27).integers(
        1, cfg.vocab_size, n + steps).astype(np.int32)
    page = LM_ENGINE["page_size"]
    pages = -(-(n + steps + 1) // page)
    kinds = M.layer_kinds(cfg)
    at = dense_calls(kinds, (0, n, n + steps - 1)) if "attn" in kinds else {}
    cap = Capture(pops, "paged_attention", at)
    paged, paged_ms, dense, dense_ms = [], [], [], []
    with Router(mlp) as pins:
        eng = PagedLMEngine(cfg, plan, params, device=dev, page_size=page,
                            n_pages=pages, max_seqs=1,
                            max_pages_per_seq=pages)
        pins.begin(0, 0)
        check(eng.admit(0, toks[:n]), f"{name}: admit of {n} refused")
        for i in range(steps):
            pins.begin(0, n + i)
            eng.last_tokens[0, 0] = int(toks[n + i])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            paged_ms.append((time.perf_counter() - t0) * 1e3)
            paged.append(eng.logits[0, 0].float().clone())
        del eng
        caches = M.init_decode_cache(cfg, plan, 1, n + steps, device=dev)
        zero_counts()                           # counts of the dense run
        with cap:
            for pos, tok in enumerate(toks):
                pins.begin(1, pos)
                x = torch.tensor([[int(tok)]], dtype=torch.int32, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = M.decode_step(params, cfg, plan, x, caches,
                                               pos)
                torch.cuda.synchronize()
                dense_ms.append((time.perf_counter() - t0) * 1e3)
                if pos >= n:
                    dense.append(logits[0, 0].float().clone())
    launches = {"paged_attention": pk.launches, "wkv6": wk.launches,
                "mamba_scan": sk.launches, "flash_attention": fk.launches}
    want = {"paged_attention": kinds.count("attn") * (n + steps),
            "wkv6": kinds.count("rwkv") * (n + steps),
            "mamba_scan": kinds.count("mamba") * (n + steps),
            "flash_attention": 0}
    check(launches == want, f"{name}: dense decode launches {launches}, "
          f"want {want}")
    DENSE_LAUNCHES[name] = {k: v for k, v in launches.items() if v}
    full = full_width_checks(torch, {"paged_attention": cap}, tuple(at)
                             )["paged_attention"] if at else None
    rel = [float((d - p).abs().max() / p.abs().max())
           for d, p in zip(dense, paged)]
    check(all(np.isfinite(rel)) and max(rel) <= rtol,
          f"{name}: dense vs paged logits {max(rel)} of max |paged|, above "
          f"{rtol}")
    shifted = max(float((d - p).abs().max() / p.abs().max())
                  for d, p in zip(dense[:-1], paged[1:]))
    check(shifted > rtol, f"{name}: the check passed each dense step "
          f"against the engine's next ({shifted} <= {rtol})")
    top1 = sum(int(d.argmax() == p.argmax()) for d, p in zip(dense, paged))
    del caches, paged, dense, cap
    return {"phase": f"{name}.dense_decode", "arch": cfg.name,
            "dtype": cfg.dtype, "traffic": DENSE_TRAFFIC,
            "cache_bytes_per_token": int(sum(
                t[0, 0, 0].numel() * t.element_size() * t.shape[0]
                for t in M.init_decode_cache(cfg, plan, 1, 1, device=dev).get(
                    "attn", ()))),
            "launches": DENSE_LAUNCHES[name],
            "paged_attention_full_width": full, "paged_calls_checked": at,
            "dense_step_ms": dense_ms,
            "dense_step_ms_median": float(np.median(dense_ms)),
            "paged_step_ms_median": float(np.median(paged_ms)),
            "max_rel_logit_err_vs_paged": max(rel), "rtol": rtol,
            "top1_agreement": top1 / steps,
            "control_next_step_rel_err": shifted, "control_refused": True,
            **({"moe_decisions": pins.decisions,
                "moe_decisions_dense_would_change": pins.flipped,
                "moe_pairs_the_prefill_capacity_dropped": pins.dropped}
               if cfg.moe else {})}


WHISPER_ARCH = "whisper-base"
WHISPER_TRAFFIC = dict(batch=4, dec_tokens=448, decode=64)
WHISPER_LAUNCHES: dict = {}    # kernels 5 and 6 on the Whisper path


def whisper_calls(cfg, n_dec: int) -> tuple[dict, dict]:
    """The calls the Whisper phase holds to the plain versions, by call
    index in a run: flash in the forward over the frames (its encoder's
    layers first and last, then each decoder layer's self- and
    cross-attention; first and last layer), paged in the last of
    ``n_dec`` decode steps (each layer's self, then cross; first and last
    layer)."""
    e, last = cfg.n_enc_layers, cfg.n_layers - 1
    step = 2 * cfg.n_layers * (n_dec - 1)
    return ({0: "encoder L0", e - 1: f"encoder L{e - 1}", e: "self L0",
             e + 1: "cross L0", e + 2 * last: f"self L{last}",
             e + 2 * last + 1: f"cross L{last}"},
            {step: "self L0", step + 1: "cross L0",
             step + 2 * last: f"self L{last}",
             step + 2 * last + 1: f"cross L{last}"})


def rel_logits(a, b) -> float:
    """max |a - b| / max |b| in float32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def phase_whisper(torch, seed: int, dev="cuda") -> list:
    """Whisper-base uncut in bf16 (random weights and ``N(0, 1)`` frames
    from ``seed``), through both entry points: ``forward`` over
    ``WHISPER_TRAFFIC["batch"]`` sequences of ``enc_seq`` frames and
    ``dec_tokens`` tokens (its own encode, then the decoder), and serving:
    ``encode``, the cross caches filled by ``fill_cross_cache``, then
    ``decode`` positions token by token from 0 through
    ``init_decode_cache`` + ``decode_step``. A counted kernel run (flash:
    the forward's 6 encoder calls at 1,500 x 1,500 and 12 decoder calls, 6
    causal self and 6 cross at 448 x 1,500, then the serving encode's 6,
    all ``tensor_core``; paged: 2 x 6 a position, self over 448 slots and
    cross over 1,500), an ``impl="ref"`` run held to it, the
    decoded logits held to the forward's at the same positions, and a
    second kernel run ``==`` the first, each check with a planted
    control it must refuse; kernels 5 and 6 held to their plain versions
    on the path's own inputs and timed at Whisper's shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import unpadded_plan
    cfg = get_arch(WHISPER_ARCH)
    plan = unpadded_plan(cfg)
    b, s_dec, n_dec = (WHISPER_TRAFFIC[k] for k in
                       ("batch", "dec_tokens", "decode"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, init_ms = timed(lambda: M.init_params(cfg, plan, seed=seed,
                                                  device=dev, max_seq=s_dec))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    frames = torch.randn((b, cfg.enc_seq, cfg.d_model), generator=gen,
                         device=dev)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s_dec)).astype(np.int32)).to(dev)

    def run(impl):
        def ms_of(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, (time.perf_counter() - t0) * 1e3
        out = {}
        (logits, _, _), out["forward_ms"] = ms_of(lambda: M.forward(
            params, cfg, plan, {"tokens": tokens, "enc_frames": frames},
            impl=impl))
        out["forward_launches"] = launch_snapshot()
        enc, out["encode_ms"] = ms_of(
            lambda: M.encode(params, cfg, plan, frames, impl))
        caches = M.init_decode_cache(cfg, plan, b, s_dec, device=dev)
        M.fill_cross_cache(params, cfg, plan, caches, enc)
        dec, out["step_ms"] = [], []
        for pos in range(n_dec):
            (lg, caches), ms = ms_of(lambda: M.decode_step(
                params, cfg, plan, tokens[:, pos:pos + 1], caches, pos,
                impl=impl))
            dec.append(lg[:, 0])
            out["step_ms"].append(ms)
        out.update(logits=logits, decoded=torch.stack(dec, 1),
                   caches=caches, enc=enc)
        return out

    def launch_snapshot():
        return {"flash_attention": fk.launches,
                "flash_attention[tensor_core]": fk.launches_tensor_core,
                "flash_attention[simt]": fk.launches_simt,
                "paged_attention": pk.launches}

    flash_at, paged_at = whisper_calls(cfg, n_dec)
    caps = {"flash_attention": Capture(
                fops, "flash_attention", flash_at,
                key=lambda q, k, v, causal=True, scale=None:
                (bool(causal), q.shape[2], k.shape[2])),
            "paged_attention": Capture(
                pops, "paged_attention", paged_at,
                key=lambda q, kp, *a, **kw: kp.shape[1])}
    t_path = time.perf_counter()
    zero_counts()                                # counts of this path
    with caps["flash_attention"], caps["paged_attention"]:
        got = run("kernel")
    path_s = time.perf_counter() - t_path
    launches = launch_snapshot()
    peak = torch.cuda.max_memory_allocated() - base
    n_l, n_e = cfg.n_layers, cfg.n_enc_layers
    flog, plog = caps["flash_attention"].log, caps["paged_attention"].log
    flash_calls = {str(k): flog.count(k) for k in sorted(set(flog))}
    want_flash = {}
    for key, n in (((False, cfg.enc_seq, cfg.enc_seq), 2 * n_e),
                   ((True, s_dec, s_dec), n_l),
                   ((False, s_dec, cfg.enc_seq), n_l)):
        want_flash[str(key)] = want_flash.get(str(key), 0) + n
    check(flash_calls == want_flash, f"whisper: flash calls (causal, Sq, "
          f"Sk) {flash_calls}, want {want_flash}")
    fwd = got["forward_launches"]
    check(fwd["flash_attention"] == n_e + 2 * n_l
          == fwd["flash_attention[tensor_core]"]
          and fwd["paged_attention"] == 0,
          f"whisper: the forward's launches {fwd}, want {n_e} encoder + "
          f"{2 * n_l} decoder flash, all tensor_core, and no paged")
    check(launches["flash_attention"] == 2 * n_e + 2 * n_l
          == launches["flash_attention[tensor_core]"],
          f"whisper: flash launches {launches}, want the forward's "
          f"{n_e + 2 * n_l} and the serving encode's {n_e}, all "
          "tensor_core")
    paged_calls = {str(k): plog.count(k) for k in sorted(set(plog))}
    want_paged = {str(s_dec): n_l * n_dec}
    want_paged[str(cfg.enc_seq)] = want_paged.get(str(cfg.enc_seq), 0) + \
        n_l * n_dec
    check(paged_calls == want_paged and launches["paged_attention"]
          == 2 * n_l * n_dec, f"whisper: paged calls by slots "
          f"{paged_calls} ({launches['paged_attention']} launches), want "
          f"{want_paged}")
    WHISPER_LAUNCHES.update(launches)
    # the controls over 1,500-frame windows cut a 64-key tile (flash) or a
    # 32-slot chunk (paged): see control_pair
    flash_full = full_width_checks(
        torch, {"flash_attention": caps["flash_attention"]},
        tuple(flash_at), {i: 64 for i, what in flash_at.items()
                          if not what.startswith("self")}
    )["flash_attention"]
    paged_full = full_width_checks(
        torch, {"paged_attention": caps["paged_attention"]},
        tuple(paged_at), {i: 32 for i, what in paged_at.items()
                          if what.startswith("cross")})["paged_attention"]
    hbm = hbm_bytes_per_s(torch.cuda.get_device_name(0))
    scratch = torch.empty(1 << 26, dtype=torch.float32, device=dev)
    times = {f"flash_attention {flash_at[i]}": kernel_time(
        torch, "flash_attention", *caps["flash_attention"].args[i],
        scratch.zero_, hbm) for i in (0, n_e, n_e + 1)}
    first = min(paged_at)                        # the last step's layer 0
    times.update({f"paged_attention {paged_at[i]}": kernel_time(
        torch, "paged_attention", *caps["paged_attention"].args[i],
        scratch.zero_, hbm) for i in (first, first + 1)})
    del scratch, caps
    # the device's share of one decode step (positions past the checked)
    idle = device_profile(torch, lambda: M.decode_step(
        params, cfg, plan, tokens[:, n_dec:n_dec + 1], got["caches"],
        n_dec), reps=1)
    step_med = float(np.median(got["step_ms"]))
    if idle["device_ms_per_call"] is not None:
        idle["idle_share"] = 1 - idle["device_ms_per_call"] / step_med

    # the plain versions named explicitly; they launch no kernel
    zero_counts()
    ref = run("ref")
    check(fk.launches == 0 and pk.launches == 0,
          f"whisper: impl='ref' launched {fk.launches} flash and "
          f"{pk.launches} paged kernels")
    vs_ref = {}
    for what in ("logits", "decoded"):
        k_, r_ = got[what], ref[what]
        check(bool(torch.isfinite(k_).all() and torch.isfinite(r_).all()),
              f"whisper: non-finite {what}")
        err = rel_logits(k_, r_)
        control = rel_logits(k_[:, :-1], r_[:, 1:])    # the next position's
        check(err <= LM_LOGIT_RTOL < control,
              f"whisper {what}: kernel vs ref {err} of max |ref| (control "
              f"{control}), bound {LM_LOGIT_RTOL}")
        vs_ref[what] = {
            "max_rel_logit_err": err, "control_next_position": control,
            "top1_agreement": float((k_.argmax(-1) == r_.argmax(-1)
                                     ).float().mean())}
    dec_vs_fwd = {}
    for impl, out in (("kernel", got), ("ref", ref)):
        err = rel_logits(out["decoded"], out["logits"][:, :n_dec])
        control = rel_logits(out["decoded"][:, :-1],
                             out["logits"][:, 1:n_dec])
        check(err <= LM_LOGIT_RTOL < control,
              f"whisper {impl}: decoded vs forward logits {err} of max "
              f"|forward| (control {control}), bound {LM_LOGIT_RTOL}")
        dec_vs_fwd[impl] = {
            "max_rel_logit_err": err, "control_next_position": control,
            "top1_agreement": float((out["decoded"].argmax(-1) == out[
                "logits"][:, :n_dec].argmax(-1)).float().mean())}
    ref_ms = {k: ref[k] for k in ("forward_ms", "encode_ms")}
    ref_ms["step_ms_median"] = float(np.median(ref["step_ms"]))
    del ref
    again = run("kernel")
    for what in ("logits", "decoded"):
        check(torch.equal(got[what], again[what]),
              f"whisper: a second run gave other {what}")
    moved = got["logits"].clone()
    first = moved.view(-1)[:1]                   # one step of its dtype
    first.copy_(torch.nextafter(first, torch.full_like(first, float("inf"))))
    check(not torch.equal(moved, again["logits"]),
          "whisper: the == check passed logits moved by one step")
    line = {
        "phase": "whisper", "arch": cfg.name, "reduced": None,
        "n_layers": [n_e, n_l], "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
        "enc_seq": cfg.enc_seq, "dtype": cfg.dtype,
        "params": cfg.param_count(),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in params.parameters()),
        "traffic": WHISPER_TRAFFIC, "init_params_ms": init_ms,
        "forward_ms": again["forward_ms"], "encode_ms": again["encode_ms"],
        "step_ms_median": float(np.median(again["step_ms"])),
        "first_run": {"forward_ms": got["forward_ms"],
                      "encode_ms": got["encode_ms"],
                      "step_ms_median": step_med},
        "ref_run": ref_ms,
        "cache_bytes": sum(t.numel() * t.element_size()
                           for t in got["caches"]["attn"]),
        "peak_device_bytes": peak, "profile_decode_step": idle,
        "launches": launches, "forward_launches": got["forward_launches"],
        "flash_calls": flash_calls,
        "paged_calls_by_slots": paged_calls,
        "kernels_full_width": {"flash_attention": flash_full,
                               "paged_attention": paged_full,
                               "flash_calls": flash_at,
                               "paged_calls": paged_at},
        "kernel_times": times,
        "vs_ref": {**vs_ref, "logit_rtol": LM_LOGIT_RTOL},
        "decoded_vs_forward": dec_vs_fwd,
        "repeat": {"logits_equal": True, "decoded_equal": True,
                   "control_one_step_refused": True},
        "path_seconds": path_s}
    del got, again, params, frames, tokens
    torch.cuda.empty_cache()
    return [line]


# the trainer's runs: the launcher's flags (float32 master weights, bf16
# activations; TokenStream batches from --seed). "falls": the loss must
# fall at every step (the repeated batch); "grads": the microbatch
# gradient check; "resume": the stop-and-resume check; "first_order": the
# first step's change of the loss held to its first-order prediction
LLAMA_TRAIN = ["--arch", "llama3-8b", "--batch", "2", "--seq", "1024",
               "--steps", "3", "--n-layers", "8"]
TRAIN_FIRST_ORDER = (0.5, 1.5)   # observed / predicted first-step change
TRAIN_RUNS = {
    "whisper-base": dict(flags=["--arch", "whisper-base", "--batch", "4",
                                "--seq", "448", "--steps", "4", "--lr",
                                "1e-3", "--repeat-batch"],
                         falls=True, grads=True, resume=True),
    # 8 of 32 layers: 2,795,573,248 parameters, 16 bytes each with the
    # gradient and the two moments (44.7 GB); the whole model's would not
    # fit in 80 GB. The stream at the launcher's lr, then one batch
    # repeated at that lr and below it: AdamW's first step moves every
    # weight by about lr in the sign of its gradient, so to first order it
    # changes the loss by -lr * sum |g| (microbatch_check's
    # adamw_first_step_slope), which 2.8 B parameters make large. At a
    # small enough lr the change must match it; at 3e-4 the loss rises
    "llama3-8b": dict(flags=LLAMA_TRAIN, falls=False, grads=True),
    **{f"llama3-8b.repeat-lr{lr}": dict(
        flags=LLAMA_TRAIN + ["--repeat-batch", "--lr", lr], falls=False,
        first_order=lr == "3e-7") for lr in ("3e-4", "3e-5", "3e-6", "3e-7")},
}
TRAIN_RESUME_TOL = 1e-4          # tests/test_system.py:101
TRAIN_MICROBATCH_RTOL = 2.0 ** -6   # |mb - full| / |full|, bf16 activations


def phase_train(torch, seed: int, dev="cuda") -> list:
    """The launcher's ``main`` on the card for each of ``TRAIN_RUNS`` (no
    kernel may launch: training runs the plain paths under autograd).
    Where a run says so: the loss falls at every step on its repeated
    batch; two microbatches' accumulated float32 gradient is held to the
    full batch's (norm-wise, within ``TRAIN_MICROBATCH_RTOL``; a control,
    the gradient of the batch with its labels rolled by one, must be
    refused); an interrupted run (``--stop-after 2``) resumed from its
    checkpoint reaches the uninterrupted run's last loss within
    ``TRAIN_RESUME_TOL``; the first step on a repeated batch at a small lr
    changes the loss by ``TRAIN_FIRST_ORDER`` times its first-order
    prediction (``-lr`` times the ``adamw_first_step_slope`` of the same
    model's microbatch check, which starts from the same weights and
    batch) and lowers it. The other losses are readings."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launcher
    lines, slopes = [], {}
    ckpt = ROOT / "build" / "train_ckpt"
    for name, spec in TRAIN_RUNS.items():
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        flags = launcher.parse(spec["flags"])
        cfg = get_arch(flags.arch)
        if flags.reduced:
            cfg = cfg.reduced()
        if flags.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=flags.n_layers)
        args = ["--seed", str(seed), "--log-every", "1", "--device",
                dev] + spec["flags"]
        resume = spec.get("resume", False)
        zero_counts()
        t0 = time.perf_counter()
        r = launcher.main(args + (["--ckpt-dir", str(ckpt / "a"),
                                   "--ckpt-every", "2"] if resume else []))
        run_s = time.perf_counter() - t0
        counts = every_launch_count()
        check(sum(counts.values()) == 0,
              f"train {name}: kernels launched {counts}")
        peak = torch.cuda.max_memory_allocated() - base
        losses = r["losses"]
        check(all(np.isfinite(losses)), f"train {name}: losses {losses}")
        if spec["falls"]:
            check(all(b < a for a, b in zip(losses, losses[1:])),
                  f"train {name}: the loss did not fall at every step on "
                  f"the repeated batch: {losses}")
        b, s = flags.batch, flags.seq
        steady = r["step_s"][1:] or r["step_s"]
        full_layers = get_arch(flags.arch).n_layers
        line = {"phase": f"train.{name}", "arch": flags.arch,
                "reduced": None if cfg.n_layers == full_layers else {
                    "n_layers": f"{cfg.n_layers} of {full_layers}: the "
                                "weights, gradients and two moments in "
                                "float32 of the whole model would not fit "
                                "one card"},
                "flags": spec["flags"], "lr": flags.lr,
                "repeat_batch": flags.repeat_batch, "params": r["params"],
                "master_dtype": "float32", "activation_dtype": cfg.dtype,
                "losses": losses, "loss_falls_checked": spec["falls"],
                "step_ms": [x * 1e3 for x in r["step_s"]],
                "step_ms_median_after_first": float(np.median(steady)) * 1e3,
                "tokens_per_s": b * s / float(np.median(steady)),
                "optimizer_ms": [x * 1e3 for x in r["opt_s"]],
                "optimizer_share_median": float(np.median(
                    np.array(r["opt_s"][1:] or r["opt_s"])
                    / np.array(steady))),
                "peak_device_bytes": peak, "run_seconds": run_s,
                "kernel_launches": 0}
        if flags.repeat_batch and flags.arch in slopes:
            obs = losses[1] - losses[0]
            pred = -flags.lr * slopes[flags.arch]    # warmup: step 0 at lr
            line["first_step"] = {"observed": obs, "first_order": pred,
                                  "ratio": obs / pred}
            if spec.get("first_order"):
                lo, hi = TRAIN_FIRST_ORDER
                check(obs < 0 and lo <= obs / pred <= hi,
                      f"train {name}: the first step changed the loss by "
                      f"{obs}, its first-order prediction {pred}")
                line["first_step"]["bounds"] = TRAIN_FIRST_ORDER
        if resume:
            stopped = launcher.main(args + ["--ckpt-dir", str(ckpt / "b"),
                                            "--ckpt-every", "2",
                                            "--stop-after", "2"])
            resumed = launcher.main(args + ["--ckpt-dir", str(ckpt / "b"),
                                            "--ckpt-every", "2"])
            gap = abs(resumed["last_loss"] - losses[-1])
            check(stopped["final_step"] == 2 and resumed["steps_run"] == 2
                  and resumed["final_step"] == r["final_step"]
                  and gap < TRAIN_RESUME_TOL,
                  f"train {name}: resume {resumed['losses']} after "
                  f"{stopped['losses']} vs {losses}: gap {gap}")
            line["stop_and_resume"] = {
                "stopped_losses": stopped["losses"],
                "resumed_losses": resumed["losses"], "last_loss_gap": gap,
                "tol": TRAIN_RESUME_TOL,
                "checkpoint_bytes": dir_bytes(ckpt / "b" / "latest")}
        if spec.get("grads"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            line["microbatches"] = microbatch_check(torch, cfg, b, s, seed,
                                                    dev)
            line["microbatches"]["peak_device_bytes"] = \
                torch.cuda.max_memory_allocated() - base
            slopes[flags.arch] = line["microbatches"]["adamw_first_step_slope"]
        shutil.rmtree(ckpt, ignore_errors=True)
        lines.append(line)
        torch.cuda.empty_cache()
    return lines


def microbatch_check(torch, cfg, b: int, s: int, seed: int,
                     dev="cuda") -> dict:
    """Two microbatches' accumulated float32 gradient against the full
    batch's on ``cfg``'s first batch of ``b`` x ``s`` tokens, norm-wise
    over every parameter, with a control (the full batch's labels rolled
    by one). Also the slope of AdamW's first step from these weights
    (``adamw_first_step_slope``): the update is ``lr * (s g / (|s g| +
    eps) + wd p)`` (``s`` the clipping scale, ``wd`` on leaves of
    ``ndim >= 2``), so the loss changes to first order by ``-lr`` times
    the sum over every weight of ``g`` times that bracket. At most three
    gradients are held at once (no optimizer state): Llama's 8 layers
    take 11.2 GB each."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import unpadded_plan
    from repro_torch.train import train_step as ts
    plan = unpadded_plan(cfg)
    params = M.init_params(cfg, plan, seed=seed, device=dev, max_seq=s,
                           dtype=torch.float32)
    for p in params.parameters():
        p.requires_grad_(True)
    host = TokenStream(DataConfig(seed=seed, vocab_size=cfg.vocab_size,
                                  seq_len=s, global_batch=b)).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    if cfg.enc_dec:
        batch["enc_frames"] = torch.zeros((b, cfg.enc_seq, cfg.d_model),
                                          dtype=getattr(torch, cfg.dtype),
                                          device=dev)

    def norm_of(g: dict) -> float:
        return float(sum(float(x.float().square().sum()) for x in g.values())
                     ) ** 0.5

    def rel_to_full(g: dict) -> float:
        return float(sum(float((g[n] - full[n]).square().sum())
                         for n in full)) ** 0.5 / ref

    full, _ = ts.make_grad_fn(cfg, plan, ts.TrainConfig())(params, batch)
    ref = norm_of(full)
    opt = ts.TrainConfig().opt
    clip = min(1.0, opt.clip_norm / max(ref, 1e-9))
    slope = 0.0
    with torch.no_grad():
        for n, p in params.named_parameters():
            g = full[n].float()
            sg = g * clip
            term = g * sg / (sg.abs() + opt.eps)
            if p.dim() >= 2:
                term += opt.weight_decay * p.float() * g
            slope += float(term.sum(dtype=torch.float64))
            del g, sg, term
    mb, _ = ts.make_grad_fn(cfg, plan, ts.TrainConfig(microbatches=2))(
        params, {k: v.reshape(2, b // 2, *v.shape[1:])
                 for k, v in batch.items()})
    check(all(g.dtype == torch.float32 for g in mb.values()),
          "the accumulated gradient is not float32")
    err = rel_to_full(mb)
    worst = max(float((mb[n] - full[n]).abs().max()
                      / full[n].abs().max().clamp(min=1e-30)) for n in full)
    del mb
    rolled, _ = ts.make_grad_fn(cfg, plan, ts.TrainConfig())(
        params, {**batch, "labels": batch["labels"].roll(1, dims=1)})
    control = rel_to_full(rolled)
    del params, full, rolled
    check(err <= TRAIN_MICROBATCH_RTOL < control,
          f"train {cfg.name}: microbatch gradient |mb - full| / |full| = "
          f"{err} (control {control}), bound {TRAIN_MICROBATCH_RTOL}")
    return {"norm_rel_err": err, "rtol": TRAIN_MICROBATCH_RTOL,
            "grad_norm": ref, "adamw_first_step_slope": slope,
            "worst_leaf_max_rel_err": worst,
            "control_rolled_labels": control, "control_refused": True}


# ---------------------------------------------------------------------------
# The paper's comparison baselines beside SIVF (kernel 4 in every Flat,
# ContiguousIVF and LSH search; kernel 1 in SIVF's)
# ---------------------------------------------------------------------------

BASE_FLAT_CAP = 1 << 21                  # FlatIndex(128, 2,097,152)
BASE_LIST_CAP = 2 * N_BASE // N_LISTS    # 488, as benchmarks/paper.py sizes
BASE_LSH = dict(n_tables=4, bits=8, bucket_cap=8192)
BASE_HNSW = dict(m=8, ef=24)             # benchmarks/paper.py tab4
BASE_HNSW_ROWS, BASE_HNSW_REMOVE = 800, 100
FIG1A_REMOVE = 1024                      # the paper's Fig. 1a delete unit
BASE_LAUNCHES: dict = {}                 # kernels 1 / 4 on this path


def engine_bytes(torch, eng) -> int:
    """Device bytes of a baseline engine's tensors."""
    return sum(v.numel() * v.element_size() for v in vars(eng).values()
               if isinstance(v, torch.Tensor) and v.device.type != "cpu")


def over_limit(torch, got, want) -> float:
    """max |got - want| / (RTOL + RTOL |want|) over finite ``want``: the
    share of compare_topk's distance limit used (1.0 is the limit)."""
    g, w = got.double(), want.double()
    fin = torch.isfinite(w)
    return float(((g - w).abs() / (RTOL + RTOL * w.abs()))[fin].max())


def probed_exact(torch, wl: dict, live, queries, chunk: int = 32):
    """The exact top-K (float64 distances, rounded to float32 at the end)
    over the ``live`` rows of the workload's base that
    ``quantizer.assign`` routes, in the ingest's batches, into each
    query's ``NPROBE`` probed lists: the answer a ContiguousIVF and a
    SIVF index over the same adds, removes and centroids must give, built
    from the workload alone and from none of the engines' state (row i
    has id i)."""
    from repro_torch.core import quantizer
    base, cents = wl["base"], wl["cents"]
    lists = torch.cat([quantizer.assign(cents, base[lo:lo + INGEST_BATCH])
                       for lo in range(0, base.shape[0], INGEST_BATCH)])
    probes = quantizer.probe(cents, queries, NPROBE).long()
    xs = base.double()
    xx = xs.square().sum(-1)
    out_d, out_l = [], []
    for lo in range(0, queries.shape[0], chunk):
        q = queries[lo:lo + chunk].double()
        probed = torch.zeros((q.shape[0], cents.shape[0]), dtype=torch.bool,
                             device=q.device)
        probed.scatter_(1, probes[lo:lo + chunk], True)
        d = q.square().sum(-1, keepdim=True) - 2.0 * q @ xs.T + xx
        d.masked_fill_(~(probed[:, lists.long()] & live), float("inf"))
        v, i = d.topk(K, largest=False)
        out_d.append(v.float())
        out_l.append(i.to(torch.int32))
    return torch.cat(out_d), torch.cat(out_l)


def drive_engine(torch, eng, wl, fig1a, rm, expect, dev) -> dict:
    """Ingest, the 1,024-id remove, the bucketed removes and N_SEARCH
    searches through one engine's IndexProtocol; ``expect`` gathers the
    top-k launches its searches make (a chunk each, for an engine with
    ``query_bytes``). The first search also records the operands of its
    first and last top-k calls (``topk_operands``, cloned)."""
    from repro_torch.baselines import query_chunks
    from repro_torch.kernels.topk import ops as topk_ops
    base, queries = wl["base"], wl["queries"]
    ids = torch.arange(base.shape[0], dtype=torch.int32, device=dev)
    reps, ingest_ms = [], 0.0
    for lo in range(0, base.shape[0], INGEST_BATCH):
        r, dt = timed(lambda: eng.add(base[lo:lo + INGEST_BATCH],
                                      ids[lo:lo + INGEST_BATCH]))
        reps.append(r)
        ingest_ms += dt
    r1k, ms_1k = timed(lambda: eng.remove(fig1a))
    buckets = [timed(lambda: eng.remove(rm[lo:lo + REMOVE_BATCH]))
               for lo in range(0, REMOVE_ROWS, REMOVE_BATCH)]
    chunks = (len(query_chunks(N_QUERIES, eng.query_bytes(NPROBE)))
              if hasattr(eng, "query_bytes") else 0)
    cap = Capture(topk_ops, "topk", (0, chunks - 1))
    lat = []
    for i in range(N_SEARCH):
        with cap if i == 0 else contextlib.nullcontext():
            res, dt = timed(lambda: eng.search(queries, K, NPROBE))
        lat.append(dt)
        expect.append(chunks)
    return {"ingest_ms": ingest_ms,
            "ingest_rows_per_s": base.shape[0] / ingest_ms * 1e3,
            "accepted": sum(r.accepted for r in reps),
            "rejected": sum(r.rejected for r in reps),
            "remove_1024_ms": ms_1k, "remove_1024_accepted": r1k.accepted,
            "remove_bucket_ms": [dt for _, dt in buckets],
            "remove_buckets_accepted": sum(r.accepted for r, _ in buckets),
            "search_ms": lat, "search_ms_median": float(np.median(lat)),
            "search_chunks": chunks, "n_live": eng.n_live, "result": res,
            "topk_operands": cap.args}


def phase_baselines(torch, wl: dict, dev="cuda") -> list:
    """The workload's 1M rows through a SIVF index of the raw
    configuration (no attributes, no overwrite: the baselines track
    none), Flat, ContiguousIVF and LSH, then HNSW-lite at 800 rows; reads
    each engine's ingest rate, remove and search times, recall@10 against
    the exact top-10 over the live set, device bytes. Holds Flat to that
    exact top-10, and ContiguousIVF to the exact top-10 within the lists
    it and SIVF probe at nprobe 32 (:func:`probed_exact`, from the
    workload alone; labels ``==`` outside ties, distances allclose 1e-5),
    to SIVF's labels outside ties and to SIVF's recall@10. Two float32
    evaluations of ``|q|^2 - 2 q.x + |x|^2`` at this data's magnitudes
    (terms near 1,300, distances near 200) each use up to about the 1e-5
    limit against the exact value, so ContiguousIVF's distances are held
    to the exact ones, not to SIVF's (the share of the limit each uses is
    reported, ``dist_err_over_limit``), and two labels may trade places
    between the engines only where their exact distances lie within
    twice the larger engine's distance error. Holds the top-k launches
    to the searches' chunks, and kernel 4 on the first and last chunk of
    each engine's first search to its plain version (``==`` bits and
    labels) on the operands the search gave it."""
    import sivf_torch
    from repro_torch.baselines import (
        ContiguousIVF,
        FlatIndex,
        HNSWLite,
        LSHIndex,
    )
    from repro_torch.kernels.sivf_scan import fused
    from repro_torch.kernels.topk import topk as tk
    from repro_torch.kernels.topk.ref import topk_ref
    n, queries = wl["base"].shape[0], wl["queries"]
    rm = wl["rm_ids"].to(dev)
    rng = np.random.default_rng(wl["seed"] + 2)
    outside = np.ones(n, bool)
    outside[wl["rm_ids"].numpy()] = False
    fig1a = torch.from_numpy(rng.choice(np.flatnonzero(outside),
                                        FIG1A_REMOVE, replace=False)
                             .astype(np.int32)).to(dev)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    live[rm.long()] = False
    live[fig1a.long()] = False
    gen = torch.Generator(device=dev).manual_seed(wl["seed"])
    sivf_cfg = sivf_torch.SIVFConfig(**{**CFG, "attributes": ()})
    engines = {
        "sivf": lambda: sivf_torch.Index(sivf_cfg, wl["cents"], device=dev),
        "flat": lambda: FlatIndex(DIM, BASE_FLAT_CAP, device=dev),
        "contiguous_ivf": lambda: ContiguousIVF(
            wl["cents"], list_cap=BASE_LIST_CAP, device=dev),
        "lsh": lambda: LSHIndex(gen, DIM, **BASE_LSH, device=dev)}
    zero_counts()                                # counts of this path
    expect, lines, operands = [], [], {}
    sivf_res = best = sivf_recall = None
    for name, make in engines.items():
        eng = make()
        got = {"engine": name,
               **drive_engine(torch, eng, wl, fig1a, rm, expect, dev)}
        res = got.pop("result")
        operands[name] = (got["search_chunks"], got.pop("topk_operands"))
        got["device_bytes"] = (sivf_torch.memory_report(sivf_cfg)
                               ["device_bytes"] if name == "sivf"
                               else engine_bytes(torch, eng))
        if name == "contiguous_ivf":
            got.update(list_cap=int(eng.buf.shape[1]),
                       n_relayouts=eng.n_relayouts)
        check(got["accepted"] + got["rejected"] == n,
              f"{name}: ingest reports {got['accepted']} + "
              f"{got['rejected']} != {n}")
        if name != "lsh":                  # LSH drops rows of full buckets
            check(got["accepted"] == n and got["remove_1024_accepted"]
                  == FIG1A_REMOVE and got["remove_buckets_accepted"]
                  == REMOVE_ROWS and got["n_live"]
                  == n - FIG1A_REMOVE - REMOVE_ROWS, f"{name}: {got}")
        if name == "sivf":          # the exact top-10 over the live set
            best = exact_top(torch, eng, queries)
            sivf_res = res
        elif name == "flat":
            rows = wl["base"][best.long()].double()
            best_d = (rows - queries[:, None].double()).square().sum(-1)
            err, ties = compare_topk(res.distances, res.labels,
                                     best_d.float(), best)
            got.update(max_abs_dist_err_vs_exact=err,
                       tie_groups_vs_exact=ties)
            got.update(dist_err_over_limit_vs_exact=over_limit(
                torch, res.distances, best_d))
        elif name == "contiguous_ivf":   # SIVF's probed lists, exactly
            od, ol = probed_exact(torch, wl, live, queries)
            err, ties = compare_topk(res.distances, res.labels, od, ol)
            fin = torch.isfinite(od)
            errs = [float((r.distances.to(dev) - od)[fin].abs().max())
                    for r in (res, sivf_res)]
            gap = 2.0 * max(errs)
            check(np.isfinite(gap), f"distance errors {errs} vs exact: an "
                  "engine returned +inf where a live row was probed")
            odh = od.cpu().numpy()
            swaps = labels_outside_ties(
                res.labels.cpu().numpy(), sivf_res.labels.cpu().numpy(),
                np.abs(np.diff(odh, axis=1)) <= gap)
            got["vs_probed_exact"] = {
                "max_abs_dist_err": err, "tie_groups": ties,
                "dist_err_over_limit": over_limit(torch, res.distances, od)}
            got["sivf_vs_probed_exact"] = {   # kernel 1's rounding
                "max_abs_dist_err": errs[1],
                "rows_with_other_labels": int((sivf_res.labels.to(dev) != ol
                                               ).any(1).sum()),
                "dist_err_over_limit": over_limit(torch, sivf_res.distances,
                                                  od)}
            share = got["sivf_vs_probed_exact"]["dist_err_over_limit"]
            check(share <= FP32_LIMIT_SHARE,
                  f"SIVF's distances use {share} of the 1e-5 limit against "
                  f"probed_exact (> {FP32_LIMIT_SHARE})")
            got["vs_sivf"] = {
                "tie_gap": gap, "tie_groups": swaps,
                "rows_with_other_labels": int((res.labels != sivf_res.labels
                                               ).any(1).sum()),
                "dist_err_over_limit": over_limit(torch, res.distances,
                                                  sivf_res.distances)}
        got["recall_at_10"] = recall(torch, res.labels.to(dev), best)
        if name == "sivf":
            sivf_recall = got["recall_at_10"]
        elif name == "contiguous_ivf":
            check(got["recall_at_10"] == sivf_recall,
                  f"contiguous_ivf recall@10 {got['recall_at_10']} != "
                  f"SIVF's {sivf_recall} over the same probed lists")
        lines.append({"phase": f"baselines.{name}", **got})
        del eng, res
        torch.cuda.empty_cache()
    launches = {"topk": tk.launches, "topk[warp]": tk.launches_warp,
                "topk[block]": tk.launches_block,
                "sivf_fused_search": fused.launches,
                "sivf_fused_search[grouped]": fused.launches_grouped}
    check(launches["topk"] == sum(expect) == launches["topk[warp]"],
          f"top-k launches {launches} != {sum(expect)}, the searches' "
          "chunks, all on warp")
    check(launches["sivf_fused_search"] == N_SEARCH
          == launches["sivf_fused_search[grouped]"],
          f"fused launches {launches}: SIVF's searches on grouped")
    BASE_LAUNCHES.update(launches)
    topk_vs_plain = {}                  # kernel 4 at the engines' shapes
    for name, (chunks, calls) in operands.items():
        check(len(calls) == min(2, chunks),
              f"{name}: captured top-k calls {sorted(calls)} of {chunks}")
        for i, ((d, lab, k), _) in sorted(calls.items()):
            dk, lk = tk.topk_route("warp", d, lab, k)
            torch.cuda.synchronize()
            dp, lp = topk_ref(d, lab, k)
            what = f"{name}/chunk {i}/{list(d.shape)}/k={k}"
            topk_vs_plain[what] = {
                "max_abs_err": check_equal(f"topk {what}", dk, lk, dp, lp),
                "inf_entries": int(torch.isinf(d).sum())}
    del operands

    # the graph on the host: 800 rows, then a delete that rebuilds it
    hnsw = HNSWLite(DIM, **BASE_HNSW)
    xs = wl["base"][:BASE_HNSW_ROWS].cpu().numpy()
    hid = np.arange(BASE_HNSW_ROWS, dtype=np.int32)
    add, add_ms = timed(lambda: hnsw.add(xs, hid))
    rem, rem_ms = timed(lambda: hnsw.remove(hid[:BASE_HNSW_REMOVE]))
    check(add.accepted == BASE_HNSW_ROWS and rem.accepted == BASE_HNSW_REMOVE
          and hnsw.n_live == BASE_HNSW_ROWS - BASE_HNSW_REMOVE,
          f"hnsw: n_live {hnsw.n_live}, reports {add} {rem}")
    hres, h_ms = timed(lambda: hnsw.search(queries, K))
    live = torch.from_numpy(xs[BASE_HNSW_REMOVE:]).to(dev).double()
    hbest = torch.cdist(queries.double(), live).topk(
        K, largest=False).indices + BASE_HNSW_REMOVE
    lines.append({"phase": "baselines.hnsw", "engine": "hnsw",
                  "rows": BASE_HNSW_ROWS, "reduced": f"{BASE_HNSW_ROWS} "
                  "rows: the graph is Python on the host, as at "
                  "benchmarks/paper.py:698",
                  "ingest_ms": add_ms,
                  "ingest_rows_per_s": BASE_HNSW_ROWS / add_ms * 1e3,
                  "remove_ms_full_rebuild": rem_ms,
                  "search_ms": h_ms, "n_live": hnsw.n_live,
                  "recall_at_10": recall(torch, hres.labels.to(dev),
                                         hbest.to(torch.int32))})
    lines.append({"phase": "baselines", "n_base": n, "queries": N_QUERIES,
                  "k": K, "nprobe": NPROBE, "launches": launches,
                  "topk_launches_expected": sum(expect),
                  "flat_vs_exact": "labels == outside ties, "
                                   "distances allclose(1e-5)",
                  "contiguous_ivf_vs_probed_exact": "labels == outside "
                  "ties, distances allclose(1e-5)",
                  "contiguous_ivf_vs_sivf": "labels == outside ties of "
                  "the exact distances within tie_gap, recall@10 ==",
                  "topk_vs_plain": topk_vs_plain})
    return lines


# the model-axis plan: (arch, mesh, decode steps of each sequence) cells
# served at full width in bf16 on virtual meshes of one card, then one
# ZeRO-1 train step. PR 28's attention LMs decode ARCH_TRAFFIC's prompts,
# cut from 16 steps each (the 16 shards of a layer run in turn, so a
# sharded step takes about a second): Granite (2, 8), whose decode runs
# kernel 5 a shard, 16 and 2, its kernel held on the first sequence's
# 16th step (at 4 or 8 its 32-slot paged control at the last layer came
# near its limit); the (1, 16) cells, whose decode shards head_dim and
# runs no kernel, 4 and 2. The three families decode 2 steps a sequence;
# Jamba is cut to one 8-layer period as in the hybrid phase (the whole
# model is 103.1 GB in bf16); Whisper takes WHISPER_AXIS_PROMPTS.
MODEL_AXIS_CELLS = (
    ("granite-moe-3b-a800m", {"data": 1, "model": 16}, (4, 2)),
    ("granite-moe-3b-a800m", {"data": 2, "model": 8}, (16, 2)),
    ("phi3-medium-14b", {"data": 1, "model": 16}, (4, 2)),
    ("rwkv6-3b", {"data": 1, "model": 16}, (2, 2)),
    ("jamba-v0.1-52b", {"data": 2, "model": 8}, (2, 2)),
    ("whisper-base", {"data": 1, "model": 16}, (2, 2, 2, 2)))
MODEL_AXIS_CUT = {"jamba-v0.1-52b": 8}
MODEL_AXIS_TRAFFIC = ARCH_TRAFFIC
# Whisper: one sequence at a time over WHISPER_TRAFFIC's 4 x 1,500 frames,
# decoder prompts within its 448 learned positions
WHISPER_AXIS_PROMPTS = (432, 200, 64, 17)
# a recurrent model's bf16 sharded logits against the unsharded padded
# model's: within this factor of the unsharded model's own gap between
# its kernels and their plain versions (impl="ref"), both one bf16
# rounding amplified over random full-width layers
AXIS_WITNESS_FACTOR = 2.0
# cut to 16 of 32 layers: at 32 the float32 weights, their gradients, the
# moments and the steps' bf16 copies of the weights did not fit 80 GB
MODEL_AXIS_TRAIN = dict(arch="granite-moe-3b-a800m", n_layers=16,
                        mesh={"data": 2, "model": 8}, batch=2, seq=512,
                        lr=3e-4, steps=2)
MODEL_AXIS_LAUNCHES: dict = {}  # kernels 5-8 per cell of the sharded run


def unpadded_view(torch, params, cfg, plan):
    """The unpadded model's parameters as views of the padded ones: each
    dim on ``heads``, ``kv_heads``, ``vocab`` or ``expert`` cut to the
    real count (nothing copied). Under candidate B of the head padding
    the real q heads regroup over the KV heads, so it is another function
    of the same weights: it is timed, not compared."""
    from repro_torch.models import model as M
    from repro_torch.sharding.axes import logical_axes
    real = {"heads": (cfg.n_heads, plan.n_heads_padded),
            "kv_heads": (cfg.n_kv_heads, plan.n_kv_heads_padded),
            "vocab": (cfg.vocab_size, plan.vocab_padded),
            "expert": (cfg.n_experts, plan.n_experts_padded)}
    tree: dict = {}
    for name, ax in logical_axes(params).items():
        t = params.get_parameter(name)
        for d, a in enumerate(ax):
            if a in real and real[a][1]:
                t = t.narrow(d, 0, t.shape[d] // real[a][1] * real[a][0])
        node, *path = tree, *name.split(".")[:-1]
        for key in path:
            node = node.setdefault(key, {})
        node[name.rsplit(".", 1)[1]] = t
    layers = [M.layer_module(**tree["layers"][str(i)])
              for i in range(cfg.n_layers)]
    encoder = None
    if cfg.enc_dec:
        enc = tree["encoder"]
        encoder = {"layers": [M.layer_module(**enc["layers"][str(i)])
                              for i in range(cfg.n_enc_layers)],
                   "ln_post": enc["ln_post"]}
    return M.DecoderLM(tree["embed"], tree["final_norm"], layers,
                       tree.get("head"), encoder, tree.get("dec_pos"))


def tensor_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def axis_traffic(torch, cfg, plans, params, prompts, forced, steps,
                 mesh=None, caps=None, dev="cuda", frames=None,
                 impl="kernel") -> dict:
    """The prompts through the dense entry points, one sequence at a time:
    each prompt prefilled (``forward(collect_cache=True)``), its caches
    (K, V, recurrent states) written into a dense decode cache (on
    ``mesh``: each shard's block, ``fill_decode_cache``), then
    ``steps[i]`` teacher-forced tokens decoded (``decode_step``). An encoder-decoder takes sequence ``i``'s
    ``frames[i]``: its forward encodes them, and before the steps
    ``encode`` and ``fill_cross_cache`` fill the cross caches. ``caps``
    maps ``("prefill", i)`` or ``("step", i, t)`` to a :class:`Capture`
    entered around that call. ``impl`` as ``forward``'s. Returns each
    call's ms and the logits of each prompt's last position and of each
    step."""
    from repro_torch.models import model as M
    from repro_torch.models import parallel
    pp, pd = plans
    caps = caps or {}
    out = {"prefill_ms": [], "step_ms": [], "logits": []}
    for i, prompt in enumerate(prompts):
        toks = torch.from_numpy(prompt)[None].to(dev)
        s = len(prompt)
        batch = {"tokens": toks}
        if cfg.enc_dec:
            batch["enc_frames"] = frames[i:i + 1]
        with caps.get(("prefill", i), contextlib.nullcontext()), \
                torch.no_grad():
            (lg, _, kvs), ms = timed(lambda: M.forward(
                params, cfg, pp, batch, impl, collect_cache=True,
                mesh=mesh))
        out["prefill_ms"].append(ms)
        out["logits"].append(lg[0, -1].float())
        del lg
        if mesh is None:
            caches = M.init_decode_cache(cfg, pd, 1, s + steps[i],
                                         device=dev)
            for kind, stacks in zip(M.kinds_present(cfg), kvs):
                for c, t in zip(caches[kind], stacks):
                    if kind == "attn":
                        c[:, :, :s] = t.to(c.dtype)
                    else:
                        c.copy_(t)
        else:
            caches = parallel.fill_decode_cache(M.init_decode_cache(
                cfg, pd, 1, s + steps[i], mesh=mesh), kvs, cfg, pd, mesh)
        del kvs
        if cfg.enc_dec:
            with torch.no_grad():
                enc = M.encode(params, cfg, pd, batch["enc_frames"],
                               impl, mesh=mesh)
            M.fill_cross_cache(params, cfg, pd, caches, enc, mesh=mesh)
            del enc
        for t in range(steps[i]):
            tok = torch.from_numpy(forced[t, i:i + 1, None]).to(dev)
            with caps.get(("step", i, t), contextlib.nullcontext()):
                (lg, caches), ms = timed(lambda: M.decode_step(
                    params, cfg, pd, tok, caches, s + t, impl, mesh=mesh))
            out["step_ms"].append(ms)
            out["logits"].append(lg[0, -1].float())
        del caches
        torch.cuda.empty_cache()
    return out


def axis_logits_vs(torch, got: dict, ref: dict) -> dict:
    """max and mean |d| / max |ref| over each compared row's finite
    logits (the padded vocab's ``-1e30`` excluded, and required in the
    same columns), and top-1 agreement."""
    worst, means, top1 = 0.0, [], 0
    for a, b in zip(got["logits"], ref["logits"]):
        fin = b > -1e29
        check(torch.equal(fin, a > -1e29), "padded vocab columns differ")
        a, b = a[fin], b[fin]
        check(bool(torch.isfinite(a).all()), "non-finite sharded logits")
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
        means.append(float((a - b).abs().mean() / b.abs().mean()))
        top1 += int(a.argmax() == b.argmax())
    return {"max_rel_logit_err": worst,
            "mean_rel_logit_err": float(np.mean(means)),
            "top1_agreement": top1 / len(ref["logits"]),
            "rows_compared": len(ref["logits"])}


class MoeTally:
    """While entered, wrap ``mlp.moe_route`` and ``mlp.moe_dispatch``:
    record each routing call's top-k experts and each dispatch's pairs
    and kept pairs, in call order."""

    def __init__(self, mlp):
        self.mlp, self.routes, self.dispatches = mlp, [], []

    def __enter__(self):
        route, dispatch = self.mlp.moe_route, self.mlp.moe_dispatch

        def moe_route(*a, **k):
            out = route(*a, **k)
            self.routes.append(out[2].clone())
            return out

        def moe_dispatch(xf, topw, tope, cap, e_pad):
            buf, r = dispatch(xf, topw, tope, cap, e_pad)
            self.dispatches.append((tope.numel(), r[0].numel()))
            return buf, r
        self.saved = (route, dispatch)
        self.mlp.moe_route, self.mlp.moe_dispatch = moe_route, moe_dispatch
        return self

    def __exit__(self, *exc):
        self.mlp.moe_route, self.mlp.moe_dispatch = self.saved


@contextlib.contextmanager
def both(*managers):
    """Enter ``managers`` together."""
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


@contextlib.contextmanager
def same_dispatch_moe(torch, mlp, plan, shape):
    """Off the mesh, the MoE of a prefill that the mesh dispatches by
    ``apply_moe_shardmap`` takes ``apply_moe`` over each (data, model)
    shard's tokens in turn (the local capacity, choices and drops), the
    aux averaged; every other call is ``moe``'s own."""
    orig = mlp.moe
    m, dp = shape["model"], shape["data"]

    def moe(p, cfg, pl, x):
        b, s, _ = x.shape
        if plan.rules_dict["seq_sp"] != "model" or s % m or b % dp:
            return orig(p, cfg, pl, x)
        outs = [[mlp.apply_moe(p, cfg, pl, c) for c in r.chunk(m, 1)]
                for r in x.chunk(dp, 0)]
        y = torch.cat([torch.cat([o for o, _ in r], 1) for r in outs], 0)
        return y, sum(a for r in outs for _, a in r) / (m * dp)
    mlp.moe = moe
    try:
        yield
    finally:
        mlp.moe = orig


def moe_summary(torch, tally, n_moe: int, mesh_size: int, shardmap: bool
                ) -> dict:
    """One prefill's MoE (``tally`` entered around it): pairs and kept
    pairs over its ``n_moe`` MoE layers (a dispatch of all tokens that
    several shards ran counted once) and its first MoE layer's top-k
    experts, concatenated over the shards of a shard map."""
    dup = 1 if shardmap else len(tally.dispatches) // n_moe
    pairs = sum(p for p, _ in tally.dispatches) // dup
    kept = sum(k for _, k in tally.dispatches) // dup
    first = tally.routes[:mesh_size if shardmap else 1]
    return {"pairs": pairs, "kept": kept,
            "layer0_topk": torch.cat(first, 0)}


def choices_differ(a, b) -> int:
    """(token, expert) pairs chosen in one ``[N, K]`` top-k and not the
    other."""
    sa, sb = a.sort(-1).values, b.sort(-1).values
    return int((sa != sb).sum())


def axis_calls(cfg, size: int, steps) -> tuple[dict, dict]:
    """Each kernel's launches on one cell's sharded run (sequence ``i``
    decoded ``steps[i]`` steps), and in one prefill's forward or one
    step, by the program's order (a layer's shards in turn): kernel 8 / 7
    on each recurrent layer in every prefill and step; kernel 6 on each
    attention layer in every prefill (Whisper: its encoder layers, then
    each decoder layer's self- and cross-attention, then the encoder
    layers again in the ``encode`` that fills the cross caches); kernel 5
    on each attention layer in every step (Whisper: self and cross)."""
    from repro_torch.models.model import layer_kinds
    kinds = layer_kinds(cfg)
    rec = kinds.count("rwkv") + kinds.count("mamba")
    attn = kinds.count("attn") * (2 if cfg.enc_dec else 1)
    one = {"flash_attention": (attn + cfg.n_enc_layers) * size,
           "paged_attention": attn * size}
    total = {"flash_attention": (attn + 2 * cfg.n_enc_layers) * size
             * len(steps),
             "paged_attention": attn * size * sum(steps)}
    if rec:
        op = "wkv6" if cfg.block == "rwkv" else "mamba_scan"
        one[op] = rec * size
        total[op] = rec * size * (len(steps) + sum(steps))
    return total, one


def axis_capture_indices(cfg, size: int) -> dict:
    """The call indices (within one prefill, or one step) of the first and
    last layer at the first and last shard, by kernel: a layer's calls
    are its shards' in order; Whisper's flash calls are its encoder
    layers' and then, per decoder layer, the self- and cross-attention's,
    its paged calls per decoder layer self then cross."""
    from repro_torch.models.model import layer_kinds
    kinds = layer_kinds(cfg)
    ends = (0, size - 1)

    def at(firsts):
        return sorted({f + s for f in firsts for s in ends})
    out = {}
    n_rec = kinds.count("rwkv") + kinds.count("mamba")
    if n_rec:
        out["wkv6" if cfg.block == "rwkv" else "mamba_scan"] = \
            at((0, (n_rec - 1) * size))
    n_attn = kinds.count("attn")
    if cfg.enc_dec:
        enc, per = cfg.n_enc_layers * size, 2 * size
        out["flash_attention"] = at((0, enc - size, enc, enc + size,
                                     enc + (n_attn - 1) * per,
                                     enc + (n_attn - 1) * per + size))
        out["paged_attention"] = at((0, size, (n_attn - 1) * per,
                                     (n_attn - 1) * per + size))
    elif n_attn:
        out["flash_attention"] = out["paged_attention"] = \
            at((0, (n_attn - 1) * size))
    return out


def rec_full_width(torch, cap, kern, plain, what: str) -> dict:
    """A recurrence kernel against its plain version on the captured calls
    (:func:`rec_err`); each call's control runs the plain version from a
    wrong state (the step's state zeroed; a prefill's zero state planted
    at 0.1) and must be refused (:func:`rec_control`)."""
    entry = {"limit": f"{REC_RTOL}*|plain| + {REC_ATOL}*RMS(plain) over "
                      "each sequence", "shapes": None,
             "max_abs_err_by_call": {}, "control_wrong_state_by_call": {}}
    for n, (args, _) in cap.args.items():
        entry["shapes"] = [list(a.shape) for a in args]
        k_out = kern(*args)
        torch.cuda.synchronize()
        entry["max_abs_err_by_call"][n] = rec_err(
            f"{what} call {n} at full width", k_out, plain(*args))
        s0 = args[-1]
        wrong = torch.zeros_like(s0) if bool(s0.abs().max() > 0) \
            else torch.full_like(s0, 0.1)
        entry["control_wrong_state_by_call"][n] = rec_control(
            f"{what} call {n} from a wrong state", k_out,
            plain(*args[:-1], wrong))
    return entry


def phase_model_axis(torch, name: str, shape: dict, steps: tuple, seed: int,
                     dev="cuda") -> list:
    """One of ``MODEL_AXIS_CELLS``: ``name`` at full width in bf16 (random
    weights from ``seed``, padded by ``make_plan(cfg, shape, ...)`` with a
    global batch of 1; Jamba cut to one period) on
    ``ModelMesh.virtual(shape)``, through ``MODEL_AXIS_TRAFFIC`` one
    sequence at a time, sequence ``i`` decoded ``steps[i]`` steps
    (:func:`axis_traffic`; Whisper: ``WHISPER_AXIS_PROMPTS``, each over
    its own 1,500 frames ``N(0, 1)``). Counted: every kernel's launches
    against :func:`axis_calls`. Held at the first and last layer and
    shard of the first prefill and the first sequence's last step:
    kernels 6 and 5 by :func:`full_width_checks` (a shard's call holds few
    heads, so its short-window control drops a 32-slot chunk, the
    kernel's unit of work, not one key of some 2,000), 8 and 7 by
    :func:`rec_full_width` (a wrong state refused). Then the same padded
    weights off the mesh, the logits within ``LM_LOGIT_RTOL`` (where the
    mesh's prefill dispatches the MoE by shard map, of a run whose MoE
    takes the same per-shard dispatch, :func:`same_dispatch_moe`, the
    plain ``apply_moe`` run's drops and choices reported beside it). A
    recurrent model's bf16 logits, where random weights at full width
    amplify one rounding over the layers, are held within
    ``AXIS_WITNESS_FACTOR`` of the unsharded model's own gap to its plain
    versions (``impl="ref"``), and in float32 within ``RNN_F32_RTOL`` over
    the whole traffic. The unpadded model (views of the padded weights)
    runs for time."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.mamba_scan import ops as mops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6 import wkv6 as wk
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.mesh import ModelMesh
    from repro_torch.models import mlp
    from repro_torch.models.model import init_params
    from repro_torch.sharding.rules import make_plan, unpadded_plan
    t_phase = time.perf_counter()
    full_cfg = get_arch(name)
    cfg = full_cfg if name not in MODEL_AXIS_CUT else dataclasses.replace(
        full_cfg, n_layers=MODEL_AXIS_CUT[name])
    mesh = ModelMesh.virtual(shape, dev)
    size = mesh.size
    plans = tuple(make_plan(cfg, shape, k, 1) for k in ("prefill", "decode"))
    traffic = MODEL_AXIS_TRAFFIC if not cfg.enc_dec else dict(
        MODEL_AXIS_TRAFFIC, prompts=WHISPER_AXIS_PROMPTS)
    prompts, forced = lm_traffic(seed, cfg.vocab_size, traffic)
    check(len(steps) == len(prompts),
          f"{name}: steps {steps} for {len(prompts)} sequences")
    frames = None
    if cfg.enc_dec:
        g = torch.Generator(device=dev).manual_seed(seed)
        frames = torch.randn((len(prompts), cfg.enc_seq, cfg.d_model),
                             generator=g, device=dev)
    max_seq = 448 if cfg.enc_dec else 4096
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, init_ms = timed(lambda: init_params(
        cfg, plans[0], seed=seed, device=dev, max_seq=max_seq))
    flat = unpadded_view(torch, params, cfg, plans[0])
    pbytes = {"param_bytes_padded": tensor_bytes(params),
              "param_bytes_unpadded": tensor_bytes(flat)}
    idx = axis_capture_indices(cfg, size)
    rec_op = {"rwkv": "wkv6", "hybrid": "mamba_scan"}.get(cfg.block)
    by_heads = plans[1].kv_sharded
    last = ("step", 0, steps[0] - 1)
    held = {}                       # kernel: its (prefill, step) captures
    if rec_op:
        mod = wops if rec_op == "wkv6" else mops
        held[rec_op] = (Capture(mod, rec_op, idx[rec_op]),
                        Capture(mod, rec_op, idx[rec_op]))
    if "flash_attention" in idx:
        held["flash_attention"] = (Capture(fops, "flash_attention",
                                           idx["flash_attention"]), None)
        if by_heads:
            held["paged_attention"] = (None, Capture(
                pops, "paged_attention", idx["paged_attention"]))
    tally, tally_off = MoeTally(mlp), MoeTally(mlp)
    caps = {("prefill", 0): [tally] if cfg.moe else [], last: []}
    for pre, step in held.values():
        caps[("prefill", 0)] += [] if pre is None else [pre]
        caps[last] += [] if step is None else [step]
    caps = {k: both(*v) for k, v in caps.items() if v}
    collectives: dict = {}
    orig = mesh_mod.collective

    def counted(op, *a, **k):
        collectives[op] = collectives.get(op, 0) + 1
        return orig(op, *a, **k)
    shardmap = cfg.moe and len(prompts[0]) % shape["model"] == 0 and \
        shape["data"] == 1
    zero_counts()                                 # counts of this path
    mesh_mod.collective = counted
    try:
        sharded = axis_traffic(torch, cfg, plans, params, prompts, forced,
                               steps, mesh, caps, dev, frames)
    finally:
        mesh_mod.collective = orig
    launches = {"flash_attention": fk.launches,
                "flash_attention[tensor_core]": fk.launches_tensor_core,
                "paged_attention": pk.launches, "wkv6": wk.launches,
                "mamba_scan": mk.launches}
    peak = torch.cuda.max_memory_allocated() - base
    want, per_call = axis_calls(cfg, size, steps)
    if not by_heads:
        want["paged_attention"] = 0
    for op in ("flash_attention", "paged_attention", "wkv6", "mamba_scan"):
        check(launches[op] == want.get(op, 0), f"{name} {shape}: {op} "
              f"launches {launches[op]} != {want.get(op, 0)} "
              f"({axis_calls.__doc__.split(':')[0]})")
    check(launches["flash_attention[tensor_core]"] ==
          launches["flash_attention"], f"{name}: flash off tensor_core")
    cell = f"{name} {shape['data']}x{shape['model']}"
    MODEL_AXIS_LAUNCHES[cell] = {
        **{op: launches[op] for op in want},
        "per_shard": {op: launches[op] // size for op in want}}
    full = {}
    for op, pair in held.items():
        for when, cap in zip(("prefill", "step"), pair):
            if cap is None:
                continue
            check(cap.n == per_call[op] and set(cap.args) == set(idx[op]),
                  f"{name} {op} {when}: {cap.n} calls (want "
                  f"{per_call[op]}), captured {sorted(cap.args)}")
            if op == rec_op:
                kern = wk.wkv6_cuda if op == "wkv6" else mk.mamba_scan_cuda
                plain = wkv6_ref if op == "wkv6" else mamba_scan_ref
                full[f"{op}.{when}"] = rec_full_width(
                    torch, cap, kern, plain, f"{name} {op} {when}")
            else:
                full.update(full_width_checks(
                    torch, {op: cap}, idx[op],
                    short=dict.fromkeys(idx[op], 32)))
    del caps, held
    unsharded = axis_traffic(torch, cfg, plans, params, prompts, forced,
                             steps, dev=dev, frames=frames, caps={
                                 ("prefill", 0): tally_off} if cfg.moe
                             else None)
    vs = bounded = axis_logits_vs(torch, sharded, unsharded)
    moe = None
    if cfg.moe:
        n_moe = sum(cfg.is_moe_layer(li % cfg.layer_period)
                    for li in range(cfg.n_layers))
        mine = moe_summary(torch, tally, n_moe, size, shardmap)
        theirs = moe_summary(torch, tally_off, n_moe, 0, False)
        moe = {"first_prefill_tokens": len(prompts[0]), "moe_layers": n_moe,
               "dispatch": "apply_moe_shardmap" if shardmap else
               "apply_moe over the batch",
               "pairs": mine["pairs"], "kept_sharded": mine["kept"],
               "kept_unsharded_apply_moe": theirs["kept"],
               "layer0_choices_differ": choices_differ(
                   mine["layer0_topk"], theirs["layer0_topk"])}
        check(mine["pairs"] == theirs["pairs"] == n_moe * len(
            prompts[0]) * cfg.moe_top_k, f"MoE pairs {moe}")
        if shardmap:
            with same_dispatch_moe(torch, mlp, plans[0], shape):
                same = axis_traffic(torch, cfg, plans, params, prompts,
                                    forced, steps, dev=dev, frames=frames)
            bounded = axis_logits_vs(torch, sharded, same)
            moe["vs_unsharded_same_dispatch"] = bounded
            del same
    witness = vs32 = None
    if rec_op is None:
        check(bounded["max_rel_logit_err"] <= LM_LOGIT_RTOL,
              f"{name} {shape}: sharded logits {bounded} beyond "
              f"{LM_LOGIT_RTOL} of the unsharded padded model's")
    else:
        plain_run = axis_traffic(torch, cfg, plans, params, prompts, forced,
                                 steps, dev=dev, frames=frames, impl="ref")
        witness = axis_logits_vs(torch, plain_run, unsharded)
        del plain_run
        for key in ("max_rel_logit_err", "mean_rel_logit_err"):
            check(vs[key] <= AXIS_WITNESS_FACTOR * witness[key],
                  f"{name} {shape}: sharded bf16 logits' {key} {vs[key]} "
                  f"beyond {AXIS_WITNESS_FACTOR} x the unsharded model's "
                  f"own gap to its plain versions, {witness[key]}")
    unpadded = axis_traffic(torch, cfg, (unpadded_plan(cfg),) * 2, flat,
                            prompts, forced, steps, dev=dev, frames=frames)
    if rec_op is not None:          # float32 over the whole traffic
        del params, flat
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = init_params(cfg32, plans[0], seed=seed, device=dev,
                          max_seq=max_seq)
        runs = [axis_traffic(torch, cfg32, plans, p32, prompts, forced,
                             steps, m, dev=dev, frames=frames)
                for m in (mesh, None)]
        vs32 = axis_logits_vs(torch, *runs)
        check(vs32["max_rel_logit_err"] <= RNN_F32_RTOL,
              f"{name} {shape}: float32 sharded logits {vs32} beyond "
              f"{RNN_F32_RTOL} of the unsharded padded model's")
        del p32, runs
        params = flat = None
    line = {
        "phase": f"model_axis.{name}.{shape['data']}x{shape['model']}",
        "arch": name, "mesh": shape, "virtual_shards": size,
        "dtype": cfg.dtype,
        "reduced": None if cfg is full_cfg else
        f"{cfg.n_layers} of {full_cfg.n_layers} layers: one period",
        "plans": {k: dataclasses.asdict(p) for k, p in
                  zip(("prefill", "decode"), plans)},
        "head_padding": {"q": [cfg.n_heads, plans[0].n_heads_padded],
                         "kv": [cfg.n_kv_heads, plans[0].n_kv_heads_padded],
                         "kv_sharded": plans[0].kv_sharded,
                         "decode_cache": "kv_heads" if by_heads else
                         "kv_dh",
                         "vocab": [cfg.vocab_size, plans[0].vocab_padded]},
        **pbytes, "peak_device_bytes": peak, "init_params_ms": init_ms,
        "traffic": {"prompts": [len(p) for p in prompts],
                    "steps": list(steps),
                    "frames": None if frames is None else
                    list(frames.shape)},
        "prefill_ms": {"sharded": sharded["prefill_ms"],
                       "unsharded_padded": unsharded["prefill_ms"],
                       "unpadded": unpadded["prefill_ms"]},
        "step_ms_median": {k: float(np.median(r["step_ms"])) for k, r in
                           (("sharded", sharded),
                            ("unsharded_padded", unsharded),
                            ("unpadded", unpadded))},
        "launches": launches, "launches_expected": want,
        "collectives": collectives, "kernels_full_width": full,
        "vs_unsharded_padded": vs, "logit_rtol": LM_LOGIT_RTOL,
        "moe": moe, "unsharded_vs_plain": witness,
        "witness_factor": None if witness is None else AXIS_WITNESS_FACTOR,
        "vs_unsharded_padded_float32": vs32,
        "float32_logit_rtol": None if vs32 is None else RNN_F32_RTOL,
        "phase_seconds": time.perf_counter() - t_phase}
    del params, flat, sharded, unsharded, unpadded, frames
    torch.cuda.empty_cache()
    return [line]


def phase_model_axis_train(torch, seed: int, dev="cuda") -> list:
    """``MODEL_AXIS_TRAIN``: Granite's train steps on the (data 2, model
    8) virtual mesh at full width, cut to ``n_layers`` (float32 master
    weights, bf16
    activations, the plain paths under autograd: no kernel) with ZeRO-1
    moments (``state_specs(zero1=True)``, held as each shard's blocks),
    on one ``TokenStream`` batch. Reads each step's ms, loss and gradient
    norm, the moments' bytes per shard beside the unsharded moments', and
    the peak."""
    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline as pipe
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.launch.mesh import ModelMesh
    from repro_torch.models.model import init_params
    from repro_torch.sharding.rules import make_plan
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    t_phase = time.perf_counter()
    run = MODEL_AXIS_TRAIN
    cfg = dataclasses.replace(get_arch(run["arch"]), n_layers=run["n_layers"])
    shape = run["mesh"]
    mesh = ModelMesh.virtual(shape, dev)
    plan = make_plan(cfg, shape, "train", run["batch"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, plan, seed=seed, device=dev,
                         dtype=torch.float32)
    specs = ts.mesh_state_specs(params, plan, mesh, zero1=True)
    state = ts.init_train_state(params, mesh, specs["opt"]["mu"])
    step = ts.make_train_step(cfg, plan, ts.TrainConfig(opt=opt.OptConfig(
        lr=run["lr"], warmup_steps=1)), mesh=mesh)
    data = pipe.TokenStream(pipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=run["seq"],
        global_batch=run["batch"]))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(0).items()}
    zero_counts()
    steps = []
    for _ in range(run["steps"]):
        (state, met), ms = timed(lambda: step(state, batch))
        steps.append({"ms": ms, "loss": float(met["loss"]),
                      "aux": float(met["aux"]),
                      "grad_norm": float(met["grad_norm"]),
                      "opt_ms": met["opt_s"] * 1e3})
        check(np.isfinite(steps[-1]["loss"]) and
              np.isfinite(steps[-1]["grad_norm"]), f"train step {steps}")
    check(fk.launches == pk.launches == 0,
          f"a train step launched kernels ({fk.launches}, {pk.launches})")
    mu, nu = state["opt"]["mu"], state["opt"]["nu"]
    per_shard = [mu.shard_bytes(s) + nu.shard_bytes(s)
                 for s in range(mesh.size)]
    whole = 2 * tensor_bytes(state["params"])
    check(max(per_shard) < whole / mesh.shape["model"],
          f"ZeRO-1 moments per shard {per_shard} not below "
          f"{whole} / {mesh.shape['model']}")
    line = {"phase": f"model_axis.train.{run['arch']}", "mesh": shape,
            "plan": dataclasses.asdict(plan), "batch": run["batch"],
            "reduced": f"{cfg.n_layers} of {get_arch(run['arch']).n_layers}"
                       " layers", "params": cfg.param_count(),
            "seq": run["seq"], "lr": run["lr"], "steps": steps,
            "tokens_per_s": run["batch"] * run["seq"] / steps[-1]["ms"]
            * 1e3,
            "moment_bytes_per_shard": per_shard,
            "moment_bytes_unsharded": whole,
            "moment_spec_examples": {
                n: specs["opt"]["mu"][n] for n in (
                    "embed.table", "layers.0.attn.wq",
                    "layers.0.moe.w_up", "layers.0.ln1.scale")},
            "peak_device_bytes": torch.cuda.max_memory_allocated() - base,
            "phase_seconds": time.perf_counter() - t_phase}
    del state, params
    torch.cuda.empty_cache()
    return [line]


KERNEL_ORDER = ("sivf_fused_search", "sivf_fused_search[filtered]",
                "sivf_pq_fused_search", "sivf_pq_fused_search[filtered]",
                "reclaim", "sivf_scan", "topk", "paged_attention",
                "flash_attention", "mamba_scan", "wkv6")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    faulthandler.enable()           # a crash prints every thread's stack
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
    hbm = hbm_bytes_per_s(torch.cuda.get_device_name(0))
    rows = {}
    got = run("workload", lambda: phase_workload(torch, args.seed))
    if got:
        wl, line = got
        emit(line)
        res = run("kmeans_repeat", lambda: kmeans_repeat_check(torch, wl))
        if res:
            emit(res)
        # each path, then the phases that reuse its index (the unfused path
        # first: the full-size phase ends with a reclaim-heavy delete)
        paths = (("main_path", phase_main,
                  (("unfused", phase_unfused), ("mesh.main", phase_mesh_main),
                   ("mesh.lifecycle", phase_mesh_lifecycle),
                   ("mesh.tiered", phase_mesh_tiered),
                   ("mesh.serve", phase_mesh_serve),
                   ("full_size", phase_full_size),
                   ("persist", phase_persist), ("tiered", phase_tiered),
                   ("maintain", phase_maintain),
                   ("serve.coalesce", phase_serve_coalesce),
                   ("serve.prefix", phase_serve_prefix),
                   ("serve.load", phase_serve_load),
                   ("serve.tiered", phase_serve_tiered),
                   ("serve.telemetry", phase_serve_telemetry))),
                 ("pq_main_path", phase_pq_main,
                  (("mesh.pq", phase_mesh_pq),
                   ("pq_full_size", phase_pq_full_size),
                   ("pq_lifecycle", phase_pq_lifecycle),
                   ("pq.serve.coalesce", phase_pq_serve))))
        for name, drive_fn, then in paths:
            out = {"queries": wl["queries"], "wl": wl}
            lines = run(name, lambda: drive_fn(torch, wl, out))
            for ln in lines or []:
                emit(ln)
            for full_name, full_fn in then if lines else ():
                got = run(full_name, lambda: full_fn(torch, hbm, out))
                if got:
                    for ln in got[0]:
                        emit(ln)
                    rows.update({r["name"]: r for r in got[1]})
            for key in ("ckpt", "mesh_ckpt"):    # checkpoints under build/
                if key in out:
                    shutil.rmtree(out[key], ignore_errors=True)
            out.clear()                 # free the path's index
            torch.cuda.empty_cache()
        for ln in run("baselines", lambda: phase_baselines(torch, wl)) or []:
            emit(ln)
        del wl
        torch.cuda.empty_cache()
    got = run("lm", lambda: phase_lm(torch, args.seed, hbm))
    if got:
        for ln in got[0]:
            emit(ln)
        rows.update({r["name"]: r for r in got[1]})
    for name in RNN_PHASES:
        got = run(name, lambda: phase_rnn(torch, name, args.seed, hbm))
        if got:
            for ln in got[0]:
                emit(ln)
            rows.update({r["name"]: r for r in got[1]})
    for name in ARCH_PHASES:
        for ln in run(f"arch.{name}",
                      lambda: phase_arch(torch, name, args.seed)) or []:
            emit(ln)
    for name, fn in (("whisper", phase_whisper), ("train", phase_train)):
        for ln in run(name, lambda: fn(torch, args.seed)) or []:
            emit(ln)
    for name, shape, steps in MODEL_AXIS_CELLS:
        for ln in run(f"model_axis.{name}.{shape['data']}x{shape['model']}",
                      lambda: phase_model_axis(torch, name, shape, steps,
                                               args.seed)) or []:
            emit(ln)
    for ln in run("model_axis.train",
                  lambda: phase_model_axis_train(torch, args.seed)) or []:
        emit(ln)
    for name, by_route in SERVE_LAUNCHES.items():
        if name in rows:
            rows[name]["serve_launches"] = by_route
    if BASE_LAUNCHES:                   # the baselines beside SIVF
        for name, by_route in (
                ("topk", {"warp": BASE_LAUNCHES["topk[warp]"],
                          "block": BASE_LAUNCHES["topk[block]"]}),
                ("sivf_fused_search",
                 {"grouped": BASE_LAUNCHES["sivf_fused_search[grouped]"]})):
            if name in rows:
                rows[name]["baselines_launches"] = by_route
    for name in ("flash_attention", "paged_attention"):
        if name in rows and ARCH_LAUNCHES:
            rows[name]["arch_launches"] = {
                arch: n[name] for arch, n in ARCH_LAUNCHES.items()}
        if name in rows and WHISPER_LAUNCHES:
            rows[name]["whisper_launches"] = WHISPER_LAUNCHES[name]
    for name in ("flash_attention", "paged_attention", "wkv6",
                 "mamba_scan"):
        if name in rows and MODEL_AXIS_LAUNCHES:   # virtual model meshes
            rows[name]["model_axis_launches"] = {
                cell: {"total": n[name], "per_shard": n["per_shard"][name]}
                for cell, n in MODEL_AXIS_LAUNCHES.items() if name in n}
    for name in ("paged_attention", "wkv6", "mamba_scan"):
        if name in rows:                # each phase's dense decode
            rows[name]["dense_decode_launches"] = {
                phase: n[name] for phase, n in DENSE_LAUNCHES.items()
                if name in n}
    for name, by_route in MESH_LAUNCHES.items():
        if name in rows:                # four virtual shards on one card
            rows[name]["mesh_launches"] = by_route
    if rows:
        emit({"kernels": [rows[n] for n in KERNEL_ORDER if n in rows]})
    print(smi(), flush=True)
    if failed or set(rows) != set(KERNEL_ORDER):
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    raise SystemExit(main())
