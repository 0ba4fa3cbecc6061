"""The port's PQ slice against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and go through ``repro`` and
``repro_torch`` (``device="cpu"``). What each comparison holds:

  * codec: ``encode`` codes ``==``; ``decode`` and ``adc_tables``
    allclose(rtol=atol=1e-5), since the einsums sum in another order;
  * ``train_pq``: the JAX PRNG cannot be matched, so training is
    deterministic under a fixed ``torch.Generator`` and its quantization
    MSE is within 10 % of the reference's on the same sample;
  * ADC scan: fed the reference's ADC table, the port's
    ``scan_slabs_topk_pq`` (the plain version the CUDA kernel equals bit
    for bit) gives ``==`` distances and labels. The reference's Pallas
    kernel does not run in interpret mode with the installed jax (it
    names ``pltpu.TPUCompilerParams``), so the reference side is its XLA
    scan ``core.scan_slabs_topk_pq``, which its own tests hold the
    kernel to;
  * churn with overwrites and both abort kinds: every integer plane
    (``codes`` and ``attrs`` included) ``==``;
  * the ``Index`` flow with the reference's codebooks carried across
    (``pq_codebooks=``): the same reports and search labels;
  * the compacted route's order (``ref.sivf_pq_fused_search_split_ref``:
    live entries compacted, windows dealt to streams, the merges; and rows
    cut into contiguous shares): ``==`` to the fold and, through the same
    inputs as the ADC scan test, to the reference's XLA scan on edge
    cases; and ``pq_fused.launch_plan`` on meta tensors.

Sizes stay small (dim 16, m in {4, 8}, nbits in {4, 5}, C=32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sivf
import sivf_torch
from repro import core as jcore
from repro.core import pq as jpq
from repro.core import state as jstate
from repro_torch import interop
from repro_torch.core import index as tix
from repro_torch.core import pq as tpq
from repro_torch.core.quantizer import assign
from repro_torch.core import state as tst
from repro_torch.kernels.sivf_scan import pq_fused, ref

from test_torch_state import assert_planes_equal, jax_planes

D, NL = 16, 4
ATTRS = ("tenant", "ts")
B = 64                       # every insert / delete batch: one jit shape
POOL = dict(n_slabs=24, capacity=32, n_max=2048, max_chain=8)

# the reference's column scans, jitted so that repeated shapes compile once
jscan = jax.jit(jcore.scan_slabs_topk, static_argnames=("cfg", "k",
                                                       "fstruct"))
jscan_pq = jax.jit(jcore.scan_slabs_topk_pq, static_argnames=("cfg", "k",
                                                             "fstruct"))
jencode, jdecode = jax.jit(jpq.encode), jax.jit(jpq.decode)
jadc = jax.jit(jpq.adc_tables, static_argnames=("metric",))
jinit = jax.jit(jcore.init_state, static_argnums=0)


def codebooks(rng, m, nbits):
    """Codebooks both packages share (random: parity needs no training)."""
    return rng.normal(size=(m, 1 << nbits, D // m)).astype(np.float32)


class Twin:
    """One index with filter attributes (and PQ when ``m`` is set) in both
    packages, from the same centroids and codebooks, driven op by op in
    ``B``-row batches and compared plane by plane after every op."""

    def __init__(self, rng, m=None, nbits=4, metric="l2", **pool):
        pq = None if m is None else dict(m=m, nbits=nbits)
        self.jcfg = jcore.SIVFConfig(
            dim=D, n_lists=NL, metric=metric, attributes=ATTRS,
            pq=None if pq is None else jcore.PQConfig(**pq),
            **{**POOL, **pool})
        self.cfg = interop.config_from_dict(dataclasses.asdict(self.jcfg))
        self.cents = rng.normal(size=(NL, D)).astype(np.float32)
        cb = None if m is None else codebooks(rng, m, nbits)
        self.js = jinit(self.jcfg, jnp.asarray(self.cents),
                        None if cb is None else jnp.asarray(cb))
        self.ts = tst.init_state(self.cfg, self.cents, cb, device="cpu")
        self.attrs = np.zeros((self.cfg.n_max, 2), np.int32)  # stamps by id

    def check(self):
        assert_planes_equal(jax_planes(self.js),
                            interop.state_to_numpy(self.ts))

    def insert(self, vecs, ids, attrs, lists=None):
        """One ``B``-row batch; returns this batch's error bits."""
        vecs = np.asarray(vecs, np.float32)
        if lists is None:       # routed once, handed to both packages
            lists = assign(torch.from_numpy(self.cents),
                           torch.from_numpy(vecs), self.cfg.metric).numpy()
        ids, lists, attrs = (np.asarray(a, np.int32)
                             for a in (ids, lists, attrs))
        self.js = jcore.insert(self.jcfg, jstate.clear_error(self.js),
                               jnp.asarray(vecs), jnp.asarray(ids),
                               jnp.asarray(lists), attrs=jnp.asarray(attrs))
        self.ts = tix.insert(self.cfg, tst.clear_error(self.ts),
                             torch.from_numpy(vecs), torch.from_numpy(ids),
                             torch.from_numpy(lists),
                             attrs=torch.from_numpy(attrs))
        self.check()
        err = int(self.js.error)
        if not err & (tst.ERR_POOL_EXHAUSTED | tst.ERR_CHAIN_OVERFLOW):
            ok = (ids >= 0) & (ids < self.cfg.n_max)
            self.attrs[ids[ok]] = attrs[ok]     # last duplicate wins
        return err

    def delete(self, ids):
        ids = np.asarray(ids, np.int32)
        self.js = jcore.delete(self.jcfg, self.js, jnp.asarray(ids))
        self.ts = tix.delete(self.cfg, self.ts, torch.from_numpy(ids))
        self.check()

    def fill(self, rng, n_batches, start=0):
        """``n_batches`` full batches of fresh ids from ``start``."""
        for i in range(n_batches):
            lo = start + i * B
            attrs = np.stack([rng.integers(0, 5, B),
                              rng.integers(0, 100, B)], axis=1)
            self.insert(rng.normal(size=(B, D)), np.arange(lo, lo + B),
                        attrs)

    def live_ids(self) -> np.ndarray:
        return np.nonzero(self.ts.att_slab.numpy() >= 0)[0]

    def table(self, qs, nprobe, use_tables=True):
        lists = jcore.probe(self.js.centroids, jnp.asarray(qs), nprobe,
                            self.cfg.metric)
        return (jcore.gather_tables if use_tables else jcore.walk_chains)(
            self.jcfg, self.js, lists)


def filled_twin(rng, **kw) -> Twin:
    """Four batches (256 ids), then every third id deleted."""
    tw = Twin(rng, **kw)
    tw.fill(rng, 4)
    dead = np.arange(0, 4 * B, 3)
    for lo in range(0, len(dead), B):
        tw.delete(np.pad(dead[lo:lo + B], (0, B - len(dead[lo:lo + B])),
                         constant_values=-1))
    return tw


@pytest.fixture(scope="module", params=[("l2", 4, 4), ("ip", 8, 5),
                                        ("l2", 8, 4)],
                ids=["l2-m4-nbits4", "ip-m8-nbits5", "l2-m8-nbits4"])
def pq_twin(request):
    metric, m, nbits = request.param
    return filled_twin(np.random.default_rng(1), m=m, nbits=nbits,
                       metric=metric)


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,nbits", [(4, 4), (8, 5)])
def test_codec_matches_reference(rng, m, nbits):
    cb = codebooks(rng, m, nbits)
    xs = rng.normal(size=(300, D)).astype(np.float32)
    qs = rng.normal(size=(9, D)).astype(np.float32)
    tcb = torch.from_numpy(cb)
    codes = tpq.encode(tcb, torch.from_numpy(xs))
    jcodes = np.asarray(jencode(jnp.asarray(cb), jnp.asarray(xs)))
    assert codes.dtype == torch.uint8 and np.array_equal(codes.numpy(),
                                                         jcodes)
    np.testing.assert_allclose(
        tpq.decode(tcb, codes).numpy(),
        np.asarray(jdecode(jnp.asarray(cb), jnp.asarray(jcodes))),
        rtol=1e-5, atol=1e-5)
    for metric in ("l2", "ip"):
        np.testing.assert_allclose(
            tpq.adc_tables(tcb, torch.from_numpy(qs), metric).numpy(),
            np.asarray(jadc(jnp.asarray(cb), jnp.asarray(qs), metric)),
            rtol=1e-5, atol=1e-5)
    sub = tpq.subspaces(torch.from_numpy(xs), m)
    assert np.array_equal(sub.numpy(),
                          np.asarray(jpq.subspaces(jnp.asarray(xs), m)))


@pytest.mark.parametrize("m,nbits", [(4, 4), (8, 5)])
def test_train_pq_is_seeded_and_matches_reference_quality(rng, m, nbits):
    xs = rng.normal(size=(1024, D)).astype(np.float32)
    txs = torch.from_numpy(xs)
    a, b = (tpq.train_pq(txs, m, nbits, iters=16,
                         generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert a.shape == (m, 1 << nbits, D // m) and torch.equal(a, b)
    jcb = jpq.train_pq(jax.random.key(0), jnp.asarray(xs), m, nbits,
                       iters=16)
    ref_mse = float(jnp.mean((jdecode(jcb, jencode(jcb, jnp.asarray(
        xs))) - xs) ** 2))
    mse = float(((tpq.decode(a, tpq.encode(a, txs)) - txs) ** 2).mean())
    assert abs(mse / ref_mse - 1) <= 0.10, (mse, ref_mse)
    with pytest.raises(ValueError, match="divisible"):
        tpq.train_pq(txs, 5)


# ---------------------------------------------------------------------------
# ADC scan: bit for bit against the reference's scan, one shared table
# ---------------------------------------------------------------------------

def assert_pq_scan_matches(tw, rng, k, nprobe, use_tables=True, q=6,
                           cf=None):
    """Fed the reference's ADC table, the port's PQ scan (on CPU tensors:
    the plain version) gives ``==`` distances and labels."""
    qs = rng.normal(size=(q, D)).astype(np.float32)
    table = tw.table(qs, nprobe, use_tables)
    adc = jadc(tw.js.pq_codebooks, jnp.asarray(qs), tw.cfg.metric)
    jkw, tkw = filter_args(cf)
    jd, jl = jscan_pq(tw.jcfg, tw.js, jnp.asarray(qs), table, k, adc=adc,
                      **jkw)
    launches = pq_fused.launches + pq_fused.filtered_launches
    td, tl = tix.scan_slabs_topk_pq(
        tw.cfg, tw.ts, torch.from_numpy(qs), torch.from_numpy(
            np.array(table)), k, adc=torch.from_numpy(np.array(adc)), **tkw)
    assert pq_fused.launches + pq_fused.filtered_launches == launches
    assert np.array_equal(td.numpy(), np.asarray(jd))     # bit for bit
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    return td.numpy(), tl.numpy()


def filter_args(cf):
    """A compiled filter as the reference's and the port's keywords."""
    if cf is None:
        return {}, {}
    return (dict(fstruct=cf.structure,
                 fconsts=jnp.asarray(cf.consts, jnp.int32)),
            dict(fstruct=cf.structure,
                 fconsts=torch.tensor(cf.consts, dtype=torch.int32)))


@pytest.mark.parametrize("use_tables", [True, False],
                         ids=["tables", "pointer-walk"])
def test_pq_scan_matches_reference(rng, pq_twin, use_tables):
    """Dead slots, -1 pads, and k beyond the live rows, at full probe."""
    dead = np.arange(0, 4 * B, 3)
    n_live = len(pq_twin.live_ids())
    d, lab = assert_pq_scan_matches(pq_twin, rng, k=n_live + 20, nprobe=NL,
                                    use_tables=use_tables)
    assert np.isinf(d[:, n_live:]).all() and (lab[:, n_live:] == -1).all()
    assert (lab[:, :n_live] >= 0).all()
    assert not np.isin(lab, dead).any()


def test_pq_plain_version_sums_from_the_first_term():
    """A -0.0 first lookup stays -0.0 (0.0 + -0.0 would give +0.0), and
    ties keep the lowest slot."""
    adc = torch.tensor([[[-0.0, 1.0], [-0.0, 2.0]]])          # Q=1, m=2
    codes = torch.zeros((1, 32, 2), dtype=torch.uint8)
    ids = torch.arange(32, dtype=torch.int32).reshape(1, 32)
    bitmap = torch.full((1, 1), -1, dtype=torch.int32)        # all live
    d, lab = ref.sivf_pq_fused_search_ref(
        adc, torch.zeros((1, 1), dtype=torch.int32), codes, ids, bitmap, 3)
    assert torch.signbit(d).all() and lab.tolist() == [[0, 1, 2]]


# ---------------------------------------------------------------------------
# The compacted route's order: compaction, windows, merges (and shares)
# ---------------------------------------------------------------------------

SPLIT_PQ_CASES = ("share_boundary_ties", "neg_zero_first_term",
                  "same_slab_consecutive_t", "all_pad_row",
                  "fewer_live_than_e", "k_beyond_live", "k_at_least_c",
                  "filtered_1pct", "filtered_50pct")
# (n_split, window, streams, lanes): the kernel's grouping first, then
# shares cut mid-row, windows of one or a few entries, streams of one lane
SPLIT_PQ_ORDERS = ((1, 2048, 8, 32), (2, 64, 3, 8), (3, 32, 1, 32),
                   (5, 96, 8, 4))


def live_slot(tw, slab) -> int:
    """The first live slot of ``slab`` in the port's state."""
    words = tw.ts.bitmap[slab].numpy().view(np.uint32)
    bits = (words[:, None] >> np.arange(32)) & 1
    return int(np.nonzero(bits.reshape(-1))[0][0])


def split_pq_case(tw, name, rng):
    """(queries [6, D], table [6, T], adc [6, m, ksub], k, compiled filter)
    of one edge case, built on the twin's state: the adc table is the
    reference's for the queries unless the case rewrites it."""
    from repro_torch.core import filters as flt
    qs = rng.normal(size=(6, D)).astype(np.float32)
    table = np.array(tw.table(qs, NL))
    adc = np.array(jadc(tw.js.pq_codebooks, jnp.asarray(qs), tw.cfg.metric))
    k, cf = 10, None
    live_cols = [np.nonzero(r >= 0)[0] for r in table]
    if name == "share_boundary_ties":   # integer terms: ties everywhere
        adc = rng.integers(0, 2, adc.shape).astype(np.float32)
    elif name == "neg_zero_first_term":
        # row 0: slot a (an earlier column) sums to +0.0; slot b (a later
        # column, another slab) to -0.0, from a -0.0 first term on; the
        # rest of the row is >= 1
        cols = live_cols[0]
        sa = int(table[0, cols[0]])
        sb = int(next(table[0, c] for c in cols[::-1] if table[0, c] != sa))
        codes = tw.ts.codes.numpy()
        ca = codes[sa, live_slot(tw, sa)].astype(int)
        cb = codes[sb, live_slot(tw, sb)].astype(int)
        adc[0] = 1.0 + np.abs(adc[0])
        adc[0, np.arange(adc.shape[1]), ca] = 0.0
        adc[0, np.arange(adc.shape[1]), cb] = -0.0
    elif name == "same_slab_consecutive_t":
        table[1, :3] = table[1, live_cols[1][0]]
        table[2, 4:6] = table[2, live_cols[2][-1]]
    elif name == "all_pad_row":
        table[0] = -1
    elif name == "fewer_live_than_e":   # one live entry: empty shares too
        keep = table[3, live_cols[3][0]]
        table[3] = -1
        table[3, 7] = keep
    elif name == "k_beyond_live":
        k = len(tw.live_ids()) + 20
    elif name == "k_at_least_c":
        k = 40                           # C = 32
    elif name == "filtered_1pct":
        cf = flt.compile_filter(flt.Range("ts", 0, 1), ATTRS)
    elif name == "filtered_50pct":
        cf = flt.compile_filter(flt.Range("ts", 0, 50), ATTRS)
    return qs, table, adc, k, cf


def in_total_order(d, lab):
    """A fold's result re-sorted as ``lax.top_k`` of ``-d`` orders it:
    among equal distances -0.0 before +0.0 (the IEEE total order), else
    the fold's own order."""
    pos_zero = (d == 0) & ~np.signbit(d)
    idx = np.lexsort((pos_zero, d), axis=1)
    return (np.take_along_axis(d, idx, 1), np.take_along_axis(lab, idx, 1))


@pytest.mark.parametrize("name", SPLIT_PQ_CASES)
def test_split_order_equals_fold_and_reference(rng, pq_twin, name):
    """The compacted route's order gives the fold's bits (``==`` on distances,
    sign bits included, and labels) under every grouping of
    ``SPLIT_PQ_ORDERS``, and the reference's XLA scan fed the same table
    and ADC table gives the same result. The reference's ``lax.top_k``
    puts -0.0 before +0.0 where the fold (and the TPU kernel's fold,
    ``fused.py:61-91``) ties them, so the fold's result is compared in
    that order; only the -0.0 case has a tie between signed zeros."""
    tw = pq_twin
    qs, table, adc, k, cf = split_pq_case(tw, name, rng)
    jkw, tkw = filter_args(cf)
    if cf is not None:
        tkw["attrs"] = tw.ts.attrs
    st = tw.ts
    args = (torch.from_numpy(adc), torch.from_numpy(table), st.codes, st.ids,
            st.bitmap, k)
    fd, fl = ref.sivf_pq_fused_search_ref(*args, **tkw)
    for n_split, window, streams, lanes in SPLIT_PQ_ORDERS:
        sd, sl = ref.sivf_pq_fused_search_split_ref(
            *args, **tkw, n_split=n_split, window=window, streams=streams,
            lanes=lanes)
        assert np.array_equal(sd.numpy().view(np.int32),
                              fd.numpy().view(np.int32)), (name, n_split)
        assert torch.equal(sl, fl), (name, n_split, window)
    jd, jl = jscan_pq(tw.jcfg, tw.js, jnp.asarray(qs), jnp.asarray(table), k,
                      adc=jnp.asarray(adc), **jkw)
    td, tl = in_total_order(fd.numpy(), fl.numpy())
    assert np.array_equal(td.view(np.int32), np.asarray(jd).view(np.int32))
    assert np.array_equal(tl, np.asarray(jl))
    assert ((fl == -1) == torch.isinf(fd)).all()
    if name == "share_boundary_ties":
        assert (fd[:, 1:] == fd[:, :-1]).sum() > 20
    if name == "neg_zero_first_term":   # +0.0 (earlier column) ties -0.0
        assert fd[0, 0] == 0 and fd[0, 1] == 0
        assert not torch.signbit(fd[0, 0]) and torch.signbit(fd[0, 1])
    if name == "all_pad_row":
        assert bool(torch.isinf(fd[0]).all() and (fl[0] == -1).all())
    if name == "k_beyond_live":
        assert bool(torch.isinf(fd[:, -20:]).all())


def test_pq_launch_plan_reads_shapes_only():
    """Route and shared memory come from shapes alone (meta tensors):
    ``compacted`` for m a multiple of 4 up to 64 and a power of two ksub
    where its block's shared memory fits, at every Q; ``per_query``
    elsewhere, another CUDA route, where the compacted block's slab list,
    top-k or leaf program would not fit; the limits refused with
    ValueError."""
    def meta(*shape):
        return torch.empty(shape, device="meta")

    q, t, s = 1024, 1024, 16384
    for qn in (1, 16, q):
        p = pq_fused.launch_plan(meta(qn, 32, 256), meta(qn, t),
                                 meta(s, 128, 32), 10)
        assert p == {"route": "compacted", "smem_bytes":
                     pq_fused.compacted_smem_bytes(32, 256, 10, t)}
    assert pq_fused.route(32, 256, 10, t) == "compacted"
    # m = 64, k = 1024 at nprobe 256 x max_chain 64 columns, and m = 32,
    # k = 1024 past about 21,000 columns: the compacted block exceeds
    # 227 KB, the per_query one does not
    for m, t_len in ((64, 16384), (32, 24000)):
        assert pq_fused.route(m, 256, 1024, 1024) == "compacted"
        assert pq_fused.route(m, 256, 1024, t_len) == "per_query"
        p = pq_fused.launch_plan(meta(256, m, 256), meta(256, t_len),
                                 meta(s, 128, m), 1024)
        assert p == {"route": "per_query",
                     "smem_bytes": pq_fused.smem_bytes(m, 256, 128, 1024)}
        with pytest.raises(ValueError):
            pq_fused.launch_plan(meta(256, m, 256), meta(256, t_len),
                                 meta(s, 128, m), 1024, "compacted")
    big = pq_fused.MAX_SMEM // 4         # filter words alone fill the block
    assert pq_fused.route(32, 256, 10, t, big) == "per_query"
    assert pq_fused.launch_plan(meta(8, 32, 256), meta(8, t),
                                meta(s, 128, 32), 10,
                                filter_words=big)["route"] == "per_query"
    for m, ksub in ((6, 256), (68, 16), (32, 200)):
        assert pq_fused.route(m, ksub, 10, 12) == "per_query"
        p = pq_fused.launch_plan(meta(8, m, ksub), meta(8, 12),
                                 meta(24, 32, m), 10)
        assert p == {"route": "per_query",
                     "smem_bytes": pq_fused.smem_bytes(m, ksub, 32, 10)}
    for args, kw in (((meta(8, 32, 256), meta(8, 12), meta(24, 48, 32), 10),
                      {}),                           # C not a multiple of 32
                     ((meta(8, 32, 256), meta(8, 12), meta(24, 32, 32), 0),
                      {}),
                     ((meta(8, 32, 256), meta(8, 12), meta(24, 32, 32),
                       1025), {}),
                     ((meta(8, 6, 256), meta(8, 12), meta(24, 32, 6), 10),
                      {"route_name": "compacted"}),
                     ((meta(8, 32, 256), meta(8, 12), meta(24, 32, 32), 10),
                      {"route_name": "other"}),
                     ((meta(8, 256, 256), meta(8, 12), meta(24, 32, 256),
                       10), {})):            # the table exceeds 227 KB
        with pytest.raises(ValueError):
            pq_fused.launch_plan(*args, **kw)


# ---------------------------------------------------------------------------
# State under churn
# ---------------------------------------------------------------------------

def test_pq_churn_planes_equal_reference(rng):
    """Overwrites, in-batch duplicates, bad ids, reclaim, then
    POOL_EXHAUSTED and CHAIN_OVERFLOW batches: after every op every plane
    of the two states agrees (``codes`` and ``attrs`` ``==``)."""
    tw = Twin(rng, m=4, nbits=4)
    for _ in range(4):
        ids = np.full(B, -1, np.int32)
        n = int(rng.integers(20, B))
        ids[:n] = rng.integers(-2, 2100, n)              # dupes, > n_max
        ids[: n // 3] = rng.integers(0, 30, n // 3)      # overwrites
        tw.insert(rng.normal(size=(B, D)), ids, rng.integers(0, 9, (B, 2)))
        tw.delete(rng.integers(-1, 2100, B))
    errs = 0
    for lo in range(900, 900 + 14 * B, B):     # fill the pool, lists evenly
        errs |= tw.insert(rng.normal(size=(B, D)), np.arange(lo, lo + B),
                          rng.integers(0, 9, (B, 2)),
                          lists=np.arange(B) % NL)
    assert errs == tst.ERR_POOL_EXHAUSTED
    live = tw.live_ids()
    for lo in range(0, len(live), B):
        tw.delete(np.pad(live[lo:lo + B], (0, max(0, lo + B - len(live))),
                         constant_values=-1))
    assert int(tw.ts.n_live) == 0
    errs = 0
    for lo in range(0, 5 * B, B):                  # one list past max_chain
        errs |= tw.insert(rng.normal(size=(B, D)), np.arange(lo, lo + B),
                          rng.integers(0, 9, (B, 2)),
                          lists=np.zeros(B, np.int32))
    assert errs == tst.ERR_CHAIN_OVERFLOW
    # the reference's planes, codes and attributes included, cross into
    # the port unchanged; a plane of the wrong width is refused
    planes = jax_planes(tw.js)
    assert_planes_equal(planes, interop.state_to_numpy(
        interop.state_from_numpy(tw.cfg, planes, device="cpu")))
    with pytest.raises(ValueError, match="plane codes"):
        interop.state_from_numpy(tw.cfg, {**planes,
                                          "codes": planes["codes"][..., :2]},
                                 device="cpu")


# ---------------------------------------------------------------------------
# The Index flow, codebooks carried across
# ---------------------------------------------------------------------------

def report_tuple(r):
    t = dataclasses.astuple(r)
    return t[:5] + (int(r.errors),) + t[6:]


@pytest.fixture(scope="module")
def index_pair():
    """The reference's ``sivf.Index`` and ``sivf_torch.Index(device="cpu")``
    on the same centroids and codebooks (carried across with
    ``pq_codebooks=``), driven by the same adds (attributes as a dict, as
    an array, as scalars), overwrite and removes (bad ids included).
    Returns both handles and each op's two reports."""
    rng = np.random.default_rng(3)
    kw = dict(dim=D, n_lists=NL, attributes=ATTRS, **POOL)
    jcfg = sivf.SIVFConfig(pq=sivf.PQConfig(m=8, nbits=5), **kw)
    tcfg = sivf_torch.SIVFConfig(pq=sivf_torch.PQConfig(m=8, nbits=5), **kw)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    cb = codebooks(rng, 8, 5)
    j = sivf.Index(jcfg, jnp.asarray(cents), pq_codebooks=cb, min_bucket=B)
    t = sivf_torch.Index(tcfg, cents, device="cpu", pq_codebooks=cb,
                         min_bucket=B)
    vecs = rng.normal(size=(3 * B, D)).astype(np.float32)
    tenant, ts = rng.integers(0, 4, 3 * B), rng.integers(0, 50, 3 * B)
    ops = [("add", vecs[:B], np.arange(B),
            {"tenant": tenant[:B], "ts": ts[:B]}),
           ("add", vecs[B:2 * B], np.arange(B, 2 * B),
            np.stack([tenant[B:2 * B], ts[B:2 * B]], 1)),
           ("add", vecs[2 * B:], np.arange(2 * B, 3 * B),
            {"tenant": tenant[2 * B:], "ts": ts[2 * B:]}),
           ("add", vecs[:40] + 1, np.arange(40), {"tenant": 3, "ts": 7}),
           ("remove", np.arange(50, 150, 2)),
           ("remove", np.array([5, 5, 9999, -1]))]
    reports = []
    for op in ops:
        if op[0] == "add":
            reports.append([x.add(op[1], op[2], attrs=op[3]) for x in (j, t)])
        else:
            reports.append([x.remove(op[1]) for x in (j, t)])
    return j, t, reports


def test_index_flow_matches_reference(index_pair):
    """The same reports, planes and stats."""
    j, t, reports = index_pair
    for rj, rt in reports:
        assert report_tuple(rt) == report_tuple(rj)
    assert [r.overwritten for _, r in reports] == [0, 0, 0, 40, 0, 0]
    assert_planes_equal(jax_planes(j.state), interop.state_to_numpy(t.state))
    sj, st = j.stats(), t.stats()
    for key in ("n_live", "compression_ratio", "code_bytes", "attr_bytes",
                "payload_bytes", "device_bytes"):
        assert st[key] == pytest.approx(sj[key]), key


@pytest.mark.parametrize("pred", [
    None, sivf.And(sivf.In("tenant", (0, 1)), sivf.Range("ts", 10, 40))],
    ids=["unfiltered", "filtered"])
def test_index_search_matches_reference(rng, index_pair, pred):
    """The same search labels, filtered and not."""
    j, t, _ = index_pair
    qs = rng.normal(size=(5, D)).astype(np.float32)
    dj, lj = j.search(qs, 10, 2, filter=pred)
    res = t.search(qs, 10, 2, filter=None if pred is None
                   else tpred_of(pred))
    assert np.array_equal(res.labels.numpy(), np.asarray(lj))
    np.testing.assert_allclose(res.distances.numpy(), np.asarray(dj),
                               rtol=1e-5, atol=1e-5)


def tpred_of(pred):
    """The port's copy of a reference predicate, node by node."""
    if isinstance(pred, sivf.And):
        return sivf_torch.And(*(tpred_of(p) for p in pred.preds))
    return getattr(sivf_torch, type(pred).__name__)(
        **dataclasses.asdict(pred))


def test_train_and_its_guards(rng):
    cfg = sivf_torch.SIVFConfig(dim=D, n_lists=NL, n_slabs=16, capacity=32,
                                n_max=256, pq=sivf_torch.PQConfig(m=4,
                                                                  nbits=4))
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    t = sivf_torch.Index(cfg, cents, device="cpu")
    vecs = rng.normal(size=(200, D)).astype(np.float32)
    with pytest.raises(RuntimeError, match="untrained"):
        t.add(vecs, np.arange(200))
    assert t.train(vecs, iters=4) is t
    again = sivf_torch.Index(cfg, cents, device="cpu").train(vecs, iters=4)
    assert torch.equal(t.state.pq_codebooks, again.state.pq_codebooks)
    assert t.add(vecs, np.arange(200)).accepted == 200
    assert t.state.data.shape == (16, 32, 0)
    st = t.state
    codes = tpq.encode(st.pq_codebooks, torch.from_numpy(vecs))
    assert torch.equal(st.codes[st.att_slab[:200].long(),
                                st.att_slot[:200].long()], codes)
    given = torch.randint(0, 16, (8, 4), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1))
    st = tix.insert(cfg, st, torch.from_numpy(vecs[:8]),
                    torch.arange(200, 208, dtype=torch.int32), codes=given)
    assert torch.equal(st.codes[st.att_slab[200:208].long(),
                                st.att_slot[200:208].long()], given)
    with pytest.raises(RuntimeError, match="non-empty"):
        t.train(vecs)
    d, lab = t.search(vecs[:3], 5, NL)
    assert bool(((lab >= 0) & (lab < 200)).all())
    assert bool(torch.isfinite(d).all() and (d[:, 1:] >= d[:, :-1]).all())
    with pytest.raises(ValueError, match="cfg.pq is None"):
        sivf_torch.Index(dataclasses.replace(cfg, pq=None), cents,
                         device="cpu", pq_codebooks=np.zeros((4, 16, 4)))
    with pytest.raises(ValueError, match="pq_codebooks shape"):
        sivf_torch.Index(cfg, cents, device="cpu",
                         pq_codebooks=np.zeros((4, 8, 4)))


def test_cuda_route_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        pq_fused.sivf_pq_fused_search_cuda(
            torch.zeros((2, 4, 16)), torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros((4, 32, 4), dtype=torch.uint8),
            torch.zeros((4, 32), dtype=torch.int32),
            torch.zeros((4, 1), dtype=torch.int32), 5)
    assert pq_fused.smem_bytes(32, 256, 128, 10) < 48 * 1024 \
        < pq_fused.smem_bytes(64, 256, 128, 10) < pq_fused.MAX_SMEM
