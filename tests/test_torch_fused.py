"""The port's fused scan->top-k (plain version) against the JAX reference.

The same slab planes and tables go through the reference's plain
versions of its fused kernel, as the reference's own tests run it on the
CPU: the streaming XLA scan ``core.scan_slabs_topk`` and the unfused
oracle ``kernels.sivf_scan.ops.sivf_fused_search(impl="ref")``. (The
Pallas kernel's interpret mode does not run with the installed jax: it
names ``pltpu.TPUCompilerParams``, which that version no longer has.)
They also go through the port's ``sivf_fused_search`` on CPU tensors: its
plain version, the function the CUDA kernel is held to bit for bit on
the card. Labels ``==``; distances allclose(rtol=atol=1e-5), since the
port sums dot products in eight lanes over d (``ref.dot_lanes``) and the
reference in XLA's blocks.
Tables stay tiny (Q <= 8, T <= 16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
import sivf_torch  # noqa: F401  (the core first: the kernels import it)
from repro import core as jcore
from repro.kernels.sivf_scan import ops as jops
from repro_torch.kernels.sivf_scan import fused, ops, ref


def port_search(state, qs, table, k, metric):
    t = {name: torch.from_numpy(np.array(getattr(state, name)))
         for name in ("data", "ids", "norms")}
    bitmap = torch.from_numpy(np.array(state.bitmap).view(np.int32))
    d, lab = ops.sivf_fused_search(
        torch.from_numpy(qs), torch.from_numpy(np.array(table)), t["data"],
        t["ids"], t["norms"], bitmap, k, metric=metric)
    return d.numpy(), lab.numpy()


def assert_matches_reference(cfg, state, qs, k, nprobe, use_tables=True):
    lists = jcore.probe(state.centroids, jnp.asarray(qs), nprobe, cfg.metric)
    table = (jcore.gather_tables if use_tables else jcore.walk_chains)(
        cfg, state, lists)
    assert table.shape[0] <= 8 and table.shape[1] <= 16
    launches = fused.launches
    d, lab = port_search(state, qs, table, k, cfg.metric)
    assert fused.launches == launches           # CPU: the plain version
    for rd, rl in (
            jops.sivf_fused_search(
                jnp.asarray(qs), table, state.data, state.ids, state.norms,
                state.bitmap, k, metric=cfg.metric, impl="ref"),
            jcore.scan_slabs_topk(cfg, state, jnp.asarray(qs), table, k)):
        assert np.array_equal(lab, np.asarray(rl))
        np.testing.assert_allclose(d, np.asarray(rd), rtol=1e-5, atol=1e-5)
    return d, lab


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("capacity", [32, 64])
def test_matches_reference_scan(rng, metric, capacity):
    cfg, state = parity.make_state(rng, dim=16, n_lists=4, n_slabs=24,
                                   capacity=capacity, metric=metric,
                                   max_chain=8)
    state, _, _ = parity.load_rows(cfg, state, rng, 200)
    state = jcore.delete(cfg, state, jnp.arange(0, 200, 3, dtype=jnp.int32))
    qs = rng.normal(size=(5, 16)).astype(np.float32)
    d, lab = assert_matches_reference(cfg, state, qs, k=7, nprobe=2,
                                      use_tables=metric == "l2")
    deleted = set(range(0, 200, 3))
    assert not deleted & set(lab.ravel().tolist())


def test_k_beyond_live_rows_pads_inf_and_minus_one(rng):
    cfg, state = parity.make_state(rng, dim=16, n_lists=4, n_slabs=24,
                                   capacity=32, max_chain=4)
    state, _, _ = parity.load_rows(cfg, state, rng, 6)
    qs = rng.normal(size=(3, 16)).astype(np.float32)
    d, lab = assert_matches_reference(cfg, state, qs, k=20, nprobe=4)
    assert np.isinf(d[:, 6:]).all() and (lab[:, 6:] == -1).all()
    assert (lab[:, :6] >= 0).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ties_keep_the_lowest_merge_index(rng, metric):
    """Duplicated vectors score identically in every implementation; the
    running entries and then the lowest slot must win."""
    cfg, state = parity.make_state(rng, dim=16, n_lists=4, n_slabs=24,
                                   capacity=32, metric=metric, max_chain=4)
    v = rng.normal(size=(4, 16)).astype(np.float32)
    vecs = np.repeat(v, 12, axis=0)                    # 4 groups of 12
    state, _, _ = parity.load_rows(cfg, state, rng, 48, vecs=vecs,
                                   lists=np.zeros(48, np.int32))
    qs = np.concatenate([v[:2] + 0.01, rng.normal(size=(2, 16))]
                        ).astype(np.float32)
    d, lab = assert_matches_reference(cfg, state, qs, k=16, nprobe=4)
    assert (d[0, :12] == d[0, 0]).all() and d[0, 12] > d[0, 0]
    assert lab[0, :12].tolist() == list(range(12))     # slot order wins


def test_empty_index_and_all_pad_table(rng):
    cfg, state = parity.make_state(rng, dim=16, n_lists=4, n_slabs=8,
                                   capacity=32, max_chain=4)
    qs = rng.normal(size=(2, 16)).astype(np.float32)
    d, lab = assert_matches_reference(cfg, state, qs, k=5, nprobe=4)
    assert np.isinf(d).all() and (lab == -1).all()


def test_cuda_route_refuses_cpu_tensors():
    q = torch.zeros((2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fused.sivf_fused_search_cuda(
            q, torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros((4, 32, 16)), torch.zeros((4, 32), dtype=torch.int32),
            torch.zeros((4, 32)), torch.zeros((4, 1), dtype=torch.int32), 5)


def eight_lane_dot(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``q [Q, D]`` . ``x [Q, C, D]`` in float32, one term at a time: term
    ``d`` into lane ``d mod 8`` of eight accumulators from ``+0.0``, then
    ``((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7))``."""
    a = [np.zeros(x.shape[:2], np.float32) for _ in range(8)]
    for d in range(q.shape[1]):
        a[d % 8] = a[d % 8] + q[:, d:d + 1] * x[:, :, d]
    return (((a[0] + a[1]) + (a[2] + a[3]))
            + ((a[4] + a[5]) + (a[6] + a[7])))


@pytest.mark.parametrize("dim", [1, 3, 4, 7, 128, 130, 301])
def test_dot_lanes_matches_eight_lane_emulation(rng, dim):
    """The tails (D mod 8 != 0, some of them past a whole float4) and D
    past the 128 columns the grouped route stages at a time."""
    q = rng.normal(size=(3, dim)).astype(np.float32)
    x = rng.normal(scale=3.0, size=(3, 5, dim)).astype(np.float32)
    got = ref.dot_lanes(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    assert np.array_equal(got, eight_lane_dot(q, x))
    qq = ref.dot_lanes(torch.from_numpy(q), torch.from_numpy(q)[:, None])
    assert np.array_equal(qq.numpy(), eight_lane_dot(q, q[:, None]))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_fold_distances_take_the_eight_lane_order(rng, metric):
    """Every distance the fold returns is ``-q.x`` (IP) or ``(||q||^2 -
    2 q.x) + ||x||^2`` (L2) of its row with both sums in the eight-lane
    order, bit for bit (D = 37: a tail of five columns)."""
    n_slabs, c, dim, k = 6, 32, 37, 40
    data = rng.normal(size=(n_slabs, c, dim)).astype(np.float32)
    norms = (data ** 2).sum(-1).astype(np.float32)
    ids = np.arange(n_slabs * c, dtype=np.int32).reshape(n_slabs, c)
    bitmap = np.full((n_slabs, c // 32), -1, np.int32)     # every slot live
    qs = rng.normal(size=(5, dim)).astype(np.float32)
    table = rng.integers(0, n_slabs, (5, 3)).astype(np.int32)
    d, lab = ops.sivf_fused_search(
        torch.from_numpy(qs), torch.from_numpy(table), torch.from_numpy(data),
        torch.from_numpy(ids), torch.from_numpy(norms),
        torch.from_numpy(bitmap), k, metric=metric)
    d, lab = d.numpy(), lab.numpy()
    assert (lab >= 0).all()
    rows = data.reshape(-1, dim)[lab]                       # [Q, k, D]
    dot = eight_lane_dot(qs, rows)
    if metric == "ip":
        want = -dot
    else:
        qq = eight_lane_dot(qs, qs[:, None])
        want = (qq - np.float32(2.0) * dot) + norms.reshape(-1)[lab]
    assert np.array_equal(d, want)


# ---------------------------------------------------------------------------
# The grouped kernel's order: plan, per-entry partials, merge
# ---------------------------------------------------------------------------

SPLIT_SLABS, SPLIT_C, SPLIT_D = 12, 32, 8
SPLIT_ATTRS = ("tenant", "ts")


def split_pool(seed=7):
    """Slab planes [12, 32, 8] with dead slots; slab 9's slot 3 holds slab
    4's slot 6 vector (a tie across slabs); slab 2 is empty; attributes
    tenant in [0, 5), ts in [0, 100)."""
    rng = np.random.default_rng(seed)
    s, c, d = SPLIT_SLABS, SPLIT_C, SPLIT_D
    data = rng.normal(size=(s, c, d)).astype(np.float32)
    data[9, 3] = data[4, 6]
    live = rng.random((s, c)) >= 0.25
    live[9, 3] = live[4, 6] = True
    live[2] = False
    live[5, 31] = True                                   # bit 31 of a word
    words = np.packbits(live.reshape(s, c // 32, 32)[..., ::-1],
                        axis=-1).view(">u4")[..., 0].astype(np.uint32)
    ids = rng.permutation(s * c).astype(np.int32).reshape(s, c)
    attrs = np.stack([rng.integers(0, 5, (s, c)), rng.integers(0, 100, (s, c))],
                     -1).astype(np.int32)
    return dict(data=data, ids=ids, norms=(data ** 2).sum(-1),
                bitmap=words, attrs=attrs)


def split_case(name, rng):
    """(queries [Q, 8], table [Q, 5], k, predicate) of one edge case."""
    q, t = 6, 5
    qs = rng.normal(size=(q, SPLIT_D)).astype(np.float32)
    table = np.stack([rng.permutation(SPLIT_SLABS)[:t] for _ in range(q)]
                     ).astype(np.int32)
    table[rng.random((q, t)) < 0.2] = -1
    k, pred = 10, None
    if name == "ties_across_slabs":
        table[1, :2] = (9, 4)            # the higher slab id at the lower t
        qs[1] = np.array(split_pool()["data"][4, 6]) + 0.01
    elif name == "same_slab_twice":
        table[3, :3] = (7, 2, 7)
    elif name == "one_slab_every_query":
        table[:, 2] = 5
    elif name == "all_pad_row":
        table[0] = -1
    elif name == "k_beyond_live":
        table[4] = -1
        table[4, 3] = 6
        k = 40                           # beyond slab 6's live rows
    elif name == "k_at_least_c":
        k = 48                           # k >= C = 32
    elif name == "zero_query":
        qs[2] = 0.0                      # IP: -0.0 everywhere; L2: qq = 0
    elif name == "filtered_1pct":
        pred = ("ts", 0, 1)
    elif name == "filtered_50pct":
        pred = ("ts", 0, 50)
    return qs, table, k, pred


SPLIT_CASES = ("ties_across_slabs", "same_slab_twice", "one_slab_every_query",
               "all_pad_row", "k_beyond_live", "k_at_least_c", "zero_query",
               "filtered_1pct", "filtered_50pct")


def test_plan_lists_every_live_entry_once(rng):
    pool = split_pool()
    for name in SPLIT_CASES:
        _, table, _, _ = split_case(name, rng)
        offsets, entries = ref.plan(torch.from_numpy(table), SPLIT_SLABS)
        flat = table.reshape(-1)
        assert offsets[0] == 0 and bool((offsets[1:] >= offsets[:-1]).all())
        assert int(offsets[-1]) == len(entries) == int((flat >= 0).sum())
        assert sorted(entries.tolist()) == np.nonzero(flat >= 0)[0].tolist()
        for s in range(SPLIT_SLABS):
            mine = entries[offsets[s]:offsets[s + 1]].numpy()
            assert (flat[mine] == s).all()
    assert pool["bitmap"].shape == (SPLIT_SLABS, 1)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_order_equals_fold_and_reference(rng, name, metric):
    """The plan / per-entry partial / merge order gives the running fold's
    bits (``==`` on distances and labels) and the JAX reference's scan
    (labels ``==``, distances allclose 1e-5: another summation order)."""
    from repro.core import filters as jflt
    from repro_torch.core import filters as flt
    pool = split_pool()
    qs, table, k, pred = split_case(name, rng)
    t = {n: torch.from_numpy(pool[n]) for n in ("data", "ids", "norms")}
    bitmap = torch.from_numpy(pool["bitmap"].view(np.int32))
    args = (torch.from_numpy(qs), torch.from_numpy(table), t["data"],
            t["ids"], t["norms"], bitmap, k)
    kw, words = {"metric": metric}, pool["bitmap"]
    if pred is not None:
        attr, lo, hi = pred
        cf = flt.compile_filter(flt.Range(attr, lo, hi), SPLIT_ATTRS)
        kw.update(attrs=torch.from_numpy(pool["attrs"]),
                  fstruct=cf.structure,
                  fconsts=torch.tensor(cf.consts, dtype=torch.int32))
        # the reference scan takes no predicate: fold the passing mask,
        # evaluated by the reference's own filters, into its bitmap
        ok = jflt.host_matches(jflt.Range(attr, lo, hi), SPLIT_ATTRS,
                               pool["attrs"].reshape(-1, 2)).reshape(
                                   SPLIT_SLABS, SPLIT_C)
        words = words & np.packbits(ok.reshape(SPLIT_SLABS, 1, 32)[..., ::-1],
                                    axis=-1).view(">u4")[..., 0]
    sd, sl = ref.sivf_fused_search_split_ref(*args, **kw)
    fd, fl = ref.sivf_fused_search_ref(*args, **kw)
    assert np.array_equal(sd.numpy().view(np.int32), fd.numpy().view(np.int32))
    assert torch.equal(sl, fl)
    rd, rl = jops.sivf_fused_search(
        jnp.asarray(qs), jnp.asarray(table), jnp.asarray(pool["data"]),
        jnp.asarray(pool["ids"]), jnp.asarray(pool["norms"]),
        jnp.asarray(words.astype(np.uint32)), k, metric=metric, impl="ref")
    assert np.array_equal(sl.numpy(), np.asarray(rl))
    np.testing.assert_allclose(sd.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)
    assert ((sl == -1) == torch.isinf(sd)).all()
    if name == "ties_across_slabs":      # the tie goes to the lower t
        j = int(np.nonzero(sl[1].numpy() == pool["ids"][9, 3])[0][0])
        assert sd[1, j] == sd[1, j + 1] and sl[1, j + 1] == pool["ids"][4, 6]
    if name == "all_pad_row":
        assert bool(torch.isinf(sd[0]).all() and (sl[0] == -1).all())
    if name == "zero_query" and metric == "ip":
        fin = torch.isfinite(sd[2])
        assert bool((sd[2][fin] == 0).all()) and \
            bool(torch.signbit(sd[2][fin]).all())
    if name == "filtered_1pct":
        assert int((sl >= 0).sum()) < 3 * 6


def test_launch_plan_reads_shapes_only():
    """The route and scratch come from shapes alone (meta tensors): the
    grouped route where its partials are strictly below the unfused pair's
    ``[Q, T*C]`` (k < C), and at any D; per_query where k >= C, within its
    48 KB of shared memory; the accepted shapes are the first port's or
    wider."""
    def meta(*shape):
        return torch.empty(shape, device="meta")

    q, t, s = 1024, 1024, 16384
    p = fused.launch_plan(meta(q, 128), meta(q, t), meta(s, 128, 128), 10)
    assert p["route"] == "grouped" == fused.route(q, t, 128, 10)
    assert p["scratch_bytes"] == fused.grouped_scratch_bytes(q, t, s, 10)
    assert q * t * 10 * 8 < p["scratch_bytes"] < q * t * 128 * 8
    for c, k in ((32, 32), (32, 64), (128, 1024)):
        p = fused.launch_plan(meta(8, 16), meta(8, 4), meta(6, c, 16), k)
        assert p == {"route": "per_query", "scratch_bytes": 0}
    wide = fused.launch_plan(meta(8, 20000), meta(8, 4), meta(6, 128, 20000),
                             10)                 # beyond the first port's
    assert wide["route"] == "grouped"
    for c, k, d, route in ((1056, 10, 16, None), (128, 0, 16, None),
                           (128, 1025, 16, None), (32, 32, 20000, None),
                           (32, 32, 16, "grouped"), (32, 10, 16, "other")):
        with pytest.raises(ValueError):
            fused.launch_plan(meta(8, d), meta(8, 4), meta(6, c, d), k, route)
    assert fused.launch_plan(meta(8, 16), meta(8, 4), meta(6, 64, 16), 10,
                             "per_query")["route"] == "per_query"


@pytest.mark.parametrize("k", [1, 3, 10])
def test_split_order_in_any_slab_order(rng, k):
    """The grouped order gives the fold's bits whatever order the slabs
    are scored in (the kernel's blocks take them in no fixed order),
    with the tie across slabs at k = 1 too."""
    from repro_torch.core import filters as flt
    pool = split_pool()
    t = {n: torch.from_numpy(pool[n]) for n in ("data", "ids", "norms")}
    bitmap = torch.from_numpy(pool["bitmap"].view(np.int32))
    orders = (None, list(range(SPLIT_SLABS))[::-1],
              rng.permutation(SPLIT_SLABS).tolist())
    for name in ("ties_across_slabs", "same_slab_twice",
                 "one_slab_every_query", "zero_query", "filtered_50pct"):
        qs, table, _, pred = split_case(name, rng)
        kw = {}
        if pred is not None:
            cf = flt.compile_filter(flt.Range(*pred), SPLIT_ATTRS)
            kw = dict(attrs=torch.from_numpy(pool["attrs"]),
                      fstruct=cf.structure,
                      fconsts=torch.tensor(cf.consts, dtype=torch.int32))
        args = (torch.from_numpy(qs), torch.from_numpy(table), t["data"],
                t["ids"], t["norms"], bitmap, k)
        for metric in ("l2", "ip"):
            fd, fl = ref.sivf_fused_search_ref(*args, metric=metric, **kw)
            for order in orders:
                sd, sl = ref.sivf_fused_search_split_ref(
                    *args, metric=metric, slab_order=order, **kw)
                assert np.array_equal(sd.numpy().view(np.int32),
                                      fd.numpy().view(np.int32)), (name, order)
                assert torch.equal(sl, fl), (name, metric, order)
