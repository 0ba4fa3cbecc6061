"""The port's unfused scan -> top-k pair against the JAX reference, on the CPU.

The same slab planes and tables (built by the reference: insert, then
delete every third row, as ``tests/test_kernels.py`` does, and carried
across with ``repro_torch.interop``) go through both packages. What each
comparison holds:

  * ``ops.sivf_scan`` against the reference's ``ops.sivf_scan``, its
    Pallas kernel in interpret mode and its plain version: labels and
    ``+inf`` positions ``==``, distances allclose(rtol=atol=1e-5) (the
    reference's einsum sums in another order; ``tests/parity.py``);
  * ``ops.topk`` against the reference's ``topk_ref`` (``lax.top_k``):
    distances bit for bit and labels ``==``, edge rows included. The
    reference's Pallas ``topk`` does not run in interpret mode with the
    installed jax (it calls ``pl.store``, which that version no longer
    has), so its plain version is the reference side;
  * the composed pipeline ``topk(sivf_scan(...))`` against the port's
    fused plain version bit for bit (the CUDA kernels equal these plain
    versions bit for bit on the card, so this is the identity the card
    checks between the pair and the fused kernel), and against the
    reference's ``sivf_fused_search(impl="ref")`` within 1e-5.

On CPU tensors the port runs its plain versions: no kernel launches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.kernels.sivf_scan import ops as jops
from repro.kernels.topk.ref import topk_ref as jtopk_ref
from repro_torch import interop
from repro_torch.kernels.sivf_scan import fused as fused_kernel
from repro_torch.kernels.sivf_scan import ops, ref
from repro_torch.kernels.sivf_scan import sivf_scan as scan_kernel
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk import topk as topk_kernel
from repro_torch.kernels.topk.ref import topk_ref, topk_warp_ref

from test_torch_state import jax_planes

# the reference's test_kernels.py sivf_scan shapes: (C, D, metric)
SHAPES = [(32, 16, "l2"), (64, 32, "l2"), (128, 128, "l2"), (32, 16, "ip")]
N_ROWS = 200

jtopk = jax.jit(jtopk_ref, static_argnums=2)


@pytest.fixture(scope="module", params=SHAPES,
                ids=[f"C{c}-D{d}-{m}" for c, d, m in SHAPES])
def scene(request):
    """One reference state per shape and its port twin, five queries and
    their slab table; the last query's row is all ``-1`` pads. The slab
    planes are rolled (the table renumbered to match) so that slab 0, the
    one a ``-1`` pad is clipped to before masking, is a live slab."""
    c, d, metric = request.param
    rng = np.random.default_rng(13)
    cfg = jcore.SIVFConfig(dim=d, n_lists=4, n_slabs=16, capacity=c,
                           n_max=2048, metric=metric, max_chain=8)
    cents = rng.normal(size=(4, d)).astype(np.float32)
    state = jcore.init_state(cfg, jnp.asarray(cents))
    vecs = rng.normal(size=(N_ROWS, d)).astype(np.float32)
    state = jcore.insert(cfg, state, jnp.asarray(vecs),
                         jnp.asarray(np.arange(N_ROWS), np.int32))
    state = jcore.delete(cfg, state, jnp.asarray(np.arange(0, N_ROWS, 3),
                                                 np.int32))
    qs = rng.normal(size=(5, d)).astype(np.float32)
    lists = jcore.probe(state.centroids, jnp.asarray(qs), 2, metric)
    table = np.array(jcore.gather_tables(cfg, state, lists))
    shift = int(table.max())
    table = np.where(table >= 0, (table - shift) % cfg.n_slabs, -1)
    table[-1] = -1
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    ts = interop.state_from_numpy(tcfg, jax_planes(state), device="cpu")
    planes = ("data", "ids", "norms", "bitmap")
    jargs = (jnp.asarray(qs), jnp.asarray(table)) + tuple(
        jnp.roll(getattr(state, n), -shift, axis=0) for n in planes)
    targs = (torch.from_numpy(qs), torch.from_numpy(table)) + tuple(
        torch.roll(getattr(ts, n), -shift, dims=0) for n in planes)
    assert bool(targs[-1][0].any())                # slab 0 holds live rows
    return dict(metric=metric, jargs=jargs, targs=targs, c=c,
                t=table.shape[1])


def assert_bits_equal(d, lab, rd, rl):
    """Distances bit for bit (int32 views) and labels ``==``."""
    d, lab, rd, rl = (np.asarray(a) for a in (d, lab, rd, rl))
    assert d.shape == rd.shape and lab.shape == rl.shape
    assert np.array_equal(d.view(np.int32), rd.view(np.int32))
    assert np.array_equal(lab, rl)


# ---------------------------------------------------------------------------
# (a) the unfused scan
# ---------------------------------------------------------------------------

def test_sivf_scan_matches_reference(scene):
    """Pallas (interpret) and the plain version of the reference against
    the port's scan: the same ``[Q, T*C]`` slots, pads and dead slots."""
    launches = scan_kernel.launches
    d, lab = ops.sivf_scan(*scene["targs"], metric=scene["metric"])
    assert scan_kernel.launches == launches           # CPU: plain version
    assert d.dtype == torch.float32 and lab.dtype == torch.int32
    assert tuple(d.shape) == (5, scene["t"] * scene["c"])
    d, lab = d.numpy(), lab.numpy()
    assert np.isinf(d[-1]).all() and (lab[-1] == -1).all()   # all-pad row
    assert (lab >= 0).any() and not np.isin(lab, np.arange(0, N_ROWS, 3)).any()
    for impl in ("pallas", "ref"):
        rd, rl = jops.sivf_scan(*scene["jargs"], metric=scene["metric"],
                                interpret=True, impl=impl)
        rd, rl = np.asarray(rd), np.asarray(rl)
        assert np.array_equal(lab, rl), impl
        assert np.array_equal(np.isinf(d), np.isinf(rd)), impl
        np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-5, err_msg=impl)


def test_scan_of_an_all_pad_table_is_empty():
    """A table of ``-1`` pads scores nothing and reads no slab."""
    ids = torch.arange(64, dtype=torch.int32).reshape(2, 32)
    d, lab = ops.sivf_scan(torch.ones((3, 4)), torch.full((3, 2), -1),
                           torch.ones((2, 32, 4)), ids, torch.ones((2, 32)),
                           torch.full((2, 1), -1, dtype=torch.int32))
    assert tuple(d.shape) == (3, 64) and torch.isinf(d).all()
    assert (lab == -1).all()


# ---------------------------------------------------------------------------
# (b) top-k
# ---------------------------------------------------------------------------

def edge_rows(rng, n):
    """Rows of width ``n`` (>= 8) whose labels are never ``-1``: all
    ``+inf``; three finite entries; all equal; ``-0.0`` among ``+0.0``
    with ties; ``-inf`` among finite and ``+inf`` entries."""
    d = np.full((5, n), np.inf, np.float32)
    d[1, [n - 1, 2, n // 2]] = (0.5, 0.25, 0.5)
    d[2] = 1.0
    d[3] = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), n)
    d[4] = rng.normal(size=n).astype(np.float32)
    d[4, rng.random(n) < 0.3] = np.inf
    d[4, [1, n - 2]] = -np.inf
    return d, rng.integers(0, 1000, (5, n)).astype(np.int32)


def random_rows(rng, q, n):
    """As ``test_kernels.py``: normal distances, 20 % ``+inf``."""
    d = rng.normal(size=(q, n)).astype(np.float32)
    d[rng.random(size=(q, n)) < 0.2] = np.inf
    return d, rng.integers(0, 1000, (q, n)).astype(np.int32)


TOPK_CASES = {
    "sweep-8x64-k5": (lambda r: random_rows(r, 8, 64), 5),
    "sweep-16x256-k17": (lambda r: random_rows(r, 16, 256), 17),
    "sweep-3x128-k1": (lambda r: random_rows(r, 3, 128), 1),
    "edge-L40-k1": (lambda r: edge_rows(r, 40), 1),
    "edge-L40-k10": (lambda r: edge_rows(r, 40), 10),
    "edge-L40-k=L": (lambda r: edge_rows(r, 40), 40),
    "L1-k1": (lambda r: random_rows(r, 3, 1), 1),
}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_topk_matches_reference(case):
    make, k = TOPK_CASES[case]
    d, lab = make(np.random.default_rng(5))
    launches = topk_kernel.launches
    td, tl = topk_ops.topk(torch.from_numpy(d), torch.from_numpy(lab), k)
    assert topk_kernel.launches == launches           # CPU: plain version
    rd, rl = jtopk(jnp.asarray(d), jnp.asarray(lab), k)
    assert_bits_equal(td.numpy(), tl.numpy(), rd, rl)
    if case.startswith("edge"):
        labels = tl.numpy()
        assert (labels != -1).all()         # a chosen +inf keeps its label
        assert labels[0].tolist() == lab[0, :k].tolist()   # first columns


def test_signed_zeros_follow_lax_top_k():
    """``lax.top_k`` on the CPU orders by IEEE total order: every ``-0.0``
    comes before every ``+0.0``, each group by column. The port does too
    (``torch.sort`` alone would treat the two as equal)."""
    d = np.array([[0.0, -0.0, 1.0, -0.0, 0.0]], np.float32)
    lab = np.arange(5, dtype=np.int32)[None]
    rd, rl = jtopk(jnp.asarray(d), jnp.asarray(lab), 5)
    assert np.asarray(rl).tolist() == [[1, 3, 0, 4, 2]]
    td, tl = topk_ref(torch.from_numpy(d), torch.from_numpy(lab), 5)
    assert_bits_equal(td.numpy(), tl.numpy(), rd, rl)


# ---------------------------------------------------------------------------
# (c) the composed pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [7, 150])
def test_unfused_pipeline_equals_fused_search(scene, k):
    """``topk(sivf_scan(...))`` equals the port's fused plain version bit
    for bit, labels included, and the reference's unfused oracle within
    1e-5. k=150 runs past the live rows: ``+inf`` / ``-1`` pads."""
    metric = scene["metric"]
    d, lab = topk_ops.topk(*ops.sivf_scan(*scene["targs"], metric=metric), k)
    fd, fl = ref.sivf_fused_search_ref(*scene["targs"], k, metric=metric)
    assert_bits_equal(d.numpy(), lab.numpy(), fd.numpy(), fl.numpy())
    rd, rl = jops.sivf_fused_search(*scene["jargs"], k, metric=metric,
                                    impl="ref")
    assert np.array_equal(lab.numpy(), np.asarray(rl))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)
    pad = np.isinf(d.numpy())
    assert (lab.numpy()[pad] == -1).all() and (lab.numpy()[~pad] >= 0).all()
    assert pad[-1].all()                                     # all-pad row


# ---------------------------------------------------------------------------
# (d) operands, and no launches on the CPU
# ---------------------------------------------------------------------------

def test_topk_refuses_bad_operands_and_cpu_calls_launch_nothing():
    d = torch.zeros((2, 6))
    lab = torch.zeros((2, 6), dtype=torch.int32)
    bad = [(d, lab, 7, "k=7"), (d, lab, 0, "k=0"),
           (d.double(), lab, 2, "float32"), (d, lab.long(), 2, "int32"),
           (d[:, ::2], lab[:, ::2], 2, "contiguous"),
           (d, lab[:, :5], 2, "shape"), (d[0], lab[0], 2, "shape")]
    for dd, ll, k, match in bad:
        with pytest.raises(ValueError, match=match):
            topk_ops.topk(dd, ll, k)
    # the CUDA wrappers take no CPU tensor: no quiet fallback
    with pytest.raises(ValueError, match="CUDA"):
        topk_kernel.topk_cuda(d, lab, 2)
    ids = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        scan_kernel.sivf_scan_cuda(torch.zeros((1, 4)),
                                   torch.zeros((1, 1), dtype=torch.int32),
                                   torch.zeros((1, 32, 4)), ids,
                                   torch.zeros((1, 32)), ids[:, :1])
    topk_ops.topk(d, lab, 6)
    ops.sivf_scan(torch.zeros((1, 4)), torch.zeros((1, 1), dtype=torch.int32),
                  torch.zeros((1, 32, 4)), ids, torch.zeros((1, 32)),
                  ids[:, :1])
    assert scan_kernel.launches == 0 and topk_kernel.launches == 0


# ---------------------------------------------------------------------------
# (e) the CUDA routes' plans, from shapes alone (meta tensors)
# ---------------------------------------------------------------------------

def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("q,t,c,d,route", [
    (1024, 1024, 128, 128, "grouped"), (16, 1024, 128, 128, "grouped"),
    (3, 5, 1024, 300, "grouped"), (1, 1, 32, 20000, "grouped"),
    (3, 5, 2048, 16, "per_entry"), (2 ** 16, 2 ** 15, 32, 16, "per_entry"),
    (2 ** 11, 2 ** 20 - 1, 1024, 128, "grouped")])
def test_scan_route_and_scratch_follow_from_shapes(q, t, c, d, route):
    """``sivf_scan.route`` and the grouped route's scratch (the plan of
    ``csrc/slab_plan.cuh``: 16-byte chunk records, a count and an offset a
    slab, 3 counters, the entries and ``||q||^2``) read shapes only; the
    per_entry route, taken past the grouped route's limits (C > 1024, Q*T
    beyond int32), has no scratch. Kernel 1's scratch is the same plan
    plus its partials."""
    n_slabs = 16384
    plan = scan_kernel.launch_plan(meta(q, d), meta(q, t, dtype=torch.int32),
                                   meta(n_slabs, c, d))
    assert plan["route"] == route == scan_kernel.route(q, t, c)
    n = q * t
    chunks = -(-n // 16) + min(n_slabs, n)
    want = 4 * (4 * chunks + 2 * n_slabs + 3 + n + q)
    assert fused_kernel.plan_bytes(q, t, n_slabs) == want
    assert plan["scratch_bytes"] == (want if route == "grouped" else 0)
    assert fused_kernel.grouped_scratch_bytes(q, t, n_slabs, 10) \
        == want + 8 * n * 10


@pytest.mark.parametrize("q,n,k,route", [
    (1024, 131072, 10, "warp"), (256, 131072, 10, "warp"),
    (64, 131072, 10, "warp"), (16, 131072, 10, "warp"),
    (1, 40, 10, "warp"), (16, 131072, 33, "block"),
    (1024, 131072, 32, "warp"), (4, 10 ** 6, 5, "warp")])
def test_topk_route_and_scratch_follow_from_shapes(q, n, k, route):
    """``topk.route`` / ``launch_plan``: ``warp`` up to k = 32, ``block``
    past it, whatever the rows' count and length; neither has scratch."""
    plan = topk_kernel.launch_plan(meta(q, n), k)
    assert plan == {"route": route}
    assert topk_kernel.route(q, n, k) == route


@pytest.mark.parametrize("call,match", [
    (lambda: scan_kernel.launch_plan(meta(3, 20000),
                                     meta(3, 5, dtype=torch.int32),
                                     meta(8, 2048, 20000)), "shared memory"),
    (lambda: scan_kernel.launch_plan(meta(3, 16), meta(3, 5, dtype=torch.int32),
                                     meta(8, 2048, 16), "grouped"), "C <="),
    (lambda: scan_kernel.launch_plan(meta(3, 16), meta(3, 5, dtype=torch.int32),
                                     meta(8, 32, 16), "fused"), "unknown"),
    (lambda: topk_kernel.launch_plan(meta(4, 100), 33, "warp"), "k <= 32"),
    (lambda: topk_kernel.launch_plan(meta(4, 100), 10, "split"), "unknown"),
    (lambda: topk_kernel.launch_plan(meta(4, 20), 21, "warp"), "k=21"),
    (lambda: topk_kernel.launch_plan(meta(4, 100), 101), "k=101"),
    (lambda: topk_kernel.launch_plan(meta(4, 2 ** 31), 10), "31 bits"),
    (lambda: topk_kernel.launch_plan(meta(4, 100), 10, "rows"), "unknown")])
def test_shapes_no_route_takes_raise(call, match):
    """A shape that no route takes (or that the named route does not
    take) raises ``ValueError``: nothing falls back to a plain version."""
    with pytest.raises(ValueError, match=match):
        call()


def falling_rows(rng, n):
    """Rows whose distances mostly fall along the row, with ties and
    signed zeros: nearly every key enters a warp's list, so its
    threshold moves at every merge."""
    d = np.linspace(4, -4, n, dtype=np.float32)[None].repeat(3, 0)
    d[1] = np.round(d[1])                        # runs of equal distances
    d[2, rng.random(n) < 0.5] = 0.0
    d[2, rng.random(n) < 0.5] = -0.0
    return d, rng.integers(0, 1000, (3, n)).astype(np.int32)


def late_rows(rng, n=4096):
    """Rows whose tenth smallest distance comes last, in warp 0's second
    step (column 3080), after the nine smallest (columns 0-8, in its
    first float4s) and a full buffer of 49s (its float4 256-287) have
    merged into its list: it enters only if that warp's threshold is its
    list's tenth key, not a lower one. Row 1's tenth ties the ninth
    (distance 8) at a higher column."""
    d = np.full((2, n), 100.0, np.float32)
    d[:, :132] = 50.0
    d[:, 1024:1156] = 49.0
    d[:, :9] = np.arange(9)
    d[0, 3080], d[1, 3080] = 9.5, 8.0
    return d, rng.integers(0, 1000, (2, n)).astype(np.int32)


WARP_CASES = {name: TOPK_CASES[name] for name in (
    "edge-L40-k10", "sweep-16x256-k17", "L1-k1")}
WARP_CASES["falling-3x9001-k32"] = (lambda r: falling_rows(r, 9001), 32)
WARP_CASES["sweep-2x5003-k10"] = (lambda r: random_rows(r, 2, 5003), 10)
WARP_CASES["late-2x4096-k10"] = (late_rows, 10)


@pytest.mark.parametrize("case", list(WARP_CASES))
@pytest.mark.parametrize("misalign", [0, 1, 2, 3])
def test_topk_warp_order_equals_reference(case, misalign):
    """The warp route's steps in plain Python (``topk_warp_ref``: a scalar
    head and tail where a row's start is ``misalign`` floats past a
    16-byte boundary, float4 screened as a whole and then key by key,
    32-key merges that move each warp's threshold) against the
    reference's ``topk_ref``, bit for bit, labels included."""
    make, k = WARP_CASES[case]
    d, lab = make(np.random.default_rng(11))
    td, tl = topk_warp_ref(torch.from_numpy(d), torch.from_numpy(lab), k,
                           misalign)
    rd, rl = jtopk(jnp.asarray(d), jnp.asarray(lab), k)
    assert_bits_equal(td.numpy(), tl.numpy(), rd, rl)


ROUTE_COUNTS = {scan_kernel: ("launches", "launches_grouped",
                              "launches_per_entry"),
                topk_kernel: ("launches", "launches_warp", "launches_block")}


@pytest.mark.parametrize("q", [1, 16, 1024])
def test_cpu_calls_launch_nothing_on_any_route(q):
    """On CPU tensors the ops run the plain versions: no count of either
    wrapper moves, whatever route the shapes would take on the card."""
    before = {(m, a): getattr(m, a) for m, names in ROUTE_COUNTS.items()
              for a in names}
    ids = torch.zeros((2, 32), dtype=torch.int32)
    d, lab = ops.sivf_scan(torch.zeros((q, 4)),
                           torch.zeros((q, 2), dtype=torch.int32),
                           torch.zeros((2, 32, 4)), ids, torch.zeros((2, 32)),
                           torch.full((2, 1), -1, dtype=torch.int32))
    topk_ops.topk(d, lab, 10)
    after = {(m, a): getattr(m, a) for m, names in ROUTE_COUNTS.items()
             for a in names}
    assert after == before
