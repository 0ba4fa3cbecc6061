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
from repro_torch.kernels.sivf_scan import ops, ref
from repro_torch.kernels.sivf_scan import sivf_scan as scan_kernel
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk import topk as topk_kernel
from repro_torch.kernels.topk.ref import topk_ref

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
