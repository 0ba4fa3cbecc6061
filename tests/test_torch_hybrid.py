"""The port's hybrid (Jamba) serving slice against the JAX reference, on
the CPU.

``jamba-v0.1-52b.reduced()`` (float32: one period of 8 layers, d_model
64; attention at position 4, MoE with 4 experts top-2 at 1, 3, 5 and 7,
Mamba with d_inner 128 and d_state 4 elsewhere). Parameters are made with
numpy from a seed (``test_torch_rwkv.numpy_tree``) and carried across by
``interop.params_from_numpy``. What each comparison holds, and why:

  * the plain selective scan ``mamba_scan_ref`` against the reference's
    oracle ``kernels/mamba_scan/ref.py::mamba_scan_ref`` (``lax.scan``
    over all of T, zero state) at ragged T = 1, 7, 517, and against its
    ``_ssm_sequential`` (the ``impl="xla"`` path, chunk 64) from a
    non-zero state: ``y`` and the final state within 1e-5 relative to
    their RMS (float32 sums of n terms in another order);
  * a split sequence, (0..t) then (t..T) from the carried state, equals
    the whole bit for bit;
  * ``_causal_conv``, ``mamba_block`` and ``apply_moe`` (the top-k tie
    order, and experts over capacity) and ``forward(collect_cache=True)``
    (logits, aux loss and every cache) against the reference's functions
    with ``impl="xla"``: within 1e-5;
  * ``PagedLMEngine`` against the reference's
    ``PagedLMEngine(attn_impl="pallas_interpret")`` through admit / step /
    slide / evict / re-admit (``test_torch_rwkv.serve_both``): page state
    ``==`` after every operation, logits and recurrent states within 1e-4
    (float32 through eight layers and eight steps; no routing decision of
    this traffic lies within 1e-4 of a tie, so both engines route alike).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jscan_ref
from repro.models import mamba as jmamba
from repro.models import mlp as jmlp
from repro.models import model as JM
from repro.sharding import rules as jrules
from repro.sharding.axes import strip
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.kernels.mamba_scan import mamba_scan as kernel
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import (
    mamba_scan_ref,
    mamba_scan_split_ref,
)
from repro_torch.models import mamba, mlp
from repro_torch.models import model as M
from repro_torch.serve.paged_lm import PagedLMEngine
from repro_torch.sharding import rules
from test_torch_rwkv import (
    ENGINE,
    check_served,
    close,
    close_rms,
    jtree,
    numpy_tree,
    serve_both,
    t,
)

JCFG = JARCHS["jamba-v0.1-52b"].reduced()
CFG = get_arch("jamba-v0.1-52b").reduced()
JPLAN, PLAN = jrules.unpadded_plan(JCFG), rules.unpadded_plan(CFG)
MAMBA_POS = [pos for pos in range(8) if not CFG.is_attn_layer(pos)]


def scan_inputs(rng, b, steps, di, n, state: bool):
    f = np.float32
    u = rng.normal(size=(b, steps, di)).astype(f)
    delta = np.log1p(np.exp(rng.normal(-1, 1, size=(b, steps, di)))
                     ).astype(f)
    a = -rng.uniform(0.5, 16, size=(di, n)).astype(f)
    bb, cc = (rng.normal(size=(b, steps, n)).astype(f) for _ in "bc")
    d = rng.normal(size=di).astype(f)
    h0 = rng.normal(size=(b, di, n)).astype(f) if state else \
        np.zeros((b, di, n), f)
    return u, delta, a, bb, cc, d, h0


jssm_sequential = jax.jit(jmamba._ssm_sequential, static_argnums=7)
jcausal_conv = jax.jit(jmamba._causal_conv)
jmamba_block = jax.jit(jmamba.mamba_block, static_argnums=(1, 2),
                       static_argnames=("impl", "chunk"))
japply_moe = jax.jit(jmlp.apply_moe, static_argnums=(1, 2))
jforward = jax.jit(JM.forward, static_argnums=(1, 2),
                   static_argnames=("collect_cache",))


# ---------------------------------------------------------------------------
# the plain selective scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 7, 517])
def test_scan_plain_matches_the_reference_oracle_at_ragged_lengths(steps):
    rng = np.random.default_rng(steps)
    args = scan_inputs(rng, 2, steps, 40, 4, state=False)
    y, h = mamba_scan_ref(*(t(a) for a in args[:6]))
    assert y.shape == (2, steps, 40) and h.shape == (2, 40, 4)
    close_rms(y, jscan_ref(*(jnp.asarray(a) for a in args[:6])))


@pytest.mark.parametrize("steps,di,n", [(64, 40, 4), (128, 24, 16),
                                        (5, 100, 4)])
def test_scan_plain_matches_the_sequential_path_from_a_state(steps, di, n):
    """Against ``_ssm_sequential`` (chunk 64) from a non-zero state: the
    output and the final state."""
    rng = np.random.default_rng(200 + steps)
    args = scan_inputs(rng, 2, steps, di, n, state=True)
    jy, jh = jssm_sequential(*(jnp.asarray(a) for a in args), 64)
    y, h = mamba_scan_ref(*(t(a) for a in args))
    close_rms(y, jy, what="y")
    close_rms(h, jh, what="final state")


def test_scan_split_sequence_equals_the_whole():
    rng = np.random.default_rng(7)
    u, delta, a, b, c, d, h0 = (t(x) for x in scan_inputs(
        rng, 2, 29, 24, 4, state=True))
    y, h = ops.mamba_scan(u, delta, a, b, c, d, h0)
    for cut in (1, 13, 28):
        y1, h1 = ops.mamba_scan(u[:, :cut], delta[:, :cut], a, b[:, :cut],
                                c[:, :cut], d, h0)
        y2, h2 = ops.mamba_scan(u[:, cut:], delta[:, cut:], a, b[:, cut:],
                                c[:, cut:], d, h1)
        assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    assert kernel.launches == 0           # the CPU takes the plain version


def test_scan_operands_are_checked():
    rng = np.random.default_rng(8)
    u, delta, a, b, c, d, h0 = (t(x) for x in scan_inputs(
        rng, 1, 3, 24, 4, state=True))
    with pytest.raises(ValueError, match="float32"):
        mamba_scan_ref(u, delta.double(), a, b, c, d, h0)
    with pytest.raises(ValueError, match="h0"):
        mamba_scan_ref(u, delta, a, b, c, d, h0[:, :3])
    with pytest.raises(ValueError, match="T>=1"):
        mamba_scan_ref(u[:, :0], delta[:, :0], a, b[:, :0], c[:, :0], d, h0)
    with pytest.raises(ValueError, match="CUDA"):   # the real wrapper
        kernel.mamba_scan_cuda(u, delta, a, b, c, d, h0)


# ---------------------------------------------------------------------------
# the CUDA kernel's own arithmetic and launch plan, in plain PyTorch
# ---------------------------------------------------------------------------

SPLIT_CASES = [  # steps, di, n: ragged T about the 32-step chunk, di off
    (1, 40, 4),                    # the block's channel group (128 / lanes)
    (31, 100, 16),
    (32, 76, 64),
    (33, 100, 12),
    (33, 36, 3),
    (517, 40, 16),
]


def meta_scan(bsz, steps, di, n):
    return [torch.empty(shape, device="meta") for shape in (
        (bsz, steps, di), (bsz, steps, di), (di, n), (bsz, steps, n),
        (bsz, steps, n), (di,), (bsz, di, n))]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "T{}-di{}-n{}".format(*c))
def test_scan_split_order_matches_the_oracle_and_the_plain_version(case):
    """``mamba_scan_split_ref`` (the kernel's lanes of ``elems`` state
    elements, its channel groups, y summed lane by lane) against the
    reference's oracle from a zero state and against ``mamba_scan_ref``
    from a non-zero one; the state itself rounds as the plain version's
    does, so it is held to it bit for bit."""
    steps, di, n = case
    plan = kernel.launch_plan(*meta_scan(2, steps, di, n))
    assert di % plan["channels"]                    # a partial group
    kw = dict(elems=plan["elems"], channels=plan["channels"])
    rng = np.random.default_rng(400 + steps + di)
    args = scan_inputs(rng, 2, steps, di, n, state=False)
    y, _ = mamba_scan_split_ref(*(t(a) for a in args[:6]), **kw)
    close_rms(y, jscan_ref(*(jnp.asarray(a) for a in args[:6])), what="y")
    args = [t(a) for a in scan_inputs(rng, 2, steps, di, n, state=True)]
    want = mamba_scan_ref(*args)
    got = mamba_scan_split_ref(*args, **kw)
    close_rms(got[0], want[0], what="y from a state")
    assert torch.equal(got[1], want[1])


def test_scan_launch_plan_reads_shapes_only():
    """The launch plan is a function of shapes: meta tensors, which hold
    no values, will do."""
    admit = kernel.launch_plan(*meta_scan(1, 2048, 8192, 16))   # Jamba
    assert (admit["elems"], admit["lanes"], admit["channels"]) == (4, 4, 32)
    assert admit["grid"] == (256, 1) and admit["chunk"] == 32
    assert admit["smem_bytes"] == kernel.smem_bytes(128, 4, 4, 32)
    assert admit["vec"]
    decode = kernel.launch_plan(*meta_scan(8, 1, 8192, 16))
    assert decode["grid"] == (256, 8) and decode["chunk"] == 1
    for n, elems, lanes in ((1, 1, 1), (2, 2, 1), (3, 4, 1), (12, 4, 4),
                            (33, 4, 16), (64, 4, 16)):
        plan = kernel.launch_plan(*meta_scan(2, 7, 72, n))
        assert (plan["elems"], plan["lanes"], plan["chunk"]) == (
            elems, lanes, 8)
        assert plan["channels"] * lanes == kernel.THREADS
    assert not kernel.launch_plan(*meta_scan(2, 7, 70, 16))["vec"]
    with pytest.raises(ValueError, match="n=65"):
        kernel.launch_plan(*meta_scan(1, 4, 8, 65))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    return numpy_tree(JCFG, JPLAN, 0)


@pytest.fixture(scope="module")
def port_params(tree):
    return interop.params_from_numpy(CFG, tree, device="cpu")


@pytest.mark.parametrize("seq", [1, 6])
def test_causal_conv_carries_its_state(seq):
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(2, seq, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32)
    jy, js = jcausal_conv(*(jnp.asarray(a) for a in (x, w, b, st)))
    y, s = mamba._causal_conv(t(x), t(w), t(b), t(st))
    close(y, jy)
    close(s, js)
    y0, s0 = mamba._causal_conv(t(x), t(w), t(b))       # zero state
    close(y0, jcausal_conv(*(jnp.asarray(a) for a in (
        x, w, b, np.zeros_like(st))))[0])


@pytest.mark.parametrize("seq,state", [(1, True), (13, False), (13, True)])
def test_mamba_block_matches_the_reference(tree, port_params, seq, state):
    rng = np.random.default_rng(20 + seq)
    p = {k: a[0] for k, a in tree["layers"][2]["mamba"].items()}
    x = rng.normal(size=(2, seq, CFG.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, 3, CFG.mamba_d_inner)).astype(
        np.float32) * state
    h0 = rng.normal(size=(2, CFG.mamba_d_inner, CFG.mamba_d_state)).astype(
        np.float32) * state
    jo, (jc, jh) = jmamba_block(jtree(p), JCFG, JPLAN, jnp.asarray(x),
                                (jnp.asarray(conv), jnp.asarray(h0)),
                                impl="xla", chunk=max(seq, 1))
    for impl in ("kernel", "ref"):
        o, (c, h) = mamba.mamba_block(port_params.layers[2]["mamba"], CFG,
                                      PLAN, t(x), (t(conv), t(h0)),
                                      impl=impl)
        close(o, jo, what="out")
        close(c, jc, what="conv state")
        close_rms(h, jh, what="h")


def moe_inputs(tree, kind: str):
    """Layer 1's MoE parameters with the router as given ("random"), all
    zero (every probability ties: the top 2 are experts 0 and 1), or
    biased so that every token prefers expert 2 (24 tokens over 16
    slots)."""
    p = {k: np.array(a[0]) for k, a in tree["layers"][1]["moe"].items()}
    rng = np.random.default_rng(30)
    x = rng.normal(size=(2, 12, CFG.d_model)).astype(np.float32)
    if kind == "ties":
        p["router"][:] = 0
    elif kind == "overflow":
        p["router"][:, 2] = 0.0
        x[..., :] = np.abs(x)
        p["router"][:, 2] = 1.0 / CFG.d_model ** 0.5 * 4
    return p, x


@pytest.mark.parametrize("kind", ["random", "ties", "overflow"])
def test_apply_moe_matches_the_reference(tree, kind):
    p, x = moe_inputs(tree, kind)
    jo, jaux = japply_moe(jtree(p), JCFG, JPLAN, jnp.asarray(x))
    tp = {k: torch.nn.Parameter(t(a), requires_grad=False)
          for k, a in p.items()}
    o, aux = mlp.apply_moe(tp, CFG, PLAN, t(x))
    close(o, jo)
    close(aux, jaux)
    _, topw, tope = mlp.moe_route(tp, CFG, PLAN, t(x).reshape(-1, 64))
    jw, je = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x.reshape(-1, 64) @ p["router"]), -1), CFG.moe_top_k)
    np.testing.assert_array_equal(tope.numpy(), np.asarray(je))
    cap = mlp.capacity(CFG, 24)
    assert cap == 16
    load = np.bincount(tope.numpy().ravel(), minlength=CFG.n_experts)
    if kind == "ties":
        assert (tope.numpy() == [0, 1]).all()
    if kind in ("ties", "overflow"):
        assert load.max() > cap          # experts over capacity drop tokens


def test_forward_logits_and_caches_match_the_reference(tree, port_params):
    toks = np.random.default_rng(5).integers(1, CFG.vocab_size,
                                             (2, 21)).astype(np.int32)
    jl, jaux, jc = jforward(jtree(tree), JCFG, JPLAN,
                            {"tokens": jnp.asarray(toks)}, collect_cache=True)
    logits, aux, caches = M.forward(port_params, CFG, PLAN,
                                    {"tokens": t(toks)}, collect_cache=True)
    close(logits, jl)
    close(aux, jaux)
    assert M.kinds_present(CFG) == ["attn", "mamba"] and len(caches) == 2
    for got, want in zip(caches[0], jc[4]):       # [1, B, S, Hkv, dh]
        assert got.shape == want.shape
        close(got, want)
    for j, pos in enumerate(MAMBA_POS):           # [7, B, ...] vs [1, B, ..]
        close(caches[1][0][j], jc[pos][0][0], what=f"conv {pos}")
        close(caches[1][1][j], jc[pos][1][0], what=f"h {pos}")
    assert caches[1][1].shape == (7, 2, CFG.mamba_d_inner,
                                  CFG.mamba_d_state)


def test_init_params_matches_the_reference_tree_and_keeps_float32_leaves():
    small = dataclasses.replace(CFG, dtype="bfloat16")
    a = M.init_params(small, PLAN, seed=3, device="cpu")
    assert M.layer_kinds(small) == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [set(lp.keys()) for lp in a.layers][:2] == [
        {"ln1", "mamba", "ln2", "mlp"}, {"ln1", "mamba", "ln2", "moe"}]
    mp = a.layers[0]["mamba"]
    assert {k for k, v in mp.items() if v.dtype == torch.float32} == \
        set(mamba.FLOAT32_LEAVES)
    assert a.layers[1]["moe"]["w_gate"].dtype == torch.bfloat16
    shapes = jax.tree.map(lambda x: x.shape,
                          interop.params_to_numpy(small, a))
    ref = jax.tree.map(lambda x: x.shape, strip(jax.eval_shape(
        lambda k: JM.init_params(JCFG, JPLAN, k), jax.random.key(0))))
    assert shapes == ref
    with pytest.raises(ValueError, match="period"):
        M.init_params(dataclasses.replace(CFG, n_layers=12), PLAN,
                      device="cpu")


def test_params_and_states_cross_both_ways_unchanged(tree, port_params):
    back = interop.params_to_numpy(CFG, port_params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(
        lambda a, b: a.dtype == b.dtype and bool((a == b).all()), tree,
        back)))
    bf = interop.params_from_numpy(CFG, tree, device="cpu",
                                   dtype=torch.bfloat16)
    assert bf.layers[0]["mamba"]["a_log"].dtype == torch.float32
    assert bf.layers[1]["moe"]["router"].dtype == torch.bfloat16
    eng = PagedLMEngine(CFG, PLAN, port_params, device="cpu", **ENGINE)
    assert eng.k_pool.shape[0] == 1 and set(eng.state) == {"mamba"}
    rng = np.random.default_rng(9)
    for pool in eng.state["mamba"]:
        pool.copy_(t(rng.normal(size=pool.shape).astype(np.float32)))
    entries = interop.recurrent_state_to_numpy(CFG, eng.state)
    assert entries[4] is None
    assert [tuple(a.shape) for a in entries[0]] == [(1, 3, 3, 128),
                                                    (1, 3, 128, 4)]
    again = interop.recurrent_state_from_numpy(CFG, entries, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again["mamba"],
                                                  eng.state["mamba"]))


# ---------------------------------------------------------------------------
# the slice as a whole: the engine against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tree, port_params):
    kernel.launches = 0
    return serve_both(JCFG, JPLAN, CFG, PLAN, tree, port_params, seed=16)


def test_engine_matches_the_reference_after_each_operation(served):
    check_served(served, CFG)
    assert kernel.launches == 0                       # CPU: plain version


def test_engine_page_state_frees_on_slide_and_evict(served):
    free = [int(e["tpages"]["free_top"]) for e in served]
    assert free[7] > free[6] and free[8] > free[7]
