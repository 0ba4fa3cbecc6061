"""The port's attention kernels' plain versions and attention modules
against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and go through ``repro`` and
``repro_torch`` (CPU tensors, so the port's ops take their plain
versions). What each comparison holds, within 2e-4 in float32 (the
reference's kernel tests' tolerance; the sums run in another order) and
2e-2 in bfloat16:

  * ``paged_attention`` against the reference's Pallas kernel in
    interpret mode and its ``paged_attention_ref``, over edge sets: page
    8/16/32, g = 1, 2, 4, dk = dv and dk != dv, ``-1`` table pads, an
    all-pad row (output 0), ``starts`` mid-page, a length at a page end,
    one live token, B = 1 and B = 8;
  * ``flash_attention`` against the reference's Pallas kernel in
    interpret mode where its blocks divide the lengths, and against
    ``mha_ref`` at ragged lengths (the CUDA kernel masks its ragged
    tiles; the Pallas wrapper asserts divisibility);
  * the CUDA kernels' own arithmetic, in plain PyTorch: the paged
    kernel's split over the window and merge
    (``ref.paged_attention_split_ref``) against the reference's Pallas
    kernel and ``paged_attention_ref`` within 1e-5, and P carried in bf16
    (``ref.mha_p_bf16_ref``: one term as SDPA, two as the flash
    tensor-core route) against ``mha_ref`` within 2e-2; the paged launch
    plan and the flash route as functions of shapes and dtype alone;
  * ``gqa_full`` against the reference's ``impl="pallas_interpret"`` and
    ``impl="xla"``, and ``gqa_decode_paged`` against the reference's
    ``impl="pallas_interpret"``, pages included, on parameters carried
    across by ``interop.params_from_numpy`` (within 1e-5).

On CPU tensors the port launches no kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import mha_ref
from repro.kernels.paged_attention.ops import paged_attention as jpaged
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.models import attention as jattn
from repro.sharding.rules import unpadded_plan as junpadded_plan
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import flash_attention as fkernel
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.paged_attention import paged_attention as pkernel
from repro_torch.kernels.paged_attention import ref as pref
from repro_torch.models import attention as attn
from repro_torch.sharding.rules import unpadded_plan

from test_torch_lm import numpy_tree

F32_TOL, BF16_TOL, MODULE_TOL = 2e-4, 2e-2, 1e-5

# the reference's plain versions, jitted: one compile per shape instead of
# one per operation
jmha_ref = jax.jit(mha_ref, static_argnames=("causal", "scale"))
jpaged_ref = jax.jit(paged_attention_ref, static_argnames=("scale",))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# (a) paged decode attention
# ---------------------------------------------------------------------------

def paged_case(seed, b, page, maxp, hq, hkv, dk, dv, n_pages=40):
    """Random q and pages; tables, lengths and starts with the edge cases
    folded in (row 0 all pads when B > 1, then a one-token window, a
    window ending at a page end, starts mid-page, pads inside a row)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, dk)).astype(np.float32)
    kp = rng.normal(size=(n_pages, page, hkv, dk)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, hkv, dv)).astype(np.float32)
    tables = np.full((b, maxp), -1, np.int32)
    lengths = np.zeros((b,), np.int32)
    starts = np.zeros((b,), np.int32)
    perm = rng.permutation(n_pages)
    c = 0
    for i in range(b):
        n = int(rng.integers(1, maxp + 1))
        tables[i, :n] = perm[c:c + n]
        c += n
        lengths[i] = int(rng.integers(1, n * page + 1))
        starts[i] = int(rng.integers(0, lengths[i]))
        kind = i % 5 if b > 1 else 3
        if kind == 0:                      # all pads: output 0
            tables[i] = -1
        elif kind == 1:                    # one live token
            starts[i] = lengths[i] - 1
        elif kind == 2:                    # length exactly at a page end
            lengths[i] = n * page
            starts[i] = page // 2
        elif kind == 3 and n > 1:          # a -1 pad inside the window
            tables[i, 0] = -1
            starts[i] = 0
    return q, kp, vp, tables, lengths, starts


PAGED_CASES = [  # b, page, maxp, hq, hkv, dk, dv
    (8, 16, 5, 8, 2, 32, 32),      # g = 4
    (8, 8, 6, 4, 2, 16, 24),       # g = 2, dk != dv
    (1, 32, 3, 2, 2, 64, 64),      # g = 1, B = 1
]


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: "b{}-page{}-g{}-dk{}-dv{}".format(
                             c[0], c[1], c[3] // c[4], c[5], c[6]))
def test_paged_attention_matches_the_pallas_kernel(case):
    q, kp, vp, tables, lengths, starts = paged_case(7, *case)
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, tables, lengths))
    want_kernel = jpaged(*jargs, starts=jnp.asarray(starts), interpret=True)
    want_ref = jpaged_ref(*jargs, starts=jnp.asarray(starts))
    got = pops.paged_attention(*(t(a) for a in (q, kp, vp, tables, lengths,
                                                starts)))
    assert got.shape == (case[0], case[3], case[6])
    close(got, want_kernel, F32_TOL)
    close(got, want_ref, F32_TOL)
    if case[0] > 1:
        assert (got[0] == 0).all()              # the all-pad row


def test_paged_attention_bf16_and_scale():
    q, kp, vp, tables, lengths, starts = paged_case(3, *PAGED_CASES[0])
    args = [t(a) for a in (q, kp, vp, tables, lengths, starts)]
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    got = pops.paged_attention(*args, scale=0.3)
    assert got.dtype == torch.bfloat16
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    jargs[:3] = [a.astype(jnp.bfloat16) for a in jargs[:3]]
    want = jpaged_ref(*jargs, starts=jnp.asarray(starts), scale=0.3)
    close(got, want.astype(jnp.float32), BF16_TOL)


# ---------------------------------------------------------------------------
# (a) flash attention
# ---------------------------------------------------------------------------

def qkv(seed, b, hq, hkv, sq, sk, dh, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, dh)).astype(dtype),
            rng.normal(size=(b, hkv, sk, dh)).astype(dtype),
            rng.normal(size=(b, hkv, sk, dh)).astype(dtype))


FLASH_BLOCKED = [  # sq, sk, hq, hkv, dh, causal, block
    (64, 64, 4, 1, 32, True, 32),      # g = 4, Sq = Sk
    (32, 64, 4, 4, 16, True, 32),      # g = 1, Sq < Sk (chunked prefill)
    (32, 96, 2, 1, 64, False, 32),     # non-causal, Sq < Sk
]


@pytest.mark.parametrize("sq,sk,hq,hkv,dh,causal,block", FLASH_BLOCKED)
def test_flash_attention_matches_the_pallas_kernel(sq, sk, hq, hkv, dh,
                                                   causal, block):
    q, k, v = qkv(11, 2, hq, hkv, sq, sk, dh)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, interpret=True, block_q=block,
                  block_k=block)
    got = fops.flash_attention(t(q), t(k), t(v), causal=causal)
    close(got, want, F32_TOL)
    close(got, jmha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal), F32_TOL)


@pytest.mark.parametrize("sq,sk,causal", [(17, 17, True), (17, 129, True),
                                          (129, 129, False), (1, 100, True)])
def test_flash_attention_ragged_lengths_match_mha_ref(sq, sk, causal):
    q, k, v = qkv(5, 1, 4, 1, sq, sk, 16)
    got = fops.flash_attention(t(q), t(k), t(v), causal=causal)
    want = jmha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal)
    close(got, want, F32_TOL)


def test_flash_attention_bf16():
    q, k, v = qkv(2, 2, 4, 2, 33, 33, 32)
    args = [t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = fops.flash_attention(*args, causal=True)
    assert got.dtype == torch.bfloat16
    want = jmha_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    causal=True)
    close(got, want.astype(jnp.float32), BF16_TOL)


def test_cpu_calls_launch_nothing_and_wrappers_refuse_cpu_tensors():
    fkernel.launches = pkernel.launches = 0
    q, k, v = (t(a) for a in qkv(1, 1, 2, 1, 4, 4, 8))
    fops.flash_attention(q, k, v)
    pq, kp, vp, tables, lengths, starts = (
        t(a) for a in paged_case(1, *PAGED_CASES[0]))
    pops.paged_attention(pq, kp, vp, tables, lengths, starts)
    assert fkernel.launches == 0 and pkernel.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        fkernel.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.paged_attention_cuda(pq, kp, vp, tables, lengths, starts)


def test_plain_versions_refuse_bad_operands():
    q, k, v = (t(a) for a in qkv(1, 1, 4, 2, 4, 4, 8))
    for args, match in (((q, k.double(), v), "dtype"),
                        ((q, k[:, :1], v), "shape|disagree|want"),
                        ((q[:, :3], k, v), "grouping"),
                        ((q[0], k, v), "want")):
        with pytest.raises(ValueError, match=match):
            fops.flash_attention(*args)
    pq, kp, vp, tables, lengths, starts = (
        t(a) for a in paged_case(1, *PAGED_CASES[0]))
    with pytest.raises(ValueError, match="int32"):
        pops.paged_attention(pq, kp, vp, tables.long(), lengths, starts)
    with pytest.raises(ValueError, match="grouping"):
        pops.paged_attention(pq[:, :3], kp, vp, tables, lengths, starts)


# ---------------------------------------------------------------------------
# the CUDA kernels' own arithmetic and launch plans, in plain PyTorch
# ---------------------------------------------------------------------------

def split_tables(maxp, page):
    """Tables, lengths and starts whose windows the kernel's equal shares
    of whole 32-slot chunks cut in different ways: an all-pad row, a
    window of several chunks crossing part boundaries, a window shorter
    than one chunk per part (the later parts lie wholly outside it), the
    whole table (``maxp * page`` no multiple of the parts' chunks), one
    token, and a ``-1`` pad inside a window."""
    n = maxp * page
    tables = np.arange(6 * maxp, dtype=np.int32).reshape(6, maxp)
    tables[0] = -1
    tables[5, 4] = -1
    starts = np.array([0, 5, 40, 0, 33, 10], np.int32)
    lengths = np.array([n, 70, 60, n, 34, 75], np.int32)
    return tables, lengths, starts


SPLIT_CASES = [  # n_split, page, maxp, hq, hkv, dk, dv
    (3, 8, 10, 8, 2, 16, 16),      # 80 slots in three shares
    (2, 16, 7, 4, 2, 16, 24),      # 112 slots in two, dk != dv
    (32, 8, 10, 2, 2, 32, 32),     # the kernel's most: short shares
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "splits{}-page{}-g{}".format(
                             c[0], c[1], c[3] // c[4]))
def test_paged_split_and_merge_matches_plain_and_pallas(case):
    n_split, page, maxp, hq, hkv, dk, dv = case
    rng = np.random.default_rng(21)
    tables, lengths, starts = split_tables(maxp, page)
    q = rng.normal(size=(6, hq, dk)).astype(np.float32)
    kp = rng.normal(size=(6 * maxp, page, hkv, dk)).astype(np.float32)
    vp = rng.normal(size=(6 * maxp, page, hkv, dv)).astype(np.float32)
    args = [t(a) for a in (q, kp, vp, tables, lengths, starts)]
    got = pref.paged_attention_split_ref(*args, n_split=n_split)
    np.testing.assert_allclose(got.numpy(),
                               pref.paged_attention_ref(*args).numpy(),
                               rtol=1e-5, atol=1e-5)
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, tables, lengths))
    want = jpaged(*jargs, starts=jnp.asarray(starts), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (got[0] == 0).all()                  # the all-pad row


def test_paged_launch_plan_reads_shapes_only():
    """The split plan is a function of integers, and the launch plan of
    shapes and dtypes: meta tensors, which hold no values, will do."""
    assert pkernel.split_plan(256, 16) == (128, pkernel.MAX_SPLITS)
    assert pkernel.split_plan(37, 16) == (32, 19)    # one chunk a block
    assert pkernel.split_plan(0, 16) == (32, 1)

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    llama = pkernel.launch_plan(meta(8, 32, 128), meta(1024, 16, 8, 128),
                                meta(1024, 16, 8, 128),
                                meta(8, 256, dtype=torch.int32))
    assert (llama["n_split"], llama["stages"], llama["vec"]) == (32, 2, True)
    assert llama["acc_shape"] == (8, 32, 32, 128)
    assert llama["scratch_bytes"] == 4 * 8 * 32 * 32 * (2 + 128)
    for dtype, stages in ((torch.bfloat16, 2), (torch.float32, 1)):
        mla = pkernel.launch_plan(meta(4, 40, 288, dtype=dtype),
                                  meta(9, 16, 1, 288, dtype=dtype),
                                  meta(9, 16, 1, 256, dtype=dtype),
                                  meta(4, 37, dtype=torch.int32))
        assert mla["stages"] == stages and mla["n_split"] == 19
        assert mla["smem_bytes"] <= pkernel.SMEM_LIMIT
    odd = pkernel.launch_plan(meta(2, 4, 36), meta(3, 8, 4, 36),
                              meta(3, 8, 4, 20),
                              meta(2, 9, dtype=torch.int32))
    assert not odd["vec"]                       # 72-byte rows: plain loads
    with pytest.raises(ValueError, match="shared memory"):
        pkernel.launch_plan(meta(1, 64, 512, dtype=torch.float32),
                            meta(2, 16, 1, 512, dtype=torch.float32),
                            meta(2, 16, 1, 512, dtype=torch.float32),
                            meta(1, 2, dtype=torch.int32))


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 256, "tensor_core"), (torch.bfloat16, 80, "tensor_core"),
    (torch.bfloat16, 40, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 64, "simt")])
def test_flash_route_is_a_function_of_dtype_and_dh(dtype, dh, want):
    assert fkernel.route(dtype, dh) == want


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("sq,sk,causal", [(129, 129, True), (17, 129, True),
                                          (64, 200, False)])
def test_flash_bf16_rounding_of_p_stays_within_the_bf16_tolerance(
        sq, sk, causal, terms):
    """P carried to ``P V`` as one bf16 term (SDPA's rounding) or two (the
    tensor-core route's hi + lo), the row sum from the float32 P: both
    stay within the bf16 tolerance of ``mha_ref``, the reference's
    included."""
    q, k, v = qkv(13, 1, 4, 2, sq, sk, 64)
    args = [t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = fref.mha_p_bf16_ref(*args, causal=causal, terms=terms)
    assert got.dtype == torch.bfloat16
    close(got, fref.mha_ref(*args, causal=causal).float(), BF16_TOL)
    want = jmha_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    causal=causal)
    close(got, want.astype(jnp.float32), BF16_TOL)


def test_flash_two_bf16_terms_of_p_sit_far_closer_than_one():
    """On float32 outputs (no rounding of the result), P as hi + lo lies
    orders of magnitude closer to the float32 softmax than P as one bf16
    term, whose error is of the order of 2^-9 of the values."""
    q, k, v = (t(a).to(torch.bfloat16).float()
               for a in qkv(17, 1, 4, 2, 129, 129, 64))
    want = fref.mha_ref(q, k, v)
    one, two = (float((fref.mha_p_bf16_ref(q, k, v, terms=n) - want)
                      .abs().max()) for n in (1, 2))
    assert 2.0 ** -14 < one < 2.0 ** -6
    assert two < one / 64


# ---------------------------------------------------------------------------
# (b) attention modules on carried-across parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_reduced():
    """Layer 0's attention parameters of ``llama3-8b.reduced()``, made with
    numpy and carried across by ``interop.params_from_numpy``."""
    jcfg, cfg = ARCHS["llama3-8b"].reduced(), get_arch("llama3-8b").reduced()
    tree = numpy_tree(cfg, 3)
    tp = interop.params_from_numpy(cfg, tree, device="cpu")
    jp = {k: jnp.asarray(a[0]) for k, a in tree["layers"][0]["attn"].items()}
    return (jcfg, junpadded_plan(jcfg), jp, cfg, unpadded_plan(cfg),
            tp.layers[0]["attn"])


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_gqa_full_matches_the_reference(llama_reduced, impl):
    jcfg, jplan, jp, cfg, plan, tp = llama_reduced
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    pos = np.arange(32)
    want, (jk, jv) = jattn.gqa_full(jp, jcfg, jplan, jnp.asarray(x),
                                    jnp.asarray(pos), causal=True, impl=impl)
    got, (k, v) = attn.gqa_full(tp, cfg, plan, t(x), t(pos), causal=True)
    close(got, want, MODULE_TOL)
    close(k, jk, MODULE_TOL)
    close(v, jv, MODULE_TOL)
    ref, _ = attn.gqa_full(tp, cfg, plan, t(x), t(pos), impl="ref")
    assert torch.equal(ref, got)            # on the CPU "kernel" is "ref"


def test_gqa_decode_paged_matches_the_reference(llama_reduced):
    """Rows: the new token's page not allocated yet (no write), a window
    past its end (no write), starts mid-page, a plain append."""
    jcfg, jplan, jp, cfg, plan, tp = llama_reduced
    page, dh, hkv = 8, cfg.head_dim, cfg.n_kv_heads
    rng = np.random.default_rng(9)
    kp = rng.normal(size=(12, page, hkv, dh)).astype(np.float32)
    vp = rng.normal(size=(12, page, hkv, dh)).astype(np.float32)
    tables = np.array([[0, 1, -1, -1], [2, 3, -1, -1], [4, 8, 9, -1],
                       [5, 6, 7, -1]], np.int32)
    lengths = np.array([16, 4, 17, 19], np.int32)
    starts = np.array([0, 6, 9, 1], np.int32)
    x = rng.normal(size=(4, 1, cfg.d_model)).astype(np.float32)
    positions = (lengths + 100).astype(np.int32)
    jout, jkp, jvp = jattn.gqa_decode_paged(
        jp, jcfg, jplan, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(starts),
        jnp.asarray(positions), impl="pallas_interpret")
    tkp, tvp = t(kp), t(vp)
    write = attn.paged_write_rows(t(tables), t(lengths), t(starts), page)
    out, tkp2, tvp2 = attn.gqa_decode_paged(
        tp, cfg, plan, t(x), tkp, tvp, t(tables), t(lengths), t(starts),
        t(positions), write)
    assert tkp2 is tkp and tvp2 is tvp      # updated in place
    close(out, jout, MODULE_TOL)
    close(tkp, jkp, MODULE_TOL)
    close(tvp, jvp, MODULE_TOL)
    written = {(9, 1), (7, 3)}
    for pg in range(12):
        for sl in range(page):
            same = torch.equal(tkp[pg, sl], t(kp[pg, sl]))
            assert same != ((pg, sl) in written), (pg, sl)
